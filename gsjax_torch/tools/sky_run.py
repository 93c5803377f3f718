"""The sky shell end to end: the counterpart of the repository's
tools/sky_run.py.

Trains the same unbounded-style synthetic scene (ray-traced spheres over a
checkerboard under a sky gradient, gsjax_torch/tools/synthetic_scene.py at
300 px, 48 train and 8 test views: about half the pixels are far field)
twice through the port's Scene and Trainer, with the sky shell
(--sky Gaussians on a far sphere, ModelConfig.sky_gaussians) and without,
and compares held-out PSNR. The run crosses the opacity reset at 3000, so
densify's world-size prune (max_screen_size 20) fires with the
distance-scaled threshold for the unbounded scene (train/densify.py): the
shell must survive it.

    python -m gsjax_torch.tools.sky_run [--iterations 4000] [--sky 2000] \
        [--out build/sky/sky_run.json] [--scene_dir build/sky/scene]

The scene is written to --scene_dir (default <root>/scene, --root
build/sky) unless it is there; the two models go under --root.

Capacity 262,144, 32x32 tiles, budgets 1,048,576 / 524,288 (the trainer
adapts them). Writes the JSON artifact and prints one JSON line: for
each run the test PSNR curve (from the trainer's evaluation events), the
per-view final test PSNR and the shell's statistics at init and at the
end; delta_test_psnr (with the shell minus without) and
shell_survived_prune. A failed run still writes what finished, then
raises.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CAPACITY = 262_144
BUDGETS = (1_048_576, 524_288)
TEST_ITERATIONS = (500, 1000, 2000, 3000)
FAR = 5.0  # the shell: alive Gaussians farther than FAR * cameras_extent


def shell_stats(xyz: np.ndarray, opacity: np.ndarray, alive: np.ndarray,
                center, extent: float) -> dict:
    """The live Gaussians, those of the far shell (distance from the scene
    centre above FAR * extent) and the shell's mean opacity."""
    xyz, opac = xyz[alive], opacity.reshape(-1)[alive]
    r = np.linalg.norm(xyz - np.asarray(center)[None, :], axis=-1)
    far = r > FAR * extent
    return {"n_alive": int(alive.sum()), "n_far_shell": int(far.sum()),
            "far_opacity_mean": float(opac[far].mean()) if far.any() else None}


def state_shell_stats(state, center, extent: float) -> dict:
    return shell_stats(state.params.xyz.detach().cpu().numpy(),
                       state.params.get_opacity().detach().cpu().numpy(),
                       state.aux.alive.cpu().numpy(), center, extent)


def summarize(results: dict) -> dict:
    """delta_test_psnr (sky_on minus sky_off) and shell_survived_prune, from
    whichever runs finished."""
    out = {}
    if "sky_on" in results and "sky_off" in results:
        out["delta_test_psnr"] = (results["sky_on"]["final_test_psnr"]
                                  - results["sky_off"]["final_test_psnr"])
    if "sky_on" in results:
        out["shell_survived_prune"] = results["sky_on"]["shell_at_end"]["n_far_shell"] > 0
    return out


def run_one(scene_dir: str, model_dir: str, iterations: int, sky_n: int,
            budgets=BUDGETS, device=None) -> dict:
    """One training run of the scene with sky_n shell Gaussians."""
    from gsjax_torch.config import ModelConfig, OptimizationConfig, RasterConfig
    from gsjax_torch.scene import Scene
    from gsjax_torch.tools.quality_run import eval_entries, final_views
    from gsjax_torch.train.trainer import Trainer

    model_cfg = ModelConfig(source_path=scene_dir, model_path=model_dir, eval=True,
                            sky_gaussians=sky_n)
    os.makedirs(model_dir, exist_ok=True)
    scene = Scene(model_cfg, capacity=CAPACITY, device=device)
    raster_cfg = RasterConfig(tile_w=32, tile_h=32, max_instances=budgets[0],
                              max_rows=budgets[1])
    trainer = Trainer(scene, model_cfg, OptimizationConfig(iterations=iterations),
                      raster_cfg=raster_cfg, quiet=True)
    ext = float(scene.cameras_extent)
    start_shell = state_shell_stats(trainer.state, scene.scene_center, ext)
    t0 = time.perf_counter()
    trainer.train(test_iterations=(*TEST_ITERATIONS, iterations),
                  save_iterations=(iterations,), checkpoint_iterations=())
    wall = time.perf_counter() - t0
    per_view = [v["psnr"] for v in final_views(trainer)[0]]
    return {
        "sky_gaussians": sky_n, "iterations": int(trainer.state.step),
        "cameras_extent": ext, "wall_clock_s": wall,
        "test_curve": eval_entries(trainer.events, "test"),
        "final_test_psnr": float(np.mean(per_view)), "per_view_psnr": per_view,
        "shell_at_init": start_shell,
        "shell_at_end": state_shell_stats(trainer.state, scene.scene_center, ext),
        "final_points": trainer.n_alive(), "capacity": trainer.state.params.capacity,
    }


def make_parser() -> argparse.ArgumentParser:
    """The JAX tool's flags (tools/sky_run.py:128-133) and the port's --root."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iterations", type=int, default=4000)
    ap.add_argument("--sky", type=int, default=2000)
    ap.add_argument("--root", default=os.path.join(ROOT, "build", "sky"),
                    help="both models (sky_on/, sky_off/), and the scene (scene/) by "
                         "default")
    ap.add_argument("--scene_dir", default=None, help="default <root>/scene")
    ap.add_argument("--out", default=None, help="default <root>/sky_run.json")
    ap.add_argument("--max_instances", type=int, default=BUDGETS[0])
    ap.add_argument("--max_rows", type=int, default=BUDGETS[1])
    return ap


def main(argv=None) -> dict:
    from gsjax_torch.tools.common import require_card
    from gsjax_torch.tools.synthetic_scene import generate

    args = make_parser().parse_args(argv)
    require_card("sky_run")
    scene_dir = args.scene_dir or os.path.join(args.root, "scene")
    out_path = args.out or os.path.join(args.root, "sky_run.json")
    t0 = time.perf_counter()
    if not os.path.exists(os.path.join(scene_dir, "transforms_train.json")):
        generate(scene_dir, res=300, n_train=48, n_test=8)
    results = {"device": torch.cuda.get_device_name(0), "scene_seconds":
               time.perf_counter() - t0, "iterations": args.iterations}
    try:
        # With the shell first, as there.
        for tag, sky_n in (("sky_on", args.sky), ("sky_off", 0)):
            results[tag] = run_one(scene_dir, os.path.join(args.root, tag),
                                   args.iterations, sky_n,
                                   (args.max_instances, args.max_rows))
    except (Exception, KeyboardInterrupt) as e:
        results["crashed"] = f"{type(e).__name__}: {e}"[:300]
        raise
    finally:
        results.update(summarize(results))
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(results, f, indent=1)
    print(json.dumps({"tool": "sky_run", "out": out_path, **{
        k: results[k] for k in ("device", "iterations", "delta_test_psnr",
                                "shell_survived_prune")}}), flush=True)
    return results


if __name__ == "__main__":
    main()
