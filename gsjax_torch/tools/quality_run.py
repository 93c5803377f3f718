"""A quality run on the synthetic scene, through the training CLI.

Writes the ray-traced scene of `gsjax_torch.tools.synthetic_scene` (400 px,
96 train + 8 test views) under --root (default build/quality/scene/),
unless it is there, and trains it with `python -m gsjax_torch.cli.train`'s
defaults plus --eval, evaluating the test views at each of
--test_iterations; then renders the test views (`cli.render
--skip_train`) and scores them (`cli.metrics`).

Writes the artifact of the repository's tools/quality_run.py to --out
(default build/quality/quality_run.json), with its keys: the test PSNR
curve and the train evaluations (the trainer's evaluation events), the
final per-view PSNR and SSIM of every test view, the final state's
floater diagnostics, the points alive at each evaluation, capacity,
budget and capacity events, wall clock, and the card as `backend`;
gsjax_torch.tools.diagnose_quality reads it. The four worst test views
are saved beside it (render | ground truth) under quality_renders/.
Prints one JSON line: the card, the evaluations, densify and budget
events, the wall time of training, the points alive at the end,
results.json and the artifact's path. A failed run still writes the
artifact (`crashed` says why), then raises.

    python -m gsjax_torch.tools.quality_run [--iterations 2000] \
        [--test_iterations 1000 2000] [--out build/quality/quality_run.json]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
WORST_VIEWS = 4
DATASET = "ray-traced spheres+checkerboard (gsjax_torch/tools/synthetic_scene.py)"


def eval_entries(events, split: str) -> list[dict]:
    """The trainer's evaluation events of one split as the artifact's
    curve entries."""
    return [{"iteration": e["iteration"], "split": e["eval"], "l1": e["l1"],
             "psnr": e["psnr"]} for e in events if e.get("eval") == split]


def state_diagnostics(xyz: np.ndarray, opacity: np.ndarray, alive: np.ndarray,
                      extent: float) -> dict:
    """Floater and overdraw indicators of a state, as the repository's
    tools/quality_run.py computes them: distances from the live
    Gaussians' mean position, opacity statistics, the shares outside the
    cameras' extent."""
    xyz, opac = xyz[alive], opacity.reshape(-1)[alive]
    r = np.linalg.norm(xyz - xyz.mean(axis=0), axis=-1)
    return {
        "cameras_extent": round(extent, 3),
        "n_alive": int(alive.sum()),
        "opacity_mean": round(float(opac.mean()), 4),
        "opacity_frac_below_0.1": round(float((opac < 0.1).mean()), 4),
        "radius_p50": round(float(np.percentile(r, 50)), 3),
        "radius_p99": round(float(np.percentile(r, 99)), 3),
        "frac_outside_extent": round(float((r > extent).mean()), 4),
        "frac_outside_extent_opaque": round(float(((r > extent) & (opac > 0.5)).mean()), 5),
    }


@torch.no_grad()
def final_views(trainer) -> tuple[list[dict], dict]:
    """Per test view ("<bank>_<index>") PSNR and SSIM of the final state,
    and each view's (render, ground truth) [3, H, W] arrays."""
    from gsjax_torch.image_metrics import psnr
    from gsjax_torch.train.loss import ssim

    views, renders = [], {}
    for b, bank in enumerate(trainer.scene.get_test_banks()):
        for i in range(bank.count):
            cam, gt = bank.pick(i)
            img = torch.clamp(trainer.render_view(cam), 0.0, 1.0)
            views.append({"view": f"{b}_{i}", "psnr": round(float(psnr(img, gt).mean()), 3),
                          "ssim": round(float(ssim(img, gt)), 4)})
            renders[f"{b}_{i}"] = (img.cpu().numpy(), torch.clamp(gt, 0, 1).cpu().numpy())
    return views, renders


def save_worst(views: list[dict], renders: dict, render_dir: str) -> None:
    """The WORST_VIEWS lowest-PSNR test views as render | ground truth PNGs."""
    from PIL import Image

    os.makedirs(render_dir, exist_ok=True)
    for v in sorted(views, key=lambda v: v["psnr"])[:WORST_VIEWS]:
        img, gt = renders[v["view"]]
        pair = np.concatenate([img, gt], axis=2).transpose(1, 2, 0)
        Image.fromarray(np.round(pair * 255).astype(np.uint8)).save(
            os.path.join(render_dir, f"worst_{v['view']}_psnr{v['psnr']:.1f}.png"))


def artifact(trainer, iterations: int, wall: float | None, crashed: str | None,
             backend: str, render_dir: str) -> dict:
    """The repository's quality artifact for a finished (or failed) run;
    `trainer` is None when training never started."""
    events = trainer.events if trainer is not None else []
    banks = trainer.scene.get_test_banks() if trainer is not None else []
    test = eval_entries(events, "test")
    views, diag = [], None
    if trainer is not None and crashed is None:
        views, renders = final_views(trainer)
        save_worst(views, renders, render_dir)
        st = trainer.state
        diag = state_diagnostics(st.params.xyz.detach().cpu().numpy(),
                                 st.params.get_opacity().detach().cpu().numpy(),
                                 st.aux.alive.cpu().numpy(),
                                 float(trainer.scene.cameras_extent))
    return {
        "crashed": crashed,
        "resumed_from": None,
        "dataset": DATASET,
        "resolution": banks[0].width if banks else None,
        "iterations": iterations,
        "backend": backend,
        "wall_clock_s": wall,
        "final_points": trainer.n_alive() if trainer is not None else None,
        "capacity": trainer.state.params.capacity if trainer is not None else None,
        "final_raster_budgets": None if trainer is None else {
            "max_instances": trainer.raster_cfg.max_instances,
            "max_rows": trainer.raster_cfg.max_rows},
        "budget_events": [e for e in events if "budgets" in e],
        "capacity_events": [e for e in events if "grow" in e],
        "points_curve": [{"iteration": e["iteration"], "points": e["points"]}
                         for e in events if e.get("eval") == "test"],
        "final_state_diagnostics": diag,
        "test_psnr_curve": test,
        "train_evals": eval_entries(events, "train"),
        "final_test_psnr": test[-1]["psnr"] if test else None,
        "final_per_view": views,
        "final_test_ssim": round(float(np.mean([v["ssim"] for v in views])), 4)
        if views else None,
        "renders_dir": render_dir,
    }


def main(argv=None) -> int:
    from gsjax_torch.cli import metrics as metrics_cli
    from gsjax_torch.cli import render as render_cli
    from gsjax_torch.cli import train as train_cli
    from gsjax_torch.tools.common import require_card
    from gsjax_torch.tools.synthetic_scene import generate

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--iterations", type=int, default=2000)
    parser.add_argument("--test_iterations", type=int, nargs="+", default=[1000, 2000])
    parser.add_argument("--root", default=os.path.join(ROOT, "build", "quality"),
                        help="the scene (scene/) and the model (model/)")
    parser.add_argument("--out", default=None, help="default <root>/quality_run.json")
    args = parser.parse_args(argv)
    require_card("quality_run")
    out_path = args.out or os.path.join(args.root, "quality_run.json")
    render_dir = os.path.join(os.path.dirname(os.path.abspath(out_path)), "quality_renders")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    scene = os.path.join(args.root, "scene")
    t0 = time.perf_counter()
    if not os.path.exists(os.path.join(scene, "points3d.ply")):
        generate(scene)
    scene_s = time.perf_counter() - t0
    model = os.path.join(args.root, "model")
    stdout = sys.stdout
    trainer = train_s = crashed = None
    t0 = time.perf_counter()
    try:
        trainer = train_cli.main([
            "-s", scene, "-m", model, "--eval", "--quiet",
            "--iterations", str(args.iterations),
            "--test_iterations", *map(str, args.test_iterations),
            "--save_iterations", str(args.iterations),
        ])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        render_cli.main(["-m", model, "--iteration", str(args.iterations),
                         "--skip_train", "--quiet"])
        metrics_cli.main(["-m", model])
    except (Exception, KeyboardInterrupt) as e:
        crashed = f"{type(e).__name__}: {e}"[:300]
        raise
    finally:
        sys.stdout = stdout
        result = artifact(trainer, args.iterations, train_s, crashed,
                          torch.cuda.get_device_name(0), render_dir)
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(result, f, indent=1)
    with open(os.path.join(model, "results.json")) as f:
        results = json.load(f)[f"ours_{args.iterations}"]
    line = {
        "tool": "quality_run", "card": smi, "device": torch.cuda.get_device_name(0),
        "iterations": args.iterations, "scene_seconds": scene_s,
        "train_wall_s": train_s,
        "evals": [e for e in trainer.events if "eval" in e],
        "densify": [e for e in trainer.events if "densify" in e],
        "budget_events": [e for e in trainer.events if "budgets" in e],
        "points": trainer.n_alive(), "capacity": trainer.state.params.capacity,
        "step_ms_total": sum(e["ms"] for e in trainer.events if "window" in e),
        "results": results, "artifact": out_path,
    }
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
