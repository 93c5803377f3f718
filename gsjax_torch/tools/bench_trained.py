"""Rasterizer throughput on a trained model's PLY on the card: the
counterpart of the repository's tools/bench_trained.py.

A random blob cloud (the bench scene) terminates early, skips and sorts
unlike a trained state (opaque foregrounds, dense clusters). This tool
loads the newest point_cloud/iteration_*/point_cloud.ply of a model
directory (scene.load_ply_model), views it from the quality scene's
orbit camera (tools/common.trained_orbit_camera) with budgets sized to
the view's counts (+3 %, profile_stages.ply_scene; --max_instances sets
the instance budget instead), and times by CUDA events, ITERS runs after
one warm-up, each as replays of a captured CUDA graph (as the JAX tool
times jitted functions) and dispatched from the host:

  fwd_bwd       render, L1 against a zero image, the gradients of every
                raw parameter and mean2d_offset, p - 0 * g (gsjax_torch.bench;
                replayed: its ScanStep, a window of ITERS)
  fwd_only      render and L1 under no_grad (replayed: a ScanStep of it)
  viewer_exact  render under no_grad: a viewer frame's work (replayed: the
                captured render, render/graph.py)
  viewer_fast   the same with RasterConfig.fast_fwd (the viewer's setting)

    python -m gsjax_torch.tools.bench_trained [--model <model dir>]
        [--width 1920 --height 1080] [--tile 32x32] [--strips 1] [--orbit 0.6]
        [--iters 15] [--max_instances 0]

`--strips` is accepted and ignored, as RasterConfig.strips is by the
port's compositors. Prints one JSON line: ms, pixels/s and (for the
forward-only rows) fps of each, replayed (`<row>_ms`) and dispatched
(`<row>_ms_dispatched`).
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import re

import torch

from gsjax_torch.bench import BenchStep, ScanStep
from gsjax_torch.render import kernels
from gsjax_torch.tools.common import cuda_ms, forward_frame, require_card
from gsjax_torch.train.loss import l1_loss

ITERS = 15
DEFAULT_MODEL = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "quality", "model")


def newest_ply(model: str) -> str:
    """<model>/point_cloud/iteration_<newest>/point_cloud.ply."""
    dirs = sorted(glob.glob(os.path.join(model, "point_cloud", "iteration_*")),
                  key=lambda p: int(re.search(r"iteration_(\d+)", p).group(1)))
    if not dirs:
        raise FileNotFoundError(f"no checkpoint under {model}")
    return os.path.join(dirs[-1], "point_cloud.ply")


def run(params, aux, camera, cfg, sh_degree: int, iters: int = ITERS) -> dict:
    """The four timings on one scene and view, replayed and dispatched, as
    one dict."""
    gt = torch.zeros((3, camera.height, camera.width), device=params.device)
    pixels = camera.width * camera.height
    fast_cfg = dataclasses.replace(cfg, fast_fwd=True)
    exact = forward_frame(params, aux, camera, cfg, sh_degree)

    def fwd_only():
        with torch.no_grad():
            return l1_loss(exact().image, gt)

    def window(step):
        """ms per step of `iters` replays of step's captured graph."""
        return cuda_ms(ScanStep(step, iters, params.device), reps=1, warmup=1) / iters

    out = {"tool": "bench_trained", "n_gaussians": int(aux.n_alive()),
           "width": camera.width, "height": camera.height,
           "tile": f"{cfg.tw}x{cfg.th}", "max_instances": cfg.max_instances,
           "max_rows": cfg.max_rows}
    probe = exact()
    out["pairs"], out["rows"] = int(probe.num_instances), int(probe.num_rows)
    fwd_bwd = BenchStep(params, aux, camera, cfg, sh_degree)
    rows = (("fwd_bwd", fwd_bwd, lambda: window(fwd_bwd)),
            ("fwd_only", fwd_only, lambda: window(fwd_only)),
            ("viewer_exact", exact, lambda: cuda_ms(forward_frame(
                params, aux, camera, cfg, sh_degree, replayed=True), reps=iters)),
            ("viewer_fast", forward_frame(params, aux, camera, fast_cfg, sh_degree),
             lambda: cuda_ms(forward_frame(params, aux, camera, fast_cfg, sh_degree,
                                           replayed=True), reps=iters)))
    for name, dispatched, replayed in rows:
        for key, ms in ((f"{name}_ms_dispatched", cuda_ms(dispatched, reps=iters, warmup=1)),
                        (f"{name}_ms", replayed())):
            out[key] = ms
            out[key.replace("_ms", "_px_per_s")] = pixels / (ms / 1e3)
            if name != "fwd_bwd":
                out[key.replace("_ms", "_fps")] = 1e3 / ms
    return out


def make_parser() -> argparse.ArgumentParser:
    """The JAX tool's flags (tools/bench_trained.py:59-67)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default=DEFAULT_MODEL,
                    help="a trained model's directory (default: tools.quality_run's)")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--tile", default="32x32")
    ap.add_argument("--strips", type=int, default=1,
                    help="accepted and ignored, as RasterConfig.strips is")
    ap.add_argument("--orbit", type=float, default=0.6)
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--max_instances", type=int, default=0,
                    help="0 = sized to the view's exact pair count (+3 %%)")
    return ap


def main(argv=None) -> None:
    from gsjax_torch.profile_stages import ply_scene

    args = make_parser().parse_args(argv)
    tw, th = (int(v) for v in args.tile.split("x"))
    require_card("bench_trained")
    kernels.build()
    ply = newest_ply(args.model)
    params, aux, camera, cfg, sh_degree = ply_scene(
        ply, args.orbit, args.width, args.height, tile_w=tw, tile_h=th)
    cfg = dataclasses.replace(cfg, strips=args.strips,
                              max_instances=args.max_instances or cfg.max_instances)
    out = run(params, aux, camera, cfg, sh_degree, iters=args.iters)
    print(json.dumps({**out, "ply": ply, "sh_degree": sh_degree,
                      "device": torch.cuda.get_device_name(0)}), flush=True)


if __name__ == "__main__":
    main()
