"""Raster-configuration sweep on the bench scene on the card: tile shape x
chunk x strips, the training step and the forward render: the
counterpart of the repository's tools/bench_sweep.py.

Each configuration is `<tile_w>x<tile_h>c<chunk>s<strips>[f]` (f:
fast_fwd, forward only), with budgets per tile width (BUDGETS).
Per configuration: the training step (render, L1 + SSIM, backward, Adam)
on the origin view of the bench scene (tools/common.bench_scene) from a
copy of its state, against a zero image, timed by CUDA events over ITERS
steps after WARMUP; with --fwd_only (or an f configuration) the forward
render under no_grad as well. Each is timed as replays of its captured
CUDA graph (a window of ITERS replayed steps, train_steps on the card;
replays of the captured render), as the JAX tool times jitted functions,
and dispatched from the host (train_step(), render()) under its own key.
A configuration the port refuses (tiles
over 64x64, a tile width without budgets, strips that do not divide the
tile) is an argument error. `strips` is accepted and
ignored, as everywhere in the port: each line says so.

    python -m gsjax_torch.tools.bench_sweep [--iters 12] [--out sweep.json]
        [--configs 32x32c128s1,64x32c128s1,...] [--fwd_only]

Prints one JSON line per configuration.
"""

from __future__ import annotations

import argparse
import json
import re

import torch

from gsjax_torch.config import RasterConfig
from gsjax_torch.render import kernels
from gsjax_torch.tools.common import (
    bench_scene,
    cuda_ms,
    forward_frame,
    replayed_train_steps,
    require_card,
)
from gsjax_torch.tools.trace_step import bench_step

ITERS = 12
WARMUP = 3
DEFAULT_CONFIGS = (
    "32x32c128s1",
    "64x32c128s1",
    "32x32c256s1",
    "64x32c256s1",
    "32x32c128s2",
    "64x64c128s1",
)
# (instance, row) budgets by tile width, snug for the bench scene: the JAX
# tool's for 32 and 64; for 16, 3 * 2^20 instances (profile_kernels') and
# 2^20 rows, since the bench view has 2.92M pairs and 785k rows at 16x16,
# over the JAX tool's 2^21 and 2^19. Other tile widths are refused.
BUDGETS = {16: (3 << 20, 1 << 20), 32: (1_179_648, 1 << 19), 64: (1 << 20, 1 << 19)}


def parse_cfg(s: str) -> RasterConfig:
    """One configuration; raises ValueError for a malformed one or one the
    port refuses."""
    m = re.fullmatch(r"(\d+)x(\d+)c(\d+)s(\d+)(f?)", s)
    if not m:
        raise ValueError(f"bad config {s!r} (want e.g. 32x32c128s1)")
    tw, th, chunk, strips = map(int, m.groups()[:4])
    kernels.tile_pixels(s, tw, th)
    if tw not in BUDGETS:
        raise ValueError(f"config {s!r}: no budgets for tile width {tw} "
                         f"(have {sorted(BUDGETS)})")
    inst, rows = BUDGETS[tw]
    inst = -(-inst // chunk) * chunk
    rows = -(-rows // chunk) * chunk
    return RasterConfig(tile_w=tw, tile_h=th, chunk=chunk, strips=strips,
                        max_instances=inst, max_rows=rows, fast_fwd=bool(m.group(5)))


def parse_configs(s: str) -> list[tuple[str, RasterConfig]]:
    """--configs' value: a comma list of configurations (argparse type)."""
    try:
        return [(name, parse_cfg(name)) for name in s.split(",")]
    except ValueError as e:
        raise argparse.ArgumentTypeError(str(e)) from e


def sweep_one(name, cfg, params, aux, camera, iters: int = ITERS,
              fwd_only: bool = False) -> dict:
    entry = {"tool": "bench_sweep", "config": name, "max_instances": cfg.max_instances,
             "max_rows": cfg.max_rows, "strips": cfg.strips, "strips_ignored": True}
    frame = forward_frame(params, aux, camera, cfg)
    px = camera.width * camera.height
    if not cfg.fast_fwd:
        dispatched = cuda_ms(bench_step(params, aux, camera, cfg), reps=iters,
                             warmup=WARMUP)
        ms = cuda_ms(replayed_train_steps(params, aux, camera, cfg, iters), reps=1,
                     warmup=1) / iters
        out = frame()
        entry.update(pairs=int(out.num_instances), rows=int(out.num_rows),
                     overflow=int(out.num_instances) > cfg.max_instances
                     or int(out.num_rows) > cfg.max_rows,
                     fwd_bwd_ms=ms, px_per_s=px / (ms / 1e3),
                     fwd_bwd_ms_dispatched=dispatched,
                     px_per_s_dispatched=px / (dispatched / 1e3))
    if fwd_only or cfg.fast_fwd:
        dispatched = cuda_ms(frame, reps=iters, warmup=WARMUP)
        ms = cuda_ms(forward_frame(params, aux, camera, cfg, replayed=True), reps=iters,
                     warmup=1)
        entry.update(fwd_ms=ms, fps=1e3 / ms, fwd_ms_dispatched=dispatched,
                     fps_dispatched=1e3 / dispatched)
    return entry


def run(params, aux, camera, configs, iters: int = ITERS, fwd_only: bool = False) -> list[dict]:
    """One entry per (name, RasterConfig) of `configs`."""
    return [sweep_one(name, cfg, params, aux, camera, iters, fwd_only)
            for name, cfg in configs]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--configs", type=parse_configs,
                    default=parse_configs(",".join(DEFAULT_CONFIGS)))
    ap.add_argument("--out", default=None)
    ap.add_argument("--fwd_only", action="store_true",
                    help="also time forward-only renders per config")
    args = ap.parse_args(argv)
    require_card("bench_sweep")
    kernels.build()
    params, aux, camera, _ = bench_scene()
    device = torch.cuda.get_device_name(0)
    results = []
    for entry in run(params, aux, camera, args.configs, args.iters, args.fwd_only):
        print(json.dumps({**entry, "device": device}), flush=True)
        results.append(entry)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": device, "n": int(aux.n_alive()), "results": results}, f,
                      indent=1)


if __name__ == "__main__":
    main()
