"""Forward-only (viewer-path) render throughput on the card: the
counterpart of the repository's tools/bench_fps.py.

render() under no_grad, as the viewer's frames and evaluation run it, on
the bench scene (tools/common.bench_scene: 500k Gaussians, SH degree 3)
from the origin view, exact and fast_fwd, in the JAX tool's three
configurations: 1920x1080 at 32x32 and 64x32 tiles, and 960x540 at 32x32.
ITERS renders back to back after one warm-up, timed by CUDA events: as
replays of the captured render (render/graph.py), as the port serves a
frame and the JAX tool times a jitted one, and dispatched from the host.

    python -m gsjax_torch.tools.bench_fps [--iters 40]

Prints one JSON line per configuration: ms and fps per render replayed
(`ms`, `fps`) and dispatched (`ms_dispatched`, `fps_dispatched`), and the
view's pair count.
"""

from __future__ import annotations

import argparse
import json

import torch

from gsjax_torch.config import RasterConfig
from gsjax_torch.render import kernels
from gsjax_torch.synthetic import look_at_origin_camera
from gsjax_torch.tools.common import bench_scene, cuda_ms, forward_frame, require_card

ITERS = 40
# (width, height, tile_w, tile_h, max_instances, max_rows): the JAX tool's,
# budgets sized from the 32x32 pair count at 1080p.
CONFIGS = (
    (1920, 1080, 32, 32, 1_179_648, 524_288),
    (1920, 1080, 64, 32, 1_179_648, 524_288),
    (960, 540, 32, 32, 524_288, 262_144),
)


def run(params, aux, iters: int = ITERS) -> list[dict]:
    """One row per (configuration, fast_fwd)."""
    rows = []
    for width, height, tw, th, maxi, maxr in CONFIGS:
        camera = look_at_origin_camera(width, height, device=params.device)
        for fast in (False, True):
            cfg = RasterConfig(tile_w=tw, tile_h=th, max_instances=maxi, max_rows=maxr,
                               fast_fwd=fast)
            frame = forward_frame(params, aux, camera, cfg)
            pairs = int(frame().num_instances)
            dispatched = cuda_ms(frame, reps=iters, warmup=1)
            ms = cuda_ms(forward_frame(params, aux, camera, cfg, replayed=True),
                         reps=iters, warmup=1)
            rows.append({"tool": "bench_fps", "width": width, "height": height,
                         "tile": f"{tw}x{th}", "fast_fwd": fast, "ms": ms,
                         "fps": 1e3 / ms, "ms_dispatched": dispatched,
                         "fps_dispatched": 1e3 / dispatched, "pairs": pairs,
                         "overflow": pairs > maxi})
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=ITERS)
    args = ap.parse_args(argv)
    require_card("bench_fps")
    kernels.build()
    params, aux, _, _ = bench_scene()
    device = torch.cuda.get_device_name(0)
    for row in run(params, aux, iters=args.iters):
        print(json.dumps({**row, "device": device}), flush=True)


if __name__ == "__main__":
    main()
