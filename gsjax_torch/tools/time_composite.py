"""Device time of composite_forward and composite_backward at the bench
view on the card, through the render API alone, so that it runs against
an earlier tree of the package as well (copy this file into that tree's
gsjax_torch/tools/ and run it there): two trees compared in one call, in
turns, on one card.

    python -m gsjax_torch.tools.time_composite [--tile WxH]

The bench scene (500k Gaussians, SH degree 3, 1920x1080, bench.py's
budgets, scaled up by the tiles' area below 32x32 so that the stream never
overflows) is rendered once with gradients; each kernel's arguments are
recorded from that render and its backward (d mean(image) / d params),
then each kernel is timed alone: torch.profiler device time of its own
launches, mean of REPS. Prints one JSON line, with the stream's instance
count; exits non-zero if the stream overflowed its budget.
"""

from __future__ import annotations

import argparse
import json

import torch

from gsjax_torch.config import RasterConfig
from gsjax_torch.render import kernels
from gsjax_torch.render.api import render
from gsjax_torch.synthetic import look_at_origin_camera, random_scene
from gsjax_torch.tools.common import device_ms, with_refused

REPS = 30
BUDGETS = dict(max_instances=1_179_648, max_rows=524_288)


def kernel_times(params, aux, camera, cfg, reps: int = REPS) -> dict:
    """Each composite kernel's device ms on the arguments a render of
    `camera` and its backward give it, and the view's instance and row
    counts (above the budgets, the stream overflowed)."""
    calls = {}
    real = {k: getattr(kernels, k) for k in ("composite_forward", "composite_backward")}

    def recorder(name):
        def call(*args, **kwargs):
            calls[name] = (args, kwargs)
            return real[name](*args, **kwargs)
        return call

    for name in real:
        setattr(kernels, name, recorder(name))
    try:
        out = render(params, camera, active_sh_degree=3,
                     bg_color=torch.zeros(3, device=params.device), cfg=cfg,
                     alive=aux.alive)
        out.image.mean().backward()
    finally:
        for name, fn in real.items():
            setattr(kernels, name, fn)
        params.zero_grad(set_to_none=True)
    line = {"num_instances": int(out.num_instances), "num_rows": int(out.num_rows)}
    with torch.no_grad():
        for name, fn in real.items():
            args, kw = calls[name]
            line[f"{name}_ms"] = device_ms(lambda: fn(*args, **kw), f"{name}_kernel", reps)
    return with_refused(line)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tile", default="32x32")
    tw, th = map(int, ap.parse_args().tile.split("x"))
    if not torch.cuda.is_available():
        raise SystemExit("time_composite: no CUDA device; it measures the card")
    kernels.build()
    params, aux = random_scene(500_000, capacity=500_000, sh_degree=3, seed=0,
                               spread=2.5, scale_range=(0.004, 0.03))
    camera = look_at_origin_camera(1920, 1080)
    scale = max(1, -(-32 * 32 // (tw * th)))
    cfg = RasterConfig(tile_w=tw, tile_h=th,
                       **{k: v * scale for k, v in BUDGETS.items()})
    line = {"tool": "time_composite", "tile": f"{tw}x{th}",
            "device": torch.cuda.get_device_name(0),
            "package": str(kernels.CSRC.parent)}
    line.update(kernel_times(params, aux, camera, cfg))
    if line["num_instances"] > cfg.max_instances or line["num_rows"] > cfg.max_rows:
        raise SystemExit(f"time_composite: the stream overflowed ({line})")
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
