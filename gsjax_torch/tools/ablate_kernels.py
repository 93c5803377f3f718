"""The composite kernels taken apart on the card: each ablated variant of
the walk (tools/kernels.py) on the bench view's instance stream, beside
the full composite_forward and composite_backward and their twins without
the cull on the same arguments, so that one run prints the whole
decomposition. The counterpart of the
JAX package's tools/ablate_kernels.py.

    python -m gsjax_torch.tools.ablate_kernels [variant ...]

Variants (default: dma_only replay_fwd bwd_nowrite):
  dma_only      the range's chunks staged, no walk
  fwd_nodep     the walk restarted at T = 1 on every 128-instance chunk
  fwd_nocond    the walk with no stop (no per-pixel break, no block exit)
  replay_fwd    the forward's walk, one float out
  bwd_nowrite   the backward without its gradient write (so is any other
                name, as in the JAX tool)
  bwd_noshfl    the main backward (warp map, cull, write) without its warp
                butterflies: how much of it the shuffles take
  blockout, blockout_parallel
                the forward with pixel-major outputs (the TPU grid's
                dimension semantics have no counterpart on the card)
The backward runs, here and in the backward variants, on the JAX tool's
cotangent (d_color 1e-6, suffix 1e-3). All variants but bwd_noshfl walk as
the kernels did before the cull (row-major warps, every row). One JSON
line each: device ms (profiler) and event ms (CUDA events, host launch
work included), mean of REPS.
"""

from __future__ import annotations

import json
import sys

import torch

from gsjax_torch.render import kernels
from gsjax_torch.tools import kernels as tool_kernels
from gsjax_torch.tools.common import (
    bench_scene,
    cuda_ms,
    device_ms,
    instance_stream,
    require_card,
)

DEFAULT_VARIANTS = ("dma_only", "replay_fwd", "bwd_nowrite")
REPS = 30


def ablate(stream, variants=DEFAULT_VARIANTS, reps: int = REPS) -> list[dict]:
    """Times each variant and then the two full kernels and their twins
    without the cull on `stream` (common.InstanceStream); one dict per
    line."""
    inst, ts, geo = stream.inst, stream.tile_start, stream.geometry
    pix = geo["tile_w"] * geo["tile_h"]
    rows = []

    def timed(name, fn, kernel_name):
        with torch.no_grad():
            rows.append({"tool": "ablate_kernels", "variant": name,
                         "ms": device_ms(fn, kernel_name, reps),
                         "event_ms": cuda_ms(fn, reps, warmup=2)})

    for v in variants:
        if v.startswith("blockout"):
            sem = "parallel" if v.endswith("parallel") else "arbitrary"
            timed(v, lambda: tool_kernels.blockout(inst, ts, sem, **geo),
                  "blockout_kernel")
        else:
            timed(v, lambda: tool_kernels.variant(inst, ts, v, **geo), "variant_")
    cot = tool_kernels.bwd_nowrite_cot(geo["n_tiles"], pix, inst.device)
    timed("composite_forward", lambda: kernels.composite_forward(inst, ts, **geo),
          "composite_forward_kernel")
    timed("composite_backward",
          lambda: kernels.composite_backward(inst, ts, cot, **geo),
          "composite_backward_kernel")
    timed("composite_forward_nocull",
          lambda: tool_kernels.composite_forward_nocull(inst, ts, **geo),
          "nocull_forward_kernel")
    timed("composite_backward_nocull",
          lambda: tool_kernels.composite_backward_nocull(inst, ts, cot, **geo),
          "nocull_backward_kernel")
    return rows


def main(argv: list[str] | None = None) -> None:
    require_card("ablate_kernels")
    variants = (sys.argv[1:] if argv is None else argv) or list(DEFAULT_VARIANTS)
    params, aux, camera, cfg = bench_scene()
    stream = instance_stream(params, camera, cfg, aux.alive)
    print(json.dumps({"device": torch.cuda.get_device_name(0)}), flush=True)
    for row in ablate(stream, variants):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
