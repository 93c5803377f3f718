"""The forward's output path on the card: the exact forward written in the
TPU kernel's transposed (T, 8, PIX) layout ("ship") against the same
writes without the layout work ("notrans"), on the bench view's instance
stream. The counterpart of the JAX package's tools/probe_outpath.py.

    python -m gsjax_torch.tools.probe_outpath

One JSON line per variant: device ms (profiler) and event ms (CUDA
events), mean of REPS.
"""

from __future__ import annotations

import json

import torch

from gsjax_torch.tools import kernels as tool_kernels
from gsjax_torch.tools.common import (
    bench_scene,
    cuda_ms,
    device_ms,
    instance_stream,
    require_card,
    with_refused,
)

REPS = 20


def outpaths(stream, reps: int = REPS) -> list[dict]:
    inst, ts, geo = stream.inst, stream.tile_start, stream.geometry
    rows = []
    with torch.no_grad():
        for v in tool_kernels.OUTPATH_VARIANTS:
            fn = lambda v=v: tool_kernels.outpath(inst, ts, v, **geo)  # noqa: E731
            rows.append(with_refused({"tool": "probe_outpath", "variant": v,
                                      "ms": device_ms(fn, "outpath_kernel", reps),
                                      "event_ms": cuda_ms(fn, reps, warmup=2)}))
    return rows


def main() -> None:
    require_card("probe_outpath")
    params, aux, camera, cfg = bench_scene()
    stream = instance_stream(params, camera, cfg, aux.alive)
    print(json.dumps({"device": torch.cuda.get_device_name(0)}), flush=True)
    for row in outpaths(stream):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
