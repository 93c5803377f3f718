"""Device-time evidence for the binning stage on the card: the counterpart
of the repository's tools/trace_binning.py (there a jax.profiler trace).

CALLS bin_gaussians calls on inputs computed once from the bench scene
(tools/common.bench_scene: 500k Gaussians, the origin view at 1920x1080,
32x32 tiles, bench.py's budgets), traced by torch.profiler: the
per-operation device sums (per call) and the device makespan of each
call, from its first operation's start to its last one's end (the calls
are separated by a host sync and a pause). Where a call's busy time is
below its makespan, the device idled inside the call, waiting on the
host.

    python -m gsjax_torch.tools.trace_binning

Prints JSON lines: per call the makespan and the busy ms; then the
operations by name.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from gsjax_torch.render import kernels
from gsjax_torch.render.binning import bin_gaussians
from gsjax_torch.render.preprocess import preprocess
from gsjax_torch.tools import trace
from gsjax_torch.tools.common import (
    SH_DEGREE,
    bench_scene,
    require_card,
    whole_profile,
    with_refused,
)

CALLS = 8
TOP = 15
PAUSE_S = 0.002


def binning_call(params, aux, camera, cfg):
    """A callable running bin_gaussians on the view's preprocess outputs."""
    with torch.no_grad():
        proj = preprocess(
            xyz=params.xyz, sh=params.get_features(), opacity=params.get_opacity(),
            scaling=params.get_scaling(), rotation=params.rotation, camera=camera,
            active_sh_degree=SH_DEGREE, alive=aux.alive)
    args = (proj.mean_pix, proj.depth, proj.ext, proj.conic, proj.qmax,
            camera.height, camera.width, cfg)

    def run():
        with torch.no_grad():
            return bin_gaussians(*args)

    return run


def per_call(ops, calls: int) -> list[dict]:
    """Each call's operation count, makespan, busy ms and operation sum,
    in call order (tools/trace.split_calls)."""
    rows = []
    for i, call_ops in enumerate(trace.split_calls(ops, calls)):
        gaps = trace.idle_gaps([(op.start_us, op.end_us) for op in call_ops])
        rows.append({"call": i, "ops": len(call_ops),
                     "makespan_ms": gaps["makespan"] / 1e3, "busy_ms": gaps["busy"] / 1e3,
                     "op_sum_ms": sum(op.us for op in call_ops) / 1e3})
    return rows


def run(params, aux, camera, cfg) -> dict:
    """The calls' per-call rows and their operations by name, as one dict.
    The host synchronises and sleeps PAUSE_S between calls, so that each
    call starts on an idle device and the calls split at those gaps."""
    calls = CALLS
    fn = binning_call(params, aux, camera, cfg)
    out = fn()
    torch.cuda.synchronize()
    def body():
        for _ in range(calls):
            fn()
            torch.cuda.synchronize()
            time.sleep(PAUSE_S)

    ops = trace.device_ops(whole_profile(body))
    rows = per_call(ops, calls)
    spans = [r["makespan_ms"] for r in rows]
    return with_refused({
        "tool": "trace_binning", "calls": calls,
        "num_instances": int(out.num_instances), "num_rows": int(out.num_rows),
        "ops_per_call": len(ops) / calls,
        "op_sum_ms_per_call": sum(op.us for op in ops) / 1e3 / calls,
        "makespan_ms_mean": sum(spans) / len(spans),
        "per_call": rows, "by_name": trace.by_name(ops, per=calls, top=TOP)})


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.parse_args(argv)
    require_card("trace_binning")
    kernels.build()
    params, aux, camera, cfg = bench_scene()
    out = run(params, aux, camera, cfg)
    by_name, rows = out.pop("by_name"), out.pop("per_call")
    print(json.dumps({"device": torch.cuda.get_device_name(0), **out}), flush=True)
    for row in rows + by_name:
        print(json.dumps({"tool": "trace_binning", **row}), flush=True)


if __name__ == "__main__":
    main()
