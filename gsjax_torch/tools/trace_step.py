"""A torch.profiler trace of the bench training step on the card, its
device time split by operation and by op family: the counterpart of the
repository's tools/trace_step.py (there a jax.profiler trace).

The step is train_step() (render, L1 + SSIM, the backward, Adam and the
densification statistics) on the bench scene (tools/common.bench_scene:
500k Gaussians, SH degree 3, the origin view at 1920x1080, 32x32 tiles)
against a zero image, from a copy of the scene's state. After WARMUP
steps, one step is traced (STEPS). The families (tools/trace.py) are the
ranges opened around the path's functions while tracing: preprocess (and
its autograd), binning, the composite's own work, the image's untiling,
L1, SSIM, Adam, the densification statistics; and by what ran, the
composite kernels and the gathers.

    python -m gsjax_torch.tools.trace_step [--sharded]

Prints JSON lines: the step's ms by CUDA events (untraced), then the
trace: device busy ms, makespan and idle share per step with the largest
idle gaps, ms by family, and the top operations by name. --sharded (the
mesh step of the JAX tool) raises NotImplementedError: the mesh is not
ported (ROADMAP queue item 6).
"""

from __future__ import annotations

import argparse
import json

import torch

from gsjax_torch.render import api as render_api
from gsjax_torch.render import kernels
from gsjax_torch.tools import trace
from gsjax_torch.tools.common import PROFILE_TRIES, bench_scene, cuda_ms, require_card
from gsjax_torch.train import step as step_mod

WARMUP = 3
STEPS = 1
TOP = 30
# The traced path's functions and their families (tools/trace.py).
MARKS = (
    (render_api, "preprocess", "preprocess"),
    (render_api, "depth_sorted_bins", "binning"),
    (render_api, "composite", "composite other"),
    (render_api, "untile_image", "untile"),
    (step_mod, "l1_loss", "L1"),
    (step_mod, "ssim", "SSIM"),
    (step_mod, "make_lr_tree", "Adam"),
    (step_mod, "adam_update", "Adam"),
    (step_mod, "add_densification_stats", "densify statistics"),
)


def bench_step(params, aux, camera, cfg):
    """A callable running one train_step on a copy of the scene's state
    against a zero image, and that copy's holder."""
    from gsjax_torch.config import OptimizationConfig
    from gsjax_torch.train.optimizer import adam_init

    dev = params.device
    state = step_mod.clone_state(step_mod.TrainState(
        params=params, opt=adam_init(params), aux=aux,
        step=torch.ones((), dtype=torch.int32, device=dev)))
    gt = torch.zeros((3, camera.height, camera.width), device=dev)
    bg = torch.zeros(3, device=dev)
    holder = {"state": state}

    def run():
        holder["state"], m = step_mod.train_step(
            holder["state"], camera, gt, bg, active_sh_degree=3,
            opt_cfg=OptimizationConfig(), raster_cfg=cfg, spatial_lr_scale=1.0)
        return m.loss

    return run


def trace_ops(fn, steps: int) -> list[trace.DeviceOp]:
    """The device operations of `steps` runs of fn() under the profiler,
    with the marks' ranges open; a session without device operations is
    taken again (tools/common.PROFILE_TRIES)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        with trace.marked(MARKS), profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                fn()
            torch.cuda.synchronize()
        ops = trace.device_ops(prof)
        if ops:
            return ops
    raise AssertionError(f"the profiler saw no device operation in {PROFILE_TRIES} sessions")


def run(params, aux, camera, cfg) -> dict:
    """The step's event ms and its traced split, as one dict."""
    steps = STEPS
    fn = bench_step(params, aux, camera, cfg)
    step_ms = cuda_ms(fn, reps=3, warmup=WARMUP)
    ops = trace_ops(fn, steps)
    gaps = trace.idle_gaps([(op.start_us, op.end_us) for op in ops])
    fam = trace.by_family(ops, per=steps)
    return {
        "tool": "trace_step", "steps": steps, "step_ms": step_ms,
        "device_ops_per_step": len(ops) / steps,
        "busy_ms": gaps["busy"] / 1e3 / steps,
        "makespan_ms": gaps["makespan"] / 1e3 / steps,
        "idle_ms": gaps["idle"] / 1e3 / steps, "idle_share": gaps["idle_share"],
        "gaps": gaps["gaps"] / steps,
        "largest_gaps_us": [round(g["gap"], 1) for g in gaps["largest"]],
        "by_family_ms": fam,
        "by_name": trace.by_name(ops, per=steps, top=TOP),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sharded", action="store_true",
                    help="the mesh step (not ported: ROADMAP queue item 6)")
    args = ap.parse_args(argv)
    if args.sharded:
        raise NotImplementedError(
            "trace_step --sharded traces the mesh step, which is not ported yet "
            "(ROADMAP queue item 6)")
    require_card("trace_step")
    kernels.build()
    params, aux, camera, cfg = bench_scene()
    out = run(params, aux, camera, cfg)
    by_name = out.pop("by_name")
    print(json.dumps({"device": torch.cuda.get_device_name(0), **out}), flush=True)
    for row in by_name:
        print(json.dumps({"tool": "trace_step", **row}), flush=True)


if __name__ == "__main__":
    main()
