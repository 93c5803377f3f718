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

--sharded traces the mesh-sharded step (gsjax_torch.parallel.step) on a
(data=1, tile=1) mesh of this one card instead, in a world-size-1 NCCL
group: its families also hold the halo exchange and the collectives.

Prints JSON lines: the step's ms by CUDA events (untraced), then the
trace: device busy ms, makespan and idle share per step with the largest
idle gaps, ms by family, and the top operations by name.
"""

from __future__ import annotations

import argparse
import json

import torch
import torch.distributed as dist

from gsjax_torch.parallel import render as parallel_render
from gsjax_torch.parallel import step as parallel_step
from gsjax_torch.render import api as render_api
from gsjax_torch.render import kernels
from gsjax_torch.tools import trace
from gsjax_torch.tools.common import (
    bench_scene,
    cuda_ms,
    require_card,
    whole_profile,
    with_refused,
)
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
# The sharded step's functions: the slab's binning, composite and untiling
# (parallel/render.py), and the step's own (parallel/step.py).
SHARDED_MARKS = (
    (parallel_step, "preprocess", "preprocess"),
    (parallel_render, "bin_gaussians", "binning"),
    (parallel_render, "permute_rows", "binning"),
    (parallel_render, "composite", "composite other"),
    (parallel_render, "untile_image", "untile"),
    (parallel_step, "halo_exchange", "halo exchange"),
    (parallel_step, "ssim_map", "SSIM"),
    (parallel_step, "make_lr_tree", "Adam"),
    (parallel_step, "adam_update", "Adam"),
    (dist, "all_reduce", "collectives"),
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


def sharded_bench_step(params, aux, camera, cfg, mesh):
    """bench_step's counterpart for the mesh-sharded step on `mesh` (the
    batch of one camera per data group is the one view)."""
    from gsjax_torch.config import OptimizationConfig
    from gsjax_torch.parallel.mesh import dim_size
    from gsjax_torch.train.optimizer import adam_init

    dev = params.device
    b = dim_size(mesh, "data")
    state = step_mod.clone_state(step_mod.TrainState(
        params=params, opt=adam_init(params), aux=aux,
        step=torch.ones((), dtype=torch.int32, device=dev)))
    step = parallel_step.make_sharded_train_step(
        mesh, height=camera.height, width=camera.width, active_sh_degree=3,
        opt_cfg=OptimizationConfig(), raster_cfg=cfg, spatial_lr_scale=1.0)
    args = tuple(t[None].expand(b, *t.shape) for t in (
        camera.view, camera.full_proj, camera.cam_center, camera.tan_fovx,
        camera.tan_fovy, torch.zeros((3, camera.height, camera.width), device=dev)))
    bg = torch.zeros(3, device=dev)
    holder = {"state": state}

    def run():
        holder["state"], m = step(holder["state"], *args, bg)
        return m.loss

    return run


def trace_ops(fn, steps: int, marks=MARKS) -> list[trace.DeviceOp]:
    """The device operations of `steps` runs of fn() in one whole profiler
    session (tools/common.whole_profile), with the marks' ranges open."""
    def body():
        for _ in range(steps):
            fn()

    torch.cuda.synchronize()
    with trace.marked(marks):
        return trace.device_ops(whole_profile(body, cpu=True))


def run(params, aux, camera, cfg, mesh=None) -> dict:
    """The step's event ms and its traced split, as one dict: train_step,
    or with a mesh the sharded step."""
    steps = STEPS
    if mesh is None:
        fn, marks = bench_step(params, aux, camera, cfg), MARKS
    else:
        fn, marks = sharded_bench_step(params, aux, camera, cfg, mesh), SHARDED_MARKS
    step_ms = cuda_ms(fn, reps=3, warmup=WARMUP)
    ops = trace_ops(fn, steps, marks)
    gaps = trace.idle_gaps([(op.start_us, op.end_us) for op in ops])
    fam = trace.by_family(ops, per=steps)
    return with_refused({
        "tool": "trace_step", "sharded": mesh is not None, "steps": steps,
        "step_ms": step_ms,
        "device_ops_per_step": len(ops) / steps,
        "busy_ms": gaps["busy"] / 1e3 / steps,
        "makespan_ms": gaps["makespan"] / 1e3 / steps,
        "idle_ms": gaps["idle"] / 1e3 / steps, "idle_share": gaps["idle_share"],
        "gaps": gaps["gaps"] / steps,
        "largest_gaps_us": [round(g["gap"], 1) for g in gaps["largest"]],
        "by_family_ms": fam,
        "by_name": trace.by_name(ops, per=steps, top=TOP),
    })


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sharded", action="store_true",
                    help="the mesh-sharded step on a 1x1 mesh of this card")
    args = ap.parse_args(argv)
    require_card("trace_step")
    kernels.build()
    params, aux, camera, cfg = bench_scene()
    if args.sharded:
        from gsjax_torch.parallel import make_mesh
        from gsjax_torch.parallel.multihost import init_local_group

        init_local_group("cuda")
        try:
            out = run(params, aux, camera, cfg, make_mesh("cuda", data=1, tile=1))
        finally:
            dist.destroy_process_group()
    else:
        out = run(params, aux, camera, cfg)
    by_name = out.pop("by_name")
    print(json.dumps({"device": torch.cuda.get_device_name(0), **out}), flush=True)
    for row in by_name:
        print(json.dumps({"tool": "trace_step", **row}), flush=True)


if __name__ == "__main__":
    main()
