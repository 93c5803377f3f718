"""Single-card overhead of the mesh-sharded train step against train_step:
the counterpart of the repository's tools/bench_mesh_overhead.py.

Both steps train the bench scene (tools/common.bench_scene: 500k
Gaussians, SH degree 3, the origin view at 1920x1080, 32x32 tiles)
against a zero image, each from its own copy of the state, eagerly: (a)
train_step, (b) the sharded step (gsjax_torch.parallel.step) on a
(data=1, tile=1) mesh of this card in a world-size-1 NCCL group. The
difference is the cost of the mesh plumbing when no parallelism exists:
the padded slab, the halo-form SSIM, the two-stage backward and the
collectives on one rank. The two run in turns (plain, sharded, sharded,
plain), each turn ITERS steps by CUDA events after WARMUP.

    python -m gsjax_torch.tools.bench_mesh_overhead

Prints one JSON line: ms per step of each (mean of its turns, and each
turn), the sharded step's overhead, and the NCCL group's start-up seconds.
"""

from __future__ import annotations

import argparse
import json
import time

import torch
import torch.distributed as dist

from gsjax_torch.render import kernels
from gsjax_torch.tools.common import bench_scene, cuda_ms, require_card
from gsjax_torch.tools.trace_step import bench_step, sharded_bench_step

ITERS = 10
WARMUP = 3
TURNS = ("plain", "sharded", "sharded", "plain")


def run(params, aux, camera, cfg, mesh, iters: int = ITERS) -> dict:
    """ms per step of train_step and of the sharded step on `mesh`, in
    turns."""
    fns = {"plain": bench_step(params, aux, camera, cfg),
           "sharded": sharded_bench_step(params, aux, camera, cfg, mesh)}
    turns = {k: [] for k in fns}
    for name in TURNS:
        turns[name].append(cuda_ms(fns[name], reps=iters, warmup=WARMUP))
    plain, sharded = (sum(turns[k]) / len(turns[k]) for k in ("plain", "sharded"))
    return {"tool": "bench_mesh_overhead", "iters": iters, "plain_ms": plain,
            "sharded_ms": sharded, "overhead": sharded / plain - 1.0,
            "turns_ms": turns}


def main(argv=None) -> None:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    require_card("bench_mesh_overhead")
    from gsjax_torch.parallel import make_mesh
    from gsjax_torch.parallel.multihost import init_local_group

    kernels.build()
    params, aux, camera, cfg = bench_scene()
    t0 = time.perf_counter()
    init_local_group("cuda")
    try:
        mesh = make_mesh("cuda", data=1, tile=1)
        init_s = time.perf_counter() - t0
        out = run(params, aux, camera, cfg, mesh)
    finally:
        dist.destroy_process_group()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "group_init_s": init_s,
                      **out}), flush=True)


if __name__ == "__main__":
    main()
