"""Tile-parallel scaling of the sharded train step: the counterpart of the
repository's tools/bench_scaling.py.

Times the mesh-sharded training window (parallel/step.py
make_sharded_train_steps: on the card replays of its captured CUDA graph,
on the CPU the loop) per mesh shape (data=1, tile=n) for each n of
--tiles up to the world it is launched in, and gives pixels per second and
eff(n) = t(1) / (n * t(n)) against the one-rank mesh. The world's ranks
measure n = world first; then the first n ranks of it form a group of n
for each smaller n, in turn (one process per rank throughout, ports handed
out by rank 0).

    torchrun --nproc_per_node <n> -m gsjax_torch.tools.bench_scaling \
        [--tiles 1,2,4,8] [--width 640] [--height 360] [--gaussians 50000] [--iters 5]
        [--out payload.json]
    python -m gsjax_torch.tools.bench_scaling --device cpu   # gloo, one rank

`--n` is the JAX tool's name for --gaussians and works when the tool runs
without torchrun; under torchrun only --gaussians works, since torchrun
takes `--n` for an abbreviation of its own options.

The raster budgets are sized to the view's exact pair and row counts. NCCL
on the card, gloo with --device cpu. Rank 0 prints one JSON line.
Ranks that share a processor (every CPU rank: gloo ranks time-slice one
host) measure that the schedule runs, not how it scales: the line says so
under "evidence" and carries no efficiency. A world of one rank measures
t(1) alone.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch
import torch.distributed as dist

WINDOW_WARMUP = 1
TILE = 32
NOT_SCALING = ("NONE: the ranks share one processor; this checks that the sharded "
               "schedule runs, it is not a scaling measurement")


def run(mesh, params, aux, camera, cfg, iters: int) -> float:
    """ms per step of the sharded window of `iters` steps on `mesh`, after
    a warm-up window (the capture, on the card)."""
    from gsjax_torch.config import OptimizationConfig
    from gsjax_torch.parallel.step import make_sharded_train_steps
    from gsjax_torch.train.optimizer import adam_init
    from gsjax_torch.train.step import TrainState, clone_state, drop_step_graphs

    dev = params.device
    steps = make_sharded_train_steps(
        mesh, height=camera.height, width=camera.width, active_sh_degree=3,
        opt_cfg=OptimizationConfig(), raster_cfg=cfg, spatial_lr_scale=1.0)
    state = clone_state(TrainState(params=params, opt=adam_init(params), aux=aux,
                                   step=torch.ones((), dtype=torch.int32, device=dev)))
    window = [t[None, None].expand(iters, 1, *t.shape) for t in (
        camera.view, camera.full_proj, camera.cam_center, camera.tan_fovx, camera.tan_fovy,
        torch.zeros((3, camera.height, camera.width), device=dev))]
    bgs = torch.zeros((iters, 3))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dist.barrier()

    for _ in range(WINDOW_WARMUP):
        state, _ = steps(state, *window, bgs)
    sync()
    t0 = time.perf_counter()
    state, m = steps(state, *window, bgs)
    loss = float(m.loss[-1])
    sync()
    ms = (time.perf_counter() - t0) * 1e3 / iters
    drop_step_graphs()
    if loss != loss:
        raise AssertionError(f"bench_scaling: non-finite loss {loss}")
    return ms


def sized_config(params, aux, camera, tile: int = TILE):
    """32x32 tiles, budgets the next powers of two past the whole view's
    exact pair and row counts (probe_tilesize.count_pairs) with 3 %
    headroom: a slab never holds more."""
    from gsjax_torch.config import RasterConfig, pow2_budget
    from gsjax_torch.render.preprocess import preprocess
    from gsjax_torch.tools.probe_tilesize import count_pairs

    with torch.no_grad():
        proj = preprocess(
            xyz=params.xyz, sh=params.get_features(), opacity=params.get_opacity(),
            scaling=params.get_scaling(), rotation=params.rotation, camera=camera,
            active_sh_degree=3, alive=aux.alive)
    pairs, rows, _ = count_pairs(proj, tile, tile, camera.width, camera.height)
    return RasterConfig(tile_w=tile, tile_h=tile, max_instances=pow2_budget(pairs, 1.03),
                        max_rows=pow2_budget(rows, 1.03))


def payload(results: list[dict], width: int, height: int, n_gaussians: int,
            device: str, shares_processor: bool) -> dict:
    """The printed line: pixels per second per mesh, and eff(n) against
    the one-rank mesh where it was measured, unless the ranks shared a
    processor."""
    results = sorted(results, key=lambda r: r["tile"])
    t1 = results[0]["ms_per_step"] if results and results[0]["tile"] == 1 else None
    for r in results:
        r["pixels_per_s"] = width * height / (r["ms_per_step"] / 1e3)
        if t1 is not None and not shares_processor:
            r["efficiency_vs_1"] = t1 / (r["tile"] * r["ms_per_step"])
    out = {"tool": "bench_scaling", "device": device, "width": width, "height": height,
           "n_gaussians": n_gaussians, "results": results}
    if shares_processor:
        out["evidence"] = NOT_SCALING
    elif len(results) == 1:
        out["evidence"] = "one rank: t(1) only, no scaling measured"
    return out


def make_parser() -> argparse.ArgumentParser:
    """The JAX tool's flags (tools/bench_scaling.py:30-42) but its TPU-only
    --virtual, and the port's --device."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tiles", default="1,2,4,8")
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=360)
    ap.add_argument("--gaussians", "--n", dest="gaussians", type=int, default=50_000,
                    help="Gaussians in the scene; --n (the JAX tool's name) only "
                         "without torchrun, which takes --n for its own option")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=None,
                    help="also write the JSON payload to this file (rank 0)")
    return ap


def main(argv=None) -> dict | None:
    from gsjax_torch.parallel import make_mesh
    from gsjax_torch.parallel.mesh import backend_for, local_rank
    from gsjax_torch.parallel.multihost import TIMEOUT, free_port, init_local_group
    from gsjax_torch.synthetic import look_at_origin_camera, random_scene

    args = make_parser().parse_args(argv)
    if args.device == "cuda":
        from gsjax_torch.tools.common import require_card

        require_card("bench_scaling")
    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))
    if "WORLD_SIZE" in os.environ:  # torchrun's protocol, a world of one too
        if args.device == "cuda":
            torch.cuda.set_device(local_rank(rank))
        dist.init_process_group(backend_for(args.device), init_method="env://",
                                timeout=TIMEOUT)
    else:
        init_local_group(args.device)
    tiles = sorted({int(t) for t in args.tiles.split(",") if int(t) <= world} | {world},
                   reverse=True)
    # Ports for the smaller groups, chosen on rank 0's host.
    ports = [{n: free_port() for n in tiles[1:]} if rank == 0 else None]
    dist.broadcast_object_list(ports, src=0)
    addr = os.environ.get("MASTER_ADDR", "127.0.0.1")
    dev = torch.device(args.device, local_rank(rank)) if args.device == "cuda" else \
        torch.device("cpu")
    params, aux = random_scene(args.gaussians, capacity=args.gaussians, sh_degree=3, seed=0, spread=2.5,
                               scale_range=(0.004, 0.03), device=dev)
    camera = look_at_origin_camera(args.width, args.height, device=dev)
    cfg = sized_config(params, aux, camera)
    results = []
    try:
        for i, n in enumerate(tiles):
            if i:
                dist.destroy_process_group()
                if rank >= n:
                    break
                # An explicit store: under torchrun a tcp:// init would join
                # the launcher's store instead of hosting its own.
                store = dist.TCPStore(addr, ports[0][n], n, is_master=rank == 0,
                                      timeout=TIMEOUT)
                dist.init_process_group(backend_for(args.device), store=store, rank=rank,
                                        world_size=n, timeout=TIMEOUT)
            mesh = make_mesh(args.device, data=1, tile=n)
            results.append({"tile": n, "ms_per_step": run(mesh, params, aux, camera, cfg,
                                                           args.iters)})
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    if rank != 0:
        return None
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    out = payload(results, args.width, args.height, args.gaussians, name,
                  shares_processor=dev.type == "cpu")
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
