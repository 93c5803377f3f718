"""Sub-stage device time of bin_gaussians on the card: the counterpart of
the repository's tools/profile_binning.py.

Each stage of the binning pipeline runs alone on inputs computed once
from the bench scene (tools/common.bench_scene: 500k Gaussians, 1920x1080,
32x32 tiles), so that the binning stage's time (profile_stages) splits
into its parts. The JAX tool's stages, as the port has them:

  1 depth sort                 depth_order (a stable sort of the depths)
  2 (N,8) permute gather       permute_rows of binning's 8 fields
  3 rects + row cumsum         tile_rect_ext, the row counts' cumsum
  4 L1 expand                  the gather path's owner per run (mark
                               scatter + cumsum, _expand at R)
  5 (R,10) row-table gather    the gather path's table rows per run
  6 row-interval math          row_tiles on those rows
  7 inst cumsum (R)            the instance counts' cumsum
  8 L2 expand                  rank_prefix over the packed words (P slots)
  9 unpack + mask              owner and tile out of the packed words
  10 tile sort                 the (tile, slot) key sort
  11 searchsorted tile starts  the tiles' first slots

then `row_engine` (stages 4-7 fused in one kernel; with stage 8 the
packed path), `rank_prefix` in the rank form's owner expansion at R, and
the whole `bin_gaussians`. One JSON line per stage: event ms (CUDA
events over ITERS runs, host work included), device ms (torch.profiler:
all the stage's device work), the stage's device operations per run
(kernels and memsets), and for the stages that are one kernel kernel_ms,
that kernel's device time alone. Then the instance and row counts.

    python -m gsjax_torch.tools.profile_binning

It runs against an earlier tree of the package as well (copy this file
into that tree's gsjax_torch/tools/): two trees compared in one call, in
turns. `run(device="cpu")` drives every stage once on a small scene and
checks that the stages rebuild bin_gaussians' stream; it times nothing.
"""

from __future__ import annotations

import json

import torch

from gsjax_torch.render import binning as B
from gsjax_torch.render import kernels
from gsjax_torch.render.preprocess import preprocess
from gsjax_torch.tools.common import (
    SH_DEGREE,
    bench_scene,
    cuda_ms,
    device_ms,
    device_ops,
    require_card,
    with_refused,
)

ITERS = 30
DEVICE_REPS = 20
L2 = "8 L2 expand: rank_prefix (P slots)"
RANK_FORM = "rank_prefix, rank form (R slots)"
# The stages that are one kernel, and its name as the profiler reports it.
KERNEL_NAMES = {"row_engine": "row_engine_", L2: "rank_prefix_kernel",
                RANK_FORM: "rank_prefix_kernel"}


def stages(params, aux, camera, cfg) -> tuple[dict, dict]:
    """The binning stages as callables on precomputed inputs, in the JAX
    tool's order, and the counts and outputs they give."""
    dev = params.device
    with torch.no_grad():
        proj = preprocess(
            xyz=params.xyz, sh=params.get_features(), opacity=params.get_opacity(),
            scaling=params.get_scaling(), rotation=params.rotation, camera=camera,
            active_sh_degree=SH_DEGREE, alive=aux.alive,
        )
    mean_pix, depth, ext = proj.mean_pix.detach(), proj.depth.detach(), proj.ext.detach()
    conic, qmax = proj.conic.detach(), proj.qmax.detach()
    height, width = camera.height, camera.width
    n = mean_pix.shape[0]
    tiles_x, tiles_y = B.num_tiles(height, width, cfg.tw, cfg.th)
    n_tiles = tiles_x * tiles_y
    P, R = cfg.max_instances, cfg.max_rows
    geo = dict(tiles_x=tiles_x, tile_w=cfg.tw, tile_h=cfg.th)

    perm = B.depth_order(depth)
    packed0 = torch.cat([mean_pix, conic, ext, qmax[:, None]], dim=-1)
    packed = B.permute_rows(packed0, perm)
    mp, co, ex, qm = packed[:, 0:2], packed[:, 2:5], packed[:, 5:7], packed[:, 7]

    def rects():
        x0, y0, x1, y1 = B.tile_rect_ext(mp, ex, tiles_x, tiles_y, cfg.tw, cfg.th)
        rcum = torch.cumsum(y1 - y0, dim=0, dtype=torch.int32)
        return x0, y0, x1, y1, rcum

    x0, y0, x1, y1, rcum = rects()
    rstart = rcum - (y1 - y0)
    total_rows = rcum[-1]
    qm_cull = B._f2i(qm * B.CULL_QMAX_MARGIN + 1e-6)
    rowner, r = B._expand(rstart, R)
    rg = rowner.clamp(0, n - 1).long()
    row_table = torch.stack(
        [rstart, y0, x0, x1, B._f2i(mp[:, 0]), B._f2i(mp[:, 1]),
         B._f2i(co[:, 0]), B._f2i(co[:, 1]), B._f2i(co[:, 2]), qm_cull], dim=-1)
    rt = row_table[rg]
    rvalid = r < torch.clamp(total_rows, max=R)

    def interval_math():
        return kernels.row_tiles(
            rt[:, 1].long() + (r - rt[:, 0]).long(),
            B._i2f(rt[:, 4]), B._i2f(rt[:, 5]), B._i2f(rt[:, 6]),
            B._i2f(rt[:, 7]), B._i2f(rt[:, 8]), B._i2f(rt[:, 9]),
            rt[:, 2], rt[:, 3], rvalid, **geo)

    counts, _ = interval_math()
    inst_counts = counts.to(torch.int32)

    bits_tile = B._bits(n_tiles - 1)
    bits_p = B._bits(P - 1)
    zeros = torch.zeros(n, dtype=torch.int32, device=dev)
    table = torch.stack(
        [rstart, rcum, y0, x0, x1, B._f2i(mp[:, 0]), B._f2i(mp[:, 1]),
         B._f2i(co[:, 0]), B._f2i(co[:, 1]), B._f2i(co[:, 2]), qm_cull,
         torch.arange(n, dtype=torch.int32, device=dev), zeros, zeros, zeros, zeros],
        dim=0)

    def row_engine():
        return kernels.row_engine(table, total_rows, budget=R,
                                  bits_tile=bits_tile, **geo)

    istart, delta, u, total = row_engine()

    def level2():
        return kernels.rank_prefix(istart, delta, budget=P, plus_iota=True, dcum=u)

    w = level2().to(torch.int64) & 0xFFFFFFFF
    p = torch.arange(P, dtype=torch.int32, device=dev)

    def unpack():
        ivalid = p < torch.clamp(total, max=P)
        g = torch.where(ivalid, (w >> bits_tile).to(torch.int32).clamp(0, n - 1), n)
        tile = torch.where(ivalid, (w & ((1 << bits_tile) - 1)).to(torch.int32), n_tiles)
        return g, tile

    g, tile = unpack()
    key = (tile.long() << bits_p) | p.long()
    skey = torch.sort(key)[0]
    bounds = torch.arange(n_tiles + 1, dtype=torch.int64, device=dev) << bits_p
    ones = torch.ones_like(rstart)

    table_of_stages = {
        "1 depth sort": lambda: B.depth_order(depth),
        "2 (N,8) permute gather": lambda: B.permute_rows(packed0, perm),
        "3 rects + row cumsum": rects,
        "4 L1 expand (gather path)": lambda: B._expand(rstart, R),
        "5 (R,10) row-table gather": lambda: row_table[rg],
        "6 row-interval math": interval_math,
        "7 inst cumsum (R)": lambda: torch.cumsum(inst_counts, dim=0, dtype=torch.int32),
        L2: level2,
        "9 unpack + mask": unpack,
        "10 tile sort": lambda: torch.sort(key),
        "11 searchsorted tile starts": lambda: torch.searchsorted(skey, bounds),
        "row_engine": row_engine,
        RANK_FORM: lambda: kernels.rank_prefix(
            rstart, ones, budget=R, init=-1),
        "bin_gaussians (whole)": lambda: B.bin_gaussians(
            mean_pix, depth, ext, conic, qmax, height, width, cfg),
    }
    outputs = dict(g=g, total=total, total_rows=total_rows, rowner=rowner,
                   bits_p=bits_p)
    return table_of_stages, outputs


def check(table_of_stages: dict, outputs: dict) -> None:
    """The stages rebuild bin_gaussians' stream: the same instance count,
    per-tile starts and tile-sorted owners; the rank form's owners equal
    the gather path's."""
    whole = table_of_stages["bin_gaussians (whole)"]()
    skey, order = table_of_stages["10 tile sort"]()
    n_tiles = whole.tile_start.shape[0] - 1
    owner = torch.where((skey >> outputs["bits_p"]) < n_tiles, outputs["g"][order],
                        whole.perm.shape[0])
    starts = table_of_stages["11 searchsorted tile starts"]().to(torch.int32)
    ranked = table_of_stages[RANK_FORM]()
    for what, ok in (
        ("instance count", int(whole.num_instances) == int(outputs["total"])),
        ("tile starts", torch.equal(starts, whole.tile_start)),
        ("sorted owners", torch.equal(owner.to(torch.int32), whole.sorted_owner)),
        ("rank form owners", torch.equal(ranked, outputs["rowner"])),
    ):
        if not ok:
            raise AssertionError(f"profile_binning: the stages' {what} differ "
                                 "from bin_gaussians'")


def profile(params, aux, camera, cfg, iters: int = ITERS,
            device_reps: int = DEVICE_REPS) -> list[dict]:
    """One row per stage of binning this scene and view. On the card:
    event ms, device ms, device operations per run (and kernel_ms for the
    stages that are one kernel). On the CPU every stage runs once and is
    checked; nothing is timed."""
    table_of_stages, outputs = stages(params, aux, camera, cfg)
    check(table_of_stages, outputs)
    on_card = params.device.type == "cuda"
    rows = []
    for name, fn in table_of_stages.items():
        row = {"tool": "profile_binning", "stage": name}
        if on_card:
            row.update(event_ms=cuda_ms(fn, iters, warmup=1),
                       device_ms=device_ms(fn, None, device_reps),
                       device_ops=device_ops(fn))
            if name in KERNEL_NAMES:
                row["kernel_ms"] = device_ms(fn, KERNEL_NAMES[name], device_reps)
        else:
            fn()
            row["device_ms"] = "not measured"
        rows.append(with_refused(row))
    rows.append({"tool": "profile_binning", "num_instances": int(outputs["total"]),
                 "num_rows": int(outputs["total_rows"]),
                 "budgets": {"max_instances": cfg.max_instances,
                             "max_rows": cfg.max_rows}})
    return rows


def run(device=None, n: int | None = None, width: int | None = None,
        height: int | None = None, budgets: dict | None = None) -> list[dict]:
    """profile() of the bench scene; with device="cpu" (and a small scene)
    every stage runs once and is checked."""
    kw = {k: v for k, v in dict(n=n, width=width, height=height,
                                budgets=budgets).items() if v is not None}
    return profile(*bench_scene(device=device, **kw))


def main() -> None:
    require_card("profile_binning")
    kernels.build()
    print(json.dumps({"tool": "profile_binning", "device": torch.cuda.get_device_name(0),
                      "package": str(kernels.CSRC.parent)}), flush=True)
    for row in run():
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
