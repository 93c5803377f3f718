"""A projection of the sharded step's scaling over a mesh of cards: the
counterpart of the repository's tools/scaling_projection.py, on the
card's numbers.

Only one card is at hand, so this models t(D, T), the sharded step's time
on a (data D, tile T) mesh, from
  * stage times of the bench step measured on one card: from the lines
    `python -m gsjax_torch.profile_stages` printed (--stages-json; its
    table has no N-rate binning and no Adam, which then count 0), or
    measured when the tool runs (profile_stages' table, plus the N-rate
    binning and the Adam update the table leaves out);
  * the exact (Gaussian, tile) pair count of each slab of the bench view,
    from the port's binning on slab-local grids (parallel/render.py
    slab_rows; binning.bin_gaussians counts before any budget clamp);
  * a link rate (--link-gbps, GB/s each way). Its default is the H100 SXM
    data sheet's NVLink figure, 900 GB/s per GPU in both directions
    together, so 450 GB/s each way: a published number, not a measurement.

Model (parallel/step.py's structure):
  t(D, T) = t_replicated                 preprocess fwd+bwd, N-rate binning, Adam
          + t_slab * share(T)            instance-rate work, scaled by the
                                         largest slab's share of the pairs
          + ring(9 floats/Gaussian, T)   the raster cotangent over "tile"
          + ring(59 floats/Gaussian, D)  the parameter gradients over "data"
  ring(bytes, n) = 2 (n - 1) / n * bytes / link rate
  throughput = D * pixels / t(D, T); efficiency = throughput /
  (D * T * pixels / t(1, 1)).

    python -m gsjax_torch.tools.scaling_projection [--stages-json f] \
        [--link-gbps 450] [--out build/scaling_projection.json]

Writes the JSON artifact and prints one JSON line per mesh shape.
"""

from __future__ import annotations

import argparse
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# H100 SXM data sheet: NVLink 900 GB/s per GPU, both directions together.
NVLINK_GBPS_EACH_WAY = 450.0
RASTER_COT_FLOATS = 9  # mean_pix 2 + conic 3 + rgb 3 + opacity 1
PARAM_GRAD_FLOATS = 59  # xyz 3 + f_dc 3 + f_rest 45 + scale 3 + rot 4 + opacity 1
REPLICATED = ("preprocess_fwd_bwd", "binning_n_rate", "adam_update")
SLAB = ("binning_inst_rate", "permute_build_inst", "composite_fwd", "composite_bwd",
        "grad_reduction", "loss_and_misc")
MESHES = ((1, 1), (1, 2), (1, 4), (1, 8), (2, 1), (4, 1), (2, 2), (2, 4))
TILE_SPLITS = (2, 4, 8)
# profile_stages' stage names and the model's keys they fill.
PROFILE_STAGES = {
    "preprocess fwd+bwd": "preprocess_fwd_bwd",
    "binning": "binning",
    "permute+build_inst_data": "permute_build_inst",
    "composite fwd kernel": "composite_fwd",
    "composite bwd kernel": "composite_bwd",
    "grad reduction": "grad_reduction",
}


def ring_allreduce_ms(bytes_total: float, n: int, link_gbps: float) -> float:
    """Ring all-reduce time: 2(n-1)/n * bytes over one link direction."""
    if n <= 1:
        return 0.0
    return 2.0 * (n - 1) / n * bytes_total / (link_gbps * 1e9) * 1e3


def stages_from_profile(rows: list[dict], extra: dict | None = None) -> dict:
    """The model's stage ms from profile_stages' rows (device ms). Its
    binning is split into the N-rate part (extra["binning_n_rate"], 0 if
    not measured) and the rest; loss_and_misc is what the full fwd+bwd
    step holds beyond its stages; Adam is extra["adam_update"] (0 if not
    measured: the profiled step has none)."""
    extra = extra or {}
    ms = {r["stage"]: r["device_ms"] for r in rows}
    out = {key: ms[name] for name, key in PROFILE_STAGES.items()}
    binning = out.pop("binning")
    out["binning_n_rate"] = extra.get("binning_n_rate", 0.0)
    out["binning_inst_rate"] = max(binning - out["binning_n_rate"], 0.0)
    out["adam_update"] = extra.get("adam_update", 0.0)
    parts = binning + sum(out[k] for k in ("preprocess_fwd_bwd", "permute_build_inst",
                                           "composite_fwd", "composite_bwd",
                                           "grad_reduction"))
    out["loss_and_misc"] = max(ms["FULL fwd+bwd step"] - parts, 0.0)
    return out


def project(stages: dict, slabs: dict, n_gaussians: int, pixels: int,
            link_gbps: float, meshes=MESHES) -> tuple[float, list[dict]]:
    """(t(1,1) ms, one row per mesh) of the model above; slabs maps a tile
    count to its slabs' pair counts."""
    t_repl = sum(stages[k] for k in REPLICATED)
    t_slab1 = sum(stages[k] for k in SLAB)
    t11 = t_repl + t_slab1
    cot_bytes = RASTER_COT_FLOATS * 4 * n_gaussians
    grad_bytes = PARAM_GRAD_FLOATS * 4 * n_gaussians
    rows = []
    for d, t in meshes:
        if t in slabs:
            share = max(slabs[t]) / sum(slabs[t])
        elif t == 1:
            share = 1.0
        else:
            share = 1.0 / t
        tile_ms = ring_allreduce_ms(cot_bytes, t, link_gbps)
        data_ms = ring_allreduce_ms(grad_bytes, d, link_gbps)
        step = t_repl + t_slab1 * share + tile_ms + data_ms
        thru = d * pixels / (step / 1e3)
        rows.append({"mesh": {"data": d, "tile": t}, "max_slab_pair_share": share,
                     "imbalance_factor": share * t, "tile_psum_ms": tile_ms,
                     "data_psum_ms": data_ms, "step_ms": step,
                     "throughput_px_per_s": thru,
                     "efficiency": thru / (d * t * pixels / (t11 / 1e3))})
    return t11, rows


def slab_pair_counts(proj, width: int, height: int, cfg, splits=TILE_SPLITS) -> dict:
    """{n_tile: [pairs of each slab]}: the view's preprocessed Gaussians
    binned on each slab's local grid (the geometry of
    parallel/render.composite_slab), counted before any budget clamp."""
    import torch

    from gsjax_torch.parallel.render import slab_rows
    from gsjax_torch.render.binning import bin_gaussians, num_tiles

    tiles_x, _ = num_tiles(height, width, cfg.tw, cfg.th)
    w_pad = tiles_x * cfg.tw
    out = {}
    with torch.no_grad():
        for n_tile in splits:
            rows = slab_rows(height, n_tile, cfg.th)
            counts = []
            for i in range(n_tile):
                py0 = float(i * rows * cfg.th)
                mean_local = torch.cat([proj.mean_pix[:, :1], proj.mean_pix[:, 1:] - py0],
                                       dim=1)
                b = bin_gaussians(mean_local, proj.depth, proj.ext, proj.conic, proj.qmax,
                                  rows * cfg.th, w_pad, cfg, packed_paths=False)
                counts.append(int(b.num_instances))
            out[n_tile] = counts
    return out


def measure_stages(params, aux, camera, cfg, table: list[dict] | None = None) -> dict:
    """The model's stage ms on the card: profile_stages' table (`table`, its
    rows, if already measured), the N-rate binning (depth order and the
    fields' permute) and Adam on the bench state."""
    import torch

    from gsjax_torch.config import OptimizationConfig
    from gsjax_torch.model import PARAM_NAMES
    from gsjax_torch.profile_stages import Stages, profile
    from gsjax_torch.render.binning import depth_order, permute_rows
    from gsjax_torch.render.composite import pack_fields
    from gsjax_torch.tools.common import device_ms
    from gsjax_torch.train.optimizer import adam_init, adam_update, make_lr_tree

    stages = Stages(params, aux, camera, cfg)
    if table is None:
        table = profile(stages)["stages"]
    proj = stages.preprocess()
    fields12 = torch.cat([pack_fields(proj.mean_pix, proj.conic, proj.rgb, proj.opacity),
                          proj.ext, proj.qmax[:, None]], dim=-1)
    opt = adam_init(params)
    grads = {k: torch.zeros_like(getattr(params, k)) for k in PARAM_NAMES}
    lr = make_lr_tree(OptimizationConfig(), 1.0, torch.ones((), dtype=torch.int32,
                                                            device=params.device))
    with torch.no_grad():
        extra = {
            "binning_n_rate": device_ms(
                lambda: permute_rows(fields12, depth_order(proj.depth)), None),
            "adam_update": device_ms(lambda: adam_update(grads, opt, params, lr), None),
        }
    return stages_from_profile(table, extra)


def load_stages(path: str) -> dict:
    """The model's stage ms from a file of `python -m
    gsjax_torch.profile_stages`' JSON lines (its table has no N-rate
    binning and no Adam: both count 0)."""
    with open(path) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    return stages_from_profile([r for r in rows if "stage" in r])


def main(argv=None) -> dict:
    import torch

    from gsjax_torch.config import RasterConfig
    from gsjax_torch.render.preprocess import preprocess
    from gsjax_torch.tools.common import SH_DEGREE, bench_scene, require_card

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stages-json", default=None,
                    help="profile_stages' JSON lines from the card (else measured now)")
    ap.add_argument("--link-gbps", type=float, default=NVLINK_GBPS_EACH_WAY,
                    help="link rate each way, GB/s (default: the H100 SXM data "
                         "sheet's NVLink figure, not a measurement)")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "scaling_projection.json"))
    args = ap.parse_args(argv)
    require_card("scaling_projection")
    params, aux, camera, cfg = bench_scene()
    with torch.no_grad():
        proj = preprocess(
            xyz=params.xyz, sh=params.get_features(), opacity=params.get_opacity(),
            scaling=params.get_scaling(), rotation=params.rotation, camera=camera,
            active_sh_degree=SH_DEGREE, alive=aux.alive)
    # The counts come before any clamp: a small instance budget keeps the
    # expansion cheap, a row budget past every slab's rows keeps them exact.
    count_cfg = RasterConfig(tile_w=cfg.tw, tile_h=cfg.th, max_instances=128,
                             max_rows=1 << 20)
    slabs = slab_pair_counts(proj, camera.width, camera.height, count_cfg)
    del proj
    if args.stages_json:
        stages, source = load_stages(args.stages_json), args.stages_json
    else:
        stages, source = measure_stages(params, aux, camera, cfg), "measured now"
    n = params.capacity
    t11, rows = project(stages, slabs, n, camera.width * camera.height, args.link_gbps)
    out = {
        "tool": "scaling_projection", "device": torch.cuda.get_device_name(0),
        "kind": "a projection from one card's stage times, exact slab pair counts "
                "and an assumed link rate; no multi-card run",
        "scene": f"bench {camera.width}x{camera.height}, {n} Gaussians",
        "stage_ms": stages, "stage_source": source, "single_card_step_ms": t11,
        "slab_pair_counts": {str(k): v for k, v in slabs.items()},
        "assumptions": {
            "link_gbps_each_way": args.link_gbps,
            "link_rate_source": "H100 SXM data sheet (NVLink, 900 GB/s both ways)"
                                if args.link_gbps == NVLINK_GBPS_EACH_WAY else "argument",
            "collective_model": "ring all-reduce, 2(n-1)/n * bytes / link",
            "tile_traffic": f"{RASTER_COT_FLOATS} f32 per Gaussian",
            "data_traffic": f"{PARAM_GRAD_FLOATS} f32 per Gaussian (SH 3)",
        },
        "projection": rows,
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    for row in rows:
        print(json.dumps({"tool": "scaling_projection", **row}), flush=True)
    print(json.dumps({k: v for k, v in out.items() if k != "projection"}), flush=True)
    return out


if __name__ == "__main__":
    main()
