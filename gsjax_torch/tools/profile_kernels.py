"""Binning and composite-kernel timing on the card at the JAX tool's
defaults: the counterpart of the repository's tools/profile_kernels.py.

The bench scene (tools/common.bench_scene: 500k Gaussians, the origin
view at 1920x1080) in 16x16 tiles with budgets of 3 * 2^20 instances and
2^21 rows, the JAX tool's defaults, where the trainer's CLI runs 16x16
tiles. Its rows, each from the tool that owns the measurement:

  binning, stage by stage     tools.profile_binning (its stages, the row
                              engine, rank_prefix, the whole bin_gaussians)
  composite fwd / bwd kernel  tools.time_composite (each kernel alone)
  permute+build_inst_data, grad reduction, preprocess fwd+bwd
                              profile_stages.Stages
  untile+loss fwd+bwd         the image, L1 against a zero image and its
                              gradient with respect to the tiles

    python -m gsjax_torch.tools.profile_kernels [--tile_w 16 --tile_h 16]
        [--max_instances 3145728] [--max_rows 2097152] [--binning_only]

Prints one JSON line per row: event ms (CUDA events), device ms (torch.profiler);
and the instance and row counts against the budgets.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import torch

from gsjax_torch.config import RasterConfig
from gsjax_torch.profile_stages import Stages
from gsjax_torch.render import kernels
from gsjax_torch.tools import profile_binning, time_composite
from gsjax_torch.tools.common import (
    bench_scene,
    cuda_ms,
    device_ms,
    require_card,
    with_refused,
)
from gsjax_torch.train.loss import l1_loss

ITERS = 30
DEVICE_REPS = 20
DEFAULTS = dict(tile_w=16, tile_h=16, max_instances=3 * 2**20, max_rows=2**21)


def run(params, aux, camera, cfg, binning_only: bool = False, iters: int = ITERS,
        device_reps: int = DEVICE_REPS) -> list[dict]:
    """The rows above for one scene, view and configuration."""
    rows = profile_binning.profile(params, aux, camera, cfg, iters, device_reps)
    if binning_only:
        return rows
    rows.append({"tool": "profile_kernels", "stage": "composite kernels alone",
                 **time_composite.kernel_times(params, aux, camera, cfg, device_reps)})
    st = Stages(params, aux, camera, cfg)
    proj = st.preprocess()
    fields, binning = st.binning(proj)
    inst = st.build_inst(fields, binning)
    tile_color, tile_t = st.composite_fwd(inst, binning.tile_start)
    cot = st.cotangent(tile_color, tile_t)
    inst_grads = st.composite_bwd(inst, binning.tile_start, cot)

    def untile_loss():
        tc = tile_color.detach().requires_grad_(True)
        tt = tile_t.detach().requires_grad_(True)
        return torch.autograd.grad(l1_loss(st.image(tc, tt), st.gt), [tc, tt])

    for name, fn in (
        ("permute+build_inst_data", lambda: st.build_inst(fields, binning)),
        ("grad reduction", lambda: st.grad_reduction(inst_grads, binning)),
        ("untile+loss fwd+bwd", untile_loss),
        ("preprocess fwd+bwd", st.preprocess_fwd_bwd),
    ):
        rows.append(with_refused({"tool": "profile_kernels", "stage": name,
                                  "event_ms": cuda_ms(fn, iters, warmup=1),
                                  "device_ms": device_ms(fn, None, device_reps)}))
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    for k, v in DEFAULTS.items():
        ap.add_argument(f"--{k}", type=int, default=v)
    ap.add_argument("--binning_only", action="store_true")
    args = ap.parse_args(argv)
    require_card("profile_kernels")
    kernels.build()
    params, aux, camera, _ = bench_scene()
    cfg = RasterConfig(**{k: getattr(args, k) for k in DEFAULTS})
    print(json.dumps({"tool": "profile_kernels", "device": torch.cuda.get_device_name(0),
                      **dataclasses.asdict(cfg)}), flush=True)
    for row in run(params, aux, camera, cfg, args.binning_only):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
