"""Stage-by-stage time of the port's 1080p / 500k fwd+bwd step on the card.

The counterpart of the repository's profile_stages.py, on bench.py's work
(tools/common.bench_scene, L1 against a zero image). Each stage runs
alone, ITERS times back to back, on the outputs of the stage before it:

  FULL fwd+bwd step         render, L1, gradients of the raw parameters
                            and mean2d_offset
  FULL fwd only             render and L1
  preprocess (fwd)          projection, SH -> RGB, conics, extents
  preprocess fwd+bwd        the same and its autograd, from the sum of
                            the fields the rest of the path reads
  binning                   the depth permute of the composite's and
                            binning's fields (one N-rate gather in the
                            port) and bin_gaussians
  permute+build_inst_data   the instance gather of the composite's rows
  composite fwd kernel      composite_forward
  composite bwd kernel      composite_backward, on dC = 1, dT = 1
  grad reduction            inverse tile sort, owner regroup, segment_sum

    python -m gsjax_torch.profile_stages [--ply point_cloud.ply [--orbit 0.6]]

--ply profiles a trained model's PLY instead of the random scene, from
the quality scene's orbit camera at angle --orbit (tools/bench_trained.py's
pose family), with budgets sized to the view's counts (+3 %).

One JSON line per stage: event ms (CUDA events over ITERS runs, host
launch work included), device ms (torch.profiler: all of the stage's
device work, mean of DEVICE_REPS runs) and its device kernel count per
run; then the rect and live instance counts.
"""

from __future__ import annotations

import argparse
import json

import torch

from gsjax_torch.config import RasterConfig, pow2_budget, resolve_device
from gsjax_torch.model import PARAM_NAMES
from gsjax_torch.render import kernels
from gsjax_torch.render.api import depth_sorted_bins, render
from gsjax_torch.render.binning import num_tiles
from gsjax_torch.render.common import build_inst_data, untile_image
from gsjax_torch.render.composite import composite_cotangent, owner_sums
from gsjax_torch.render.preprocess import preprocess
from gsjax_torch.scene import load_ply_model
from gsjax_torch.tools.common import (
    HEIGHT,
    SH_DEGREE,
    TILE,
    WIDTH,
    bench_scene,
    cuda_ms,
    device_event_names,
    device_ms,
    require_card,
    trained_orbit_camera,
    whole_profile,
    with_refused,
)
from gsjax_torch.train.loss import l1_loss

ITERS = 30
DEVICE_REPS = 10


class Stages:
    """The step's stages as callables; each takes the outputs of the stage
    before it, so that chained they give render()'s image."""

    def __init__(self, params, aux, camera, cfg, sh_degree: int = SH_DEGREE):
        dev = params.device
        self.params, self.aux, self.camera, self.cfg = params, aux, camera, cfg
        self.sh_degree = sh_degree
        self.bg = torch.zeros(3, device=dev)
        self.gt = torch.zeros((3, camera.height, camera.width), device=dev)
        self.offset = torch.zeros((params.capacity, 2), device=dev,
                                  requires_grad=True)
        self.tiles_x, self.tiles_y = num_tiles(camera.height, camera.width,
                                               cfg.tw, cfg.th)
        self.geometry = dict(n_tiles=self.tiles_x * self.tiles_y,
                             tiles_x=self.tiles_x, tile_w=cfg.tw, tile_h=cfg.th)

    def _leaves(self):
        return [getattr(self.params, k) for k in PARAM_NAMES] + [self.offset]

    def loss(self):
        out = render(self.params, self.camera, active_sh_degree=self.sh_degree,
                     bg_color=self.bg, cfg=self.cfg, alive=self.aux.alive,
                     mean2d_offset=self.offset)
        return l1_loss(out.image, self.gt)

    def fwd_bwd(self):
        return torch.autograd.grad(self.loss(), self._leaves())

    def fwd_only(self):
        with torch.no_grad():
            return self.loss()

    def _preprocess(self):
        p = self.params
        return preprocess(
            xyz=p.xyz, sh=p.get_features(), opacity=p.get_opacity(),
            scaling=p.get_scaling(), rotation=p.rotation, camera=self.camera,
            active_sh_degree=self.sh_degree, scaling_modifier=1.0,
            mean2d_offset=self.offset, alive=self.aux.alive,
        )

    def preprocess(self):
        with torch.no_grad():
            return self._preprocess()

    def preprocess_fwd_bwd(self):
        pr = self._preprocess()
        total = (pr.mean_pix.sum() + pr.conic.sum() + pr.rgb.sum()
                 + pr.opacity.sum() + pr.depth.sum())
        return torch.autograd.grad(total, self._leaves(), allow_unused=True)

    def binning(self, proj):
        with torch.no_grad():
            return depth_sorted_bins(proj, self.camera, self.cfg)

    def build_inst(self, fields, binning):
        with torch.no_grad():
            return build_inst_data(fields, binning.sorted_owner)

    def composite_fwd(self, inst, tile_start):
        return kernels.composite_forward(inst, tile_start, **self.geometry)

    def cotangent(self, tile_color, tile_t):
        return composite_cotangent(torch.ones_like(tile_color),
                                   torch.ones_like(tile_t), tile_color, tile_t)

    def composite_bwd(self, inst, tile_start, cot):
        return kernels.composite_backward(inst, tile_start, cot, **self.geometry)

    def grad_reduction(self, inst_grads, binning):
        return owner_sums(inst_grads, binning.sorted_slot, binning.gm_start)

    def image(self, tile_color, tile_t):
        color, trans = untile_image(
            tile_color, tile_t, self.camera.height, self.camera.width,
            self.tiles_x, self.tiles_y, self.cfg.tw, self.cfg.th)
        return color + trans[None, :, :] * self.bg[:, None, None]


def profile(stages: Stages, iters: int = ITERS,
            device_reps: int = DEVICE_REPS) -> dict:
    """Every stage's event and device time, and the instance counts."""
    proj = stages.preprocess()
    fields, binning = stages.binning(proj)
    inst = stages.build_inst(fields, binning)
    ts = binning.tile_start
    tile_color, tile_t = stages.composite_fwd(inst, ts)
    cot = stages.cotangent(tile_color, tile_t)
    inst_grads = stages.composite_bwd(inst, ts, cot)
    table = [
        ("FULL fwd+bwd step", stages.fwd_bwd),
        ("FULL fwd only", stages.fwd_only),
        ("preprocess (fwd)", stages.preprocess),
        ("preprocess fwd+bwd", stages.preprocess_fwd_bwd),
        ("binning", lambda: stages.binning(proj)),
        ("permute+build_inst_data", lambda: stages.build_inst(fields, binning)),
        ("composite fwd kernel", lambda: stages.composite_fwd(inst, ts)),
        ("composite bwd kernel", lambda: stages.composite_bwd(inst, ts, cot)),
        ("grad reduction", lambda: stages.grad_reduction(inst_grads, binning)),
    ]
    rows = []
    for name, fn in table:
        event = cuda_ms(fn, iters, warmup=1)
        kernels_per_run = len(device_event_names(whole_profile(fn)))
        rows.append(with_refused({"stage": name, "event_ms": event,
                                  "device_ms": device_ms(fn, None, device_reps),
                                  "device_kernels": kernels_per_run}))
    return {"stages": rows, "rect_instances": int(binning.num_instances),
            "budget": stages.cfg.max_instances, "live_instances": int(ts[-1])}


PROBE_BUDGET = 2 ** 22


def ply_scene(path: str, orbit: float = 0.6, width: int = WIDTH,
              height: int = HEIGHT, device=None, probe_budget: int = PROBE_BUDGET,
              tile_w: int = TILE, tile_h: int = TILE):
    """(params, aux, camera, cfg, sh_degree) of a model PLY seen from the
    trained-scene orbit camera: capacity the next power of two (at least
    1024), budgets pow2_budget of the view's pair and row counts with 3 %
    headroom, measured by one render at `probe_budget`."""
    dev = resolve_device(device)
    params, aux = load_ply_model(path, device=dev)
    sh_degree = params.max_sh_degree
    camera = trained_orbit_camera(orbit, width, height, device=dev)
    probe_cfg = RasterConfig(tile_w=tile_w, tile_h=tile_h, max_instances=probe_budget,
                             max_rows=probe_budget)
    with torch.no_grad():
        probe = render(params, camera, active_sh_degree=sh_degree,
                       bg_color=torch.zeros(3, device=dev), cfg=probe_cfg,
                       alive=aux.alive)
    cfg = RasterConfig(tile_w=tile_w, tile_h=tile_h,
                       max_instances=pow2_budget(int(probe.num_instances), 1.03),
                       max_rows=pow2_budget(int(probe.num_rows), 1.03))
    return params, aux, camera, cfg, sh_degree


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ply", default=None,
                    help="profile a trained model's PLY instead of the random scene")
    ap.add_argument("--orbit", type=float, default=0.6,
                    help="orbit angle of the --ply view (radians)")
    args = ap.parse_args(argv)
    require_card("profile_stages")
    if args.ply:
        params, aux, camera, cfg, sh_degree = ply_scene(args.ply, args.orbit)
        print(json.dumps({"ply": args.ply, "gaussians": int(aux.n_alive()),
                          "capacity": params.capacity, "sh_degree": sh_degree,
                          "orbit": args.orbit, "max_instances": cfg.max_instances,
                          "max_rows": cfg.max_rows}), flush=True)
    else:
        params, aux, camera, cfg = bench_scene()
        sh_degree = SH_DEGREE
    result = profile(Stages(params, aux, camera, cfg, sh_degree))
    print(json.dumps({"device": torch.cuda.get_device_name(0)}), flush=True)
    for row in result["stages"]:
        print(json.dumps(row), flush=True)
    print(json.dumps({k: v for k, v in result.items() if k != "stages"}), flush=True)


if __name__ == "__main__":
    main()
