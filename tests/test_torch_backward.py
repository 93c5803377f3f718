"""The port's backward against gsjax's, on the CPU.

- The plain composite backward (render/tiled.py) against gsjax's
  composite_backward_pallas in interpret mode, on identical instance rows,
  ranges and cotangents taken from gsjax's own binning of the scene
  (transposed at the boundary: gsjax keeps (16, P), the port (P, 16)).
- The plain segment sum against segment_sum_pallas in interpret mode.
- permute_rows' backward against index_select's.
- The port's render gradients (all six raw parameters and mean2d_offset)
  against gsjax's jax.grad of render (Pallas, interpret) and of
  render_oracle, scaled by max|g| at atol 5e-3 as tests/test_renderer.py
  holds gsjax's own kernels.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsjax.render.api as japi
import gsjax_torch.render.api as tapi
from gsjax.config import RasterConfig as JaxRasterConfig
from gsjax.render.binning import bin_gaussians, depth_order, num_tiles
from gsjax.render.common import ROW_MX, ROW_MY, ROW_OP, build_inst_data
from gsjax.render.composite import pack_fields
from gsjax.render.pallas_kernels import (
    composite_backward_pallas,
    segment_sum_pallas,
)
from gsjax.render.preprocess import preprocess
from gsjax_torch.config import RasterConfig
from gsjax_torch.model import PARAM_NAMES
from gsjax_torch.render import kernels
from gsjax_torch.render.binning import permute_rows
from tests.scene_utils import look_at_origin_camera, random_scene
from tests.torch_parity import n, scaled_close, t, to_torch_camera, to_torch_params

torch.set_num_threads(1)
W, H = 64, 48
BG = [0.2, 0.3, 0.4]
CFG16 = RasterConfig(tile_size=16, max_instances=1 << 14)
JAX_CFG16 = JaxRasterConfig(tile_size=16, max_instances=1 << 14, interpret=True)
GRAD_NAMES = (*PARAM_NAMES, "mean2d_offset")


@pytest.fixture(scope="module")
def scene():
    params, aux = random_scene(200, seed=0)
    cam = look_at_origin_camera(W, H)
    return dict(
        jparams=params, jaux=aux, jcam=cam, params=to_torch_params(params),
        alive=torch.as_tensor(np.array(aux.alive)), cam=to_torch_camera(cam),
    )


def _jax_grads(loss_fn, params, capacity):
    g, g_off = jax.grad(loss_fn, (0, 1))(params, jnp.zeros((capacity, 2)))
    out = {k: np.asarray(getattr(g, k)) for k in PARAM_NAMES}
    out["mean2d_offset"] = np.asarray(g_off)
    return out


@pytest.fixture(scope="module")
def jax_grads(scene):
    """gsjax's gradients of mean((image)^2): render (Pallas interpret,
    16x16 tiles) and render_oracle."""
    p, aux, cam = scene["jparams"], scene["jaux"], scene["jcam"]
    bg = jnp.array(BG)

    def loss_render(q, off):
        img = japi.render(q, cam, active_sh_degree=3, bg_color=bg, cfg=JAX_CFG16,
                          alive=aux.alive, mean2d_offset=off).image
        return jnp.mean(img ** 2)

    def loss_oracle(q, off):
        img = japi.render_oracle(q, cam, active_sh_degree=3, bg_color=bg,
                                 alive=aux.alive, mean2d_offset=off)
        return jnp.mean(img ** 2)

    return dict(
        render=_jax_grads(loss_render, p, p.capacity),
        oracle=_jax_grads(loss_oracle, p, p.capacity),
    )


def _port_grads(scene, cfg, alive=None):
    params = scene["params"]
    off = torch.zeros((params.capacity, 2), requires_grad=True)
    img = tapi.render(
        params, scene["cam"], active_sh_degree=3, bg_color=torch.tensor(BG),
        cfg=cfg, alive=scene["alive"] if alive is None else alive,
        mean2d_offset=off,
    ).image
    leaves = [getattr(params, k) for k in PARAM_NAMES] + [off]
    grads = torch.autograd.grad(torch.mean(img ** 2), leaves)
    return {k: n(g) for k, g in zip(GRAD_NAMES, grads)}


@pytest.fixture(scope="module")
def kernel_inputs(scene):
    """gsjax's instance stream (16, P), tile ranges and a cotangent for the
    scene at 16x16 tiles, with one instance moved onto a pixel center at
    opacity 1: its alpha there is capped at 0.99 (the straight-through
    case)."""
    p, aux, cam = scene["jparams"], scene["jaux"], scene["jcam"]
    proj = preprocess(
        xyz=p.xyz, sh=p.get_features(), opacity=p.get_opacity(),
        scaling=p.get_scaling(), rotation=p.rotation, camera=cam,
        active_sh_degree=3, alive=aux.alive,
    )
    perm = depth_order(proj.depth)
    fields = jnp.take(pack_fields(proj.mean_pix, proj.conic, proj.rgb,
                                  proj.opacity), perm, axis=0)
    binning = bin_gaussians(
        fields[:, 0:2], proj.depth, jnp.take(proj.ext, perm, axis=0),
        fields[:, 2:5], jnp.take(proj.qmax, perm, axis=0), H, W, JAX_CFG16,
        perm=perm,
    )
    inst = np.array(build_inst_data(fields, binning.sorted_owner))  # (16, P)
    tile_start = np.asarray(binning.tile_start)
    tiles_x, tiles_y = num_tiles(H, W, 16)
    geo = dict(n_tiles=tiles_x * tiles_y, tiles_x=tiles_x, tile_w=16, tile_h=16)
    # The busiest tile's first instance sits on the tile's first pixel.
    busiest = int(np.argmax(np.diff(tile_start)))
    k = int(tile_start[busiest])
    inst[ROW_MX, k] = float((busiest % tiles_x) * 16)
    inst[ROW_MY, k] = float((busiest // tiles_x) * 16)
    inst[ROW_OP, k] = 1.0
    rows = t(inst.T.copy())
    color, trans = kernels.composite_forward_plain(rows, t(tile_start), **geo)
    rng = np.random.default_rng(7)
    d_color = rng.standard_normal((geo["n_tiles"], 256, 3)).astype(np.float32)
    d_t = rng.standard_normal((geo["n_tiles"], 256)).astype(np.float32)
    suffix0 = (d_color * n(color)).sum(-1) + d_t * n(trans)
    cot = np.concatenate([d_color, suffix0[..., None]], axis=-1)  # (T, PIX, 4)
    return dict(rows=rows, tile_start=tile_start, cot=cot, geo=geo, capped=k)


def test_plain_composite_backward_matches_pallas(kernel_inputs):
    ki = kernel_inputs
    want = np.asarray(composite_backward_pallas(
        jnp.asarray(n(ki["rows"]).T), jnp.asarray(ki["tile_start"]),
        jnp.asarray(np.concatenate(
            [np.swapaxes(ki["cot"], 1, 2), np.zeros((ki["cot"].shape[0], 4, 256),
                                                    np.float32)], axis=1)),
        chunk=128, interpret=True, **ki["geo"],
    )).T  # (P, 16)
    got = n(kernels.composite_backward_plain(
        ki["rows"], t(ki["tile_start"]), t(ki["cot"]), **ki["geo"]))
    assert got.shape == want.shape
    for j in range(16):
        scaled_close(got[:, j], want[:, j], what=f"grad column {j}")
    # The capped instance's opacity gradient is live (straight-through).
    assert got[ki["capped"], 8] != 0.0
    assert np.all(got[int(ki["tile_start"][-1]):] == 0.0)


def test_plain_segment_sum_matches_pallas():
    rng = np.random.default_rng(3)
    # Run lengths with empty runs and runs up to 300 slots, so that many
    # cross a 128-slot chunk boundary; 50 trailing slots belong to no run.
    lengths = rng.choice([0, 0, 1, 2, 5, 17, 130, 300], size=97)
    gm_start = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    p = int(gm_start[-1]) + 50
    # Same-sign values: the Pallas kernel sums bf16 hi/lo halves (about 17
    # mantissa bits), so rtol 1e-5 holds only without cancellation.
    vals = rng.uniform(0.5, 2.0, (p, 16)).astype(np.float32)
    want = np.asarray(segment_sum_pallas(
        jnp.asarray(vals.T), jnp.asarray(gm_start), interpret=True,
    ))[:, :97].T
    got = n(kernels.segment_sum_plain(t(vals), t(gm_start)))
    assert (lengths == 0).any() and got.shape == (97, 16)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_array_equal(got[lengths == 0], 0.0)


def test_permute_rows_backward_equals_index_select():
    rng = np.random.default_rng(4)
    x = t(rng.standard_normal((300, 12)).astype(np.float32)).requires_grad_()
    perm = t(rng.permutation(300).astype(np.int32))
    ct = t(rng.standard_normal((300, 12)).astype(np.float32))
    (got,) = torch.autograd.grad(permute_rows(x, perm), x, ct)
    (want,) = torch.autograd.grad(x.index_select(0, perm.long()), x, ct)
    assert torch.equal(got, want)


@pytest.mark.parametrize(
    "cfg",
    [
        CFG16,
        RasterConfig(tile_w=32, tile_h=16, max_instances=1 << 14),
        RasterConfig(tile_w=32, tile_h=16, strips=2, max_instances=1 << 14),
    ],
    ids=["16x16", "32x16", "32x16_strips2"],
)
def test_render_grads_match_gsjax(scene, jax_grads, cfg):
    got = _port_grads(scene, cfg)
    refs = ("render", "oracle") if cfg == CFG16 else ("oracle",)
    for ref in refs:
        for name in GRAD_NAMES:
            scaled_close(got[name], jax_grads[ref][name], what=f"{ref} {name}")
    assert np.abs(got["mean2d_offset"]).max() > 0.0


def test_dead_slots_get_zero_grads(scene):
    half = scene["alive"] & (torch.arange(scene["params"].capacity) < 100)
    got = _port_grads(scene, CFG16, alive=half)
    for name in GRAD_NAMES:
        np.testing.assert_array_equal(got[name][100:], 0.0, err_msg=name)
    assert np.abs(got["xyz"][:100]).max() > 0.0
