"""gsjax_torch render (CPU: the plain versions of its kernels) against
gsjax render (Pallas kernels in interpret mode) and gsjax's O(N*pixels)
oracle, on the same scene: images at atol 2e-3 / rtol 1e-3 as
tests/test_renderer.py holds the kernels, the fast forward within 4e-3."""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsjax.render.api as japi
import gsjax_torch.render.api as tapi
from gsjax.config import RasterConfig as JaxRasterConfig
from gsjax_torch.config import RasterConfig
from gsjax_torch.render import kernels
from gsjax_torch.render.oracle import composite_oracle
from gsjax_torch.render.preprocess import preprocess
from tests.scene_utils import look_at_origin_camera, orbit_camera, random_scene
from tests.torch_parity import n, to_torch_camera, to_torch_params

torch.set_num_threads(1)
W, H = 64, 48
BG = [0.2, 0.3, 0.4]
CFG = RasterConfig(tile_size=16, max_instances=1 << 14)
JAX_CFG = JaxRasterConfig(tile_size=16, max_instances=1 << 14, interpret=True)


@pytest.fixture(scope="module")
def scene():
    params, aux = random_scene(200, seed=0)
    cam = look_at_origin_camera(W, H)
    oracle = np.asarray(japi.render_oracle(
        params, cam, active_sh_degree=3, bg_color=jnp.array(BG), alive=aux.alive,
    ))
    return dict(
        jparams=params, jaux=aux, jcam=cam, oracle=oracle,
        params=to_torch_params(params), alive=torch.as_tensor(np.array(aux.alive)),
        cam=to_torch_camera(cam),
    )


def _render(s, cfg=CFG, cam=None, params=None, **kw):
    kw.setdefault("alive", s["alive"])
    with torch.no_grad():
        return tapi.render(
            s["params"] if params is None else params,
            s["cam"] if cam is None else cam,
            active_sh_degree=3, bg_color=torch.tensor(BG), cfg=cfg, **kw,
        )


def _close(img, want, atol=2e-3):
    assert img.shape == want.shape
    np.testing.assert_allclose(n(img), want, atol=atol, rtol=1e-3)


def test_render_matches_gsjax_render_and_oracle(scene):
    jout = japi.render(
        scene["jparams"], scene["jcam"], active_sh_degree=3,
        bg_color=jnp.array(BG), cfg=JAX_CFG, alive=scene["jaux"].alive,
    )
    out = _render(scene)
    _close(out.image, np.asarray(jout.image))
    _close(out.image, scene["oracle"])
    assert int(out.num_instances) == int(jout.num_instances) > 0
    assert int(out.num_rows) == int(jout.num_rows)
    np.testing.assert_array_equal(n(out.radii), np.asarray(jout.radii))


def test_port_oracle_matches_gsjax_oracle(scene):
    img = tapi.render_oracle(
        scene["params"], scene["cam"], active_sh_degree=3,
        bg_color=torch.tensor(BG), alive=scene["alive"],
    )
    np.testing.assert_allclose(n(img), scene["oracle"], atol=1e-5)


@pytest.mark.parametrize(
    "cfg",
    [
        RasterConfig(tile_w=32, tile_h=16, max_instances=1 << 14),
        RasterConfig(tile_w=32, tile_h=16, strips=2, max_instances=1 << 14),
        RasterConfig(tile_size=16, strips=4, chunk=64, max_instances=1 << 14),
    ],
    ids=["32x16", "32x16_strips2", "16x16_strips4_chunk64"],
)
def test_tile_shapes_and_strips_match_oracle(scene, cfg):
    _close(_render(scene, cfg).image, scene["oracle"])


def test_fast_fwd_close_to_oracle(scene):
    img = n(_render(scene, dataclasses.replace(CFG, fast_fwd=True)).image)
    assert np.abs(img - scene["oracle"]).max() < 4e-3


def test_orbit_view_matches_gsjax_oracle(scene):
    jcam = orbit_camera(0.7, width=W, height=H)
    want = np.asarray(japi.render_oracle(
        scene["jparams"], jcam, active_sh_degree=3, bg_color=jnp.array(BG),
        alive=scene["jaux"].alive,
    ))
    _close(_render(scene, cam=to_torch_camera(jcam)).image, want)


def test_background_only_and_all_dead(scene):
    bg = np.broadcast_to(np.asarray(BG, np.float32)[:, None, None], (3, H, W))
    far = to_torch_params(scene["jparams"])
    with torch.no_grad():
        far.xyz -= torch.tensor([0.0, 0.0, 50.0])
    out = _render(scene, params=far)
    np.testing.assert_allclose(n(out.image), bg, atol=1e-6)
    assert int((out.radii > 0).sum()) == 0
    dead = _render(scene, alive=torch.zeros_like(scene["alive"]))
    np.testing.assert_allclose(n(dead.image), bg, atol=1e-6)
    assert int(dead.num_instances) == 0


def test_alive_half_and_outside_paths(scene):
    half = scene["alive"] & (torch.arange(scene["params"].capacity) < 100)
    proj = preprocess(
        xyz=scene["params"].xyz, sh=scene["params"].get_features(),
        opacity=scene["params"].get_opacity(),
        scaling=scene["params"].get_scaling(),
        rotation=scene["params"].rotation, camera=scene["cam"],
        active_sh_degree=3, alive=half,
    )
    want = n(composite_oracle(proj, scene["cam"], torch.tensor(BG)).detach())
    _close(_render(scene, alive=half).image, want)
    base = n(_render(scene).image)
    for kw in (dict(compute_cov3d_outside=True), dict(convert_shs_outside=True)):
        np.testing.assert_allclose(n(_render(scene, **kw).image), base, atol=1e-5)
    red = torch.zeros((scene["params"].capacity, 3))
    red[:, 0] = 1.0
    img = n(_render(scene, override_color=red).image)
    # All-red splats: green = T * bg_g and red = (1 - T) + T * bg_r (the
    # applied weights sum to 1 - T).
    trans = img[1] / BG[1]
    assert trans.min() < 0.5
    np.testing.assert_allclose(img[0], 1.0 - trans + trans * BG[0], atol=1e-5)
    np.testing.assert_allclose(img[2], trans * BG[2], atol=1e-5)


def test_composite_backward_raises(scene):
    """fast_fwd is inference-only: differentiating such a render raises, as
    gsjax's does (tests/test_renderer.py::test_fast_fwd_close_to_exact_and_guarded)."""
    params = to_torch_params(scene["jparams"])
    out = tapi.render(
        params, scene["cam"], active_sh_degree=3, bg_color=torch.tensor(BG),
        cfg=dataclasses.replace(CFG, fast_fwd=True), alive=scene["alive"],
    )
    with pytest.raises(ValueError, match="fast_fwd"):
        out.image.sum().backward()


def test_cpu_render_runs_the_plain_versions(scene):
    kernels.reset_launch_counts()
    _render(scene)
    assert all(v == 0 for v in kernels.launch_counts.values())


@pytest.mark.parametrize("width", kernels.GATHER_WIDTHS)
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_row_gather_routes_cpu_tensors_to_index_select(width, dtype):
    """On CPU tensors the render path's row gather is index_select, with no
    launch counted."""
    gen = torch.Generator().manual_seed(width)
    src = torch.randn((300, width), generator=gen)
    idx = torch.randint(0, 300, (517,), generator=gen).to(dtype)
    kernels.reset_launch_counts()
    got = kernels.row_gather(src, idx)
    assert kernels.launch_counts["row_gather"] == 0
    assert torch.equal(got, src.index_select(0, idx.long()))
    assert torch.equal(kernels.row_gather_plain(src, idx), got)


@pytest.mark.parametrize("case", ["width", "index_dtype"])
def test_row_gather_rejects_other_widths_and_index_dtypes(case):
    """Widths outside GATHER_WIDTHS and indices other than int32 / int64
    raise on either device, as the tools' wrapper raised on the card."""
    src = torch.zeros((10, 5 if case == "width" else 16))
    idx = torch.zeros(4, dtype=torch.int32 if case == "width" else torch.int16)
    with pytest.raises(ValueError if case == "width" else TypeError, match="row_gather"):
        kernels.row_gather(src, idx)


def test_tools_row_gather_is_the_render_paths():
    """The tools' row_gather names the render path's wrapper, its plain
    version and widths: one counter, render/kernels.py's."""
    from gsjax_torch.tools import kernels as tool_kernels

    assert tool_kernels.row_gather is kernels.row_gather
    assert tool_kernels.row_gather_plain is kernels.row_gather_plain
    assert tool_kernels.GATHER_WIDTHS == kernels.GATHER_WIDTHS == (1, 8, 12, 16)
    assert "row_gather" in kernels.KERNEL_NAMES
    assert "row_gather" not in tool_kernels.launch_counts
