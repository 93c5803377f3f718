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
    params = to_torch_params(scene["jparams"])
    out = tapi.render(
        params, scene["cam"], active_sh_degree=3, bg_color=torch.tensor(BG),
        cfg=CFG, alive=scene["alive"],
    )
    with pytest.raises(NotImplementedError, match="training slice"):
        out.image.sum().backward()


def test_cpu_render_runs_the_plain_versions(scene):
    kernels.reset_launch_counts()
    _render(scene)
    assert all(v == 0 for v in kernels.launch_counts.values())
