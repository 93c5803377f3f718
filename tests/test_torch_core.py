"""gsjax_torch config, cameras, SH, transforms, activations and the
synthetic scene against gsjax on the same numpy inputs."""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsjax.config as jcfg
import gsjax.core.cameras as jcams
import gsjax.core.sh as jsh
import gsjax.core.transforms as jtr
import gsjax.synthetic as jsyn
import gsjax_torch.config as tcfg
import gsjax_torch.core.cameras as tcams
import gsjax_torch.core.sh as tsh
import gsjax_torch.core.transforms as ttr
import gsjax_torch.synthetic as tsyn
from gsjax_torch.model import GaussianParams
from tests.torch_parity import (
    CAMERA_FIELDS, PARAM_NAMES, n, t, to_torch_camera, to_torch_params,
)

torch.set_num_threads(1)


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(max_instances=1000),
        dict(max_rows=100),
        dict(tile_w=6, tile_h=3),
        dict(tile_size=16, strips=3),
    ],
)
def test_raster_config_rejects_what_gsjax_rejects(kwargs):
    with pytest.raises(ValueError):
        jcfg.RasterConfig(**kwargs)
    with pytest.raises(ValueError):
        tcfg.RasterConfig(**kwargs)


def test_configs_match_gsjax_fields():
    a, b = jcfg.RasterConfig(tile_w=32, tile_h=16), tcfg.RasterConfig(tile_w=32, tile_h=16)
    assert (a.tw, a.th, a.pixels_per_tile) == (b.tw, b.th, b.pixels_per_tile)
    jfields = {f.name for f in dataclasses.fields(jcfg.RasterConfig)}
    assert {f.name for f in dataclasses.fields(tcfg.RasterConfig)} == jfields - {"interpret"}
    for cls in ("ModelConfig", "PipelineConfig"):
        assert [f.name for f in dataclasses.fields(getattr(tcfg, cls))] == [
            f.name for f in dataclasses.fields(getattr(jcfg, cls))
        ]
    for peak in (10, 70_000, 1_155_281):
        assert tcfg.pow2_budget(peak) == jcfg.pow2_budget(peak)


_rng = np.random.default_rng(2)
_R = np.linalg.qr(_rng.standard_normal((3, 3)))[0].astype(np.float32)
_T = _rng.standard_normal(3).astype(np.float32)
CAMERA_CASES = {
    "create": lambda cams, syn, **dev: cams.Camera.create(
        _R, _T, 0.8, 0.6, 80, 60, **dev),
    "recentred": lambda cams, syn, **dev: cams.Camera.create(
        _R, _T, 0.8, 0.6, 80, 60, translate=np.array([0.1, -0.2, 0.3]),
        scale=1.7, **dev),
    "look_at": lambda cams, syn, **dev: syn.look_at_origin_camera(96, 64, **dev),
    "orbit": lambda cams, syn, **dev: syn.orbit_camera(
        1.1, width=96, height=64, **dev),
}


@pytest.mark.parametrize("kind", list(CAMERA_CASES))
def test_camera_matches_gsjax(kind):
    a = CAMERA_CASES[kind](jcams, jsyn)
    b = CAMERA_CASES[kind](tcams, tsyn, device="cpu")
    for f in CAMERA_FIELDS + ("focal_x", "focal_y"):
        np.testing.assert_array_equal(n(getattr(b, f)), np.asarray(getattr(a, f)), f)
    assert (a.width, a.height) == (b.width, b.height)
    np.testing.assert_array_equal(
        n(tcams.ndc_to_pixel(t([-1.0, 0.25, 1.0]), 80.0)),
        np.asarray(jcams.ndc_to_pixel(jnp.array([-1.0, 0.25, 1.0]), 80.0)),
    )


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_eval_sh_matches_gsjax(deg):
    rng = np.random.default_rng(deg)
    dirs = rng.standard_normal((257, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    sh = rng.standard_normal((257, 16, 3)).astype(np.float32)
    np.testing.assert_allclose(
        n(tsh.eval_sh(deg, t(sh), t(dirs))),
        np.asarray(jsh.eval_sh(deg, jnp.asarray(sh), jnp.asarray(dirs))),
        rtol=1e-5, atol=1e-6,
    )
    np.testing.assert_allclose(
        n(tsh.sh_basis(deg, t(dirs))), np.asarray(jsh.sh_basis(deg, jnp.asarray(dirs))),
        rtol=1e-6, atol=1e-7,
    )


def test_transforms_match_gsjax():
    rng = np.random.default_rng(5)
    q = rng.standard_normal((300, 4)).astype(np.float32)
    s = np.exp(rng.uniform(-4, 0, (300, 3))).astype(np.float32)
    x = rng.uniform(0.01, 0.99, 300).astype(np.float32)
    np.testing.assert_allclose(
        n(ttr.build_rotation(t(q))), np.asarray(jtr.build_rotation(jnp.asarray(q))),
        rtol=1e-6, atol=1e-6,
    )
    np.testing.assert_allclose(
        n(ttr.build_covariance(t(s), 1.3, t(q))),
        np.asarray(jtr.build_covariance(jnp.asarray(s), 1.3, jnp.asarray(q))),
        rtol=1e-5, atol=1e-9,
    )
    np.testing.assert_allclose(
        n(ttr.inverse_sigmoid(t(x))), np.asarray(jtr.inverse_sigmoid(jnp.asarray(x))),
        rtol=1e-6, atol=1e-7,
    )
    rgb = rng.uniform(0, 1, (10, 3)).astype(np.float32)
    np.testing.assert_allclose(
        n(tsh.RGB2SH(t(rgb))), np.asarray(jsh.RGB2SH(jnp.asarray(rgb))), rtol=1e-6
    )


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(n=200, seed=0),
        dict(n=150, capacity=256, sh_degree=1, seed=4, spread=2.5,
             scale_range=(0.004, 0.03)),
    ],
    ids=["tests_scene", "padded_deg1"],
)
def test_random_scene_and_activations_match_gsjax(kwargs):
    jp, ja = jsyn.random_scene(**kwargs)
    tp, ta = tsyn.random_scene(**kwargs, device="cpu")
    for k in PARAM_NAMES:
        a, b = np.asarray(getattr(jp, k)), n(getattr(tp, k))
        if k == "opacity":  # one f32 log on each side
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(b, a, k)
    np.testing.assert_array_equal(n(ta.alive), np.asarray(ja.alive))
    assert (tp.capacity, tp.max_sh_degree) == (jp.capacity, jp.max_sh_degree)
    # Activations on identical raw arrays.
    tp = to_torch_params(jp)
    assert isinstance(tp, GaussianParams)
    for name, rtol in (("get_scaling", 1e-6), ("get_rotation", 1e-6),
                       ("get_opacity", 1e-6), ("get_features", 0),
                       ("get_rotation_matrices", 1e-6)):
        np.testing.assert_allclose(
            n(getattr(tp, name)()), np.asarray(getattr(jp, name)()),
            rtol=rtol, atol=1e-7, err_msg=name,
        )
    cam = to_torch_camera(jsyn.orbit_camera(0.3))
    assert cam.width == 64 and cam.view.dtype == torch.float32
