"""gsjax_torch preprocess against gsjax preprocess: every Projected field on
the same scene and camera (floats at rtol 1e-5, the integer radius exact),
including the alive mask, color/covariance overrides and the scaling
modifier. The atol of 1e-7 covers entries near zero that come out of a
cancellation (the conic's off-diagonal)."""

from __future__ import annotations

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsjax.render.api as japi
import gsjax_torch.render.api as tapi
from gsjax.config import padded_image_shape as jpadded_image_shape
from gsjax.core.transforms import build_covariance
from gsjax.render.preprocess import compute_cov2d as jcompute_cov2d
from gsjax.render.preprocess import preprocess as jax_preprocess
from gsjax_torch.config import padded_image_shape
from tests.scene_utils import look_at_origin_camera, orbit_camera, random_scene
from tests.torch_parity import n, t, to_torch_camera, to_torch_params

# The module: the package's name `preprocess` is the function, as gsjax's.
tpre = importlib.import_module("gsjax_torch.render.preprocess")

torch.set_num_threads(1)
W, H = 64, 48
FIELDS = ("mean_ndc", "mean_pix", "depth", "conic", "rgb", "opacity", "ext", "qmax")


@pytest.fixture(scope="module")
def scene():
    params, aux = random_scene(200, seed=0)
    return params, aux, to_torch_params(params)


def _run(jparams, tparams, jcam, **kw):
    """Both preprocesses on the same inputs; kw holds numpy overrides."""
    def args(p, conv):
        return dict(
            xyz=p.xyz, sh=p.get_features(), opacity=p.get_opacity(),
            scaling=p.get_scaling(), rotation=p.rotation,
            active_sh_degree=3,
            **{k: conv(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()},
        )
    a = jax_preprocess(camera=jcam, **args(jparams, jnp.asarray))
    with torch.no_grad():
        b = tpre.preprocess(camera=to_torch_camera(jcam), **args(tparams, t))
    return a, b


def _same(a, b):
    for f in FIELDS:
        np.testing.assert_allclose(
            n(getattr(b, f)), np.asarray(getattr(a, f)), rtol=1e-5, atol=1e-7,
            err_msg=f,
        )
    np.testing.assert_array_equal(n(b.radius), np.asarray(a.radius))
    assert b.radius.dtype == torch.int32


def _cases(jparams, aux):
    rng = np.random.default_rng(1)
    cap = jparams.capacity
    half = np.asarray(aux.alive) & (np.arange(cap) < 100)
    cov = np.asarray(build_covariance(jparams.get_scaling(), 1.0, jparams.rotation))
    return {
        "plain": (look_at_origin_camera(W, H), {}),
        "orbit": (orbit_camera(0.7, width=W, height=H), {}),
        "alive_half": (look_at_origin_camera(W, H), {"alive": half}),
        "scaling_modifier": (look_at_origin_camera(W, H), {"scaling_modifier": 1.7}),
        "rgb_precomp": (
            look_at_origin_camera(W, H),
            {"rgb_precomp": rng.uniform(0, 1, (cap, 3)).astype(np.float32)},
        ),
        "cov3d_precomp": (look_at_origin_camera(W, H), {"cov3d_precomp": cov}),
        "mean2d_offset": (
            look_at_origin_camera(W, H),
            {"mean2d_offset": rng.normal(0, 0.01, (cap, 2)).astype(np.float32)},
        ),
    }


CASES = ("plain", "orbit", "alive_half", "scaling_modifier", "rgb_precomp",
         "cov3d_precomp", "mean2d_offset")


@pytest.mark.parametrize("case", CASES)
def test_projected_fields_match_gsjax(scene, case):
    jparams, aux, tparams = scene
    cam, kw = _cases(jparams, aux)[case]
    a, b = _run(jparams, tparams, cam, **kw)
    _same(a, b)
    if case == "plain":
        assert int((b.radius > 0).sum()) > 50  # the scene is on screen


def test_dead_slots_are_invisible(scene):
    jparams, aux, tparams = scene
    cam = look_at_origin_camera(W, H)
    _, b = _run(jparams, tparams, cam, alive=np.zeros(jparams.capacity, bool))
    assert int(b.radius.abs().sum()) == 0
    assert float(b.ext.abs().sum()) == 0.0


def test_mark_visible_matches_gsjax(scene):
    jparams, _, tparams = scene
    cam = orbit_camera(2.0, width=W, height=H)
    np.testing.assert_array_equal(
        n(tapi.mark_visible(tparams.xyz, to_torch_camera(cam))),
        np.asarray(japi.mark_visible(jparams.xyz, cam)),
    )


def test_compute_cov2d_matches_gsjax(scene):
    """The public EWA projection on the scene's covariances at seeded
    view-space points, some far enough off axis that the frustum clamp
    acts."""
    jparams, _, _ = scene
    cam = look_at_origin_camera(W, H)
    cov = np.asarray(build_covariance(jparams.get_scaling(), 1.0, jparams.rotation))
    rng = np.random.default_rng(2)
    z = rng.uniform(0.3, 5.0, len(cov))
    p_view = np.stack([rng.uniform(-2, 2, len(cov)) * z, rng.uniform(-2, 2, len(cov)) * z,
                       z], axis=1).astype(np.float32)
    want = np.asarray(jcompute_cov2d(jnp.asarray(cov), jnp.asarray(p_view), cam))
    got = tpre.compute_cov2d(t(cov), t(p_view), to_torch_camera(cam))
    assert got.shape == (len(cov), 3) and got.dtype == torch.float32
    np.testing.assert_allclose(n(got), want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("shape", [(48, 64, 16), (1080, 1920, 16), (1080, 1920, 32),
                                   (400, 400, 64), (1, 1, 8), (33, 17, 8)])
def test_padded_image_shape_matches_gsjax(shape):
    assert padded_image_shape(*shape) == jpadded_image_shape(*shape)
