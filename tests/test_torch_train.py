"""The port's training modules against gsjax's, on the CPU: the losses,
the learning-rate schedule, Adam, the densification statistics, and one
whole train_step from the same carried state."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsjax.train.densify as jdensify
import gsjax.train.loss as jloss
import gsjax.train.optimizer as jopt
import gsjax.train.schedule as jschedule
import gsjax.train.step as jstep
from gsjax.config import OptimizationConfig as JaxOptimizationConfig
from gsjax.config import RasterConfig as JaxRasterConfig
from gsjax.model import GaussianAux as JaxGaussianAux
from gsjax.scene import CameraBank
from gsjax_torch.config import MCMC_FIELDS, OptimizationConfig, RasterConfig
from gsjax_torch.interop import aux_from_numpy, train_state_from_numpy
from gsjax_torch.model import PARAM_NAMES
from gsjax_torch.train import densify, loss, optimizer, schedule
from gsjax_torch.train.step import train_step
from tests.scene_utils import look_at_origin_camera, random_scene
from tests.torch_parity import (
    n,
    scaled_close,
    t,
    to_torch_camera,
    train_state_to_numpy,
)

torch.set_num_threads(1)
W, H = 64, 48
SPATIAL_LR_SCALE = 2.0


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(0)
    a = rng.uniform(0.0, 1.0, (3, H, W)).astype(np.float32)
    # A second image near the first, so SSIM sits in its working range.
    b = np.clip(a + 0.2 * rng.standard_normal((3, H, W)), 0.0, 1.0).astype(np.float32)
    return a, b


def test_l1_and_ssim_match_gsjax(images):
    a, b = images
    ta, tb = t(a).requires_grad_(), t(b).requires_grad_()
    s = loss.ssim(ta, tb)
    got = torch.autograd.grad(s, (ta, tb))
    want_val = float(jloss.ssim(jnp.asarray(a), jnp.asarray(b)))
    want = jax.grad(jloss.ssim, (0, 1))(jnp.asarray(a), jnp.asarray(b))
    # atol 1e-5: f32 window sums in another order (XLA may fuse the
    # slice-FMA chains), over maps of magnitude ~1.
    assert abs(float(s.detach()) - want_val) < 1e-5
    for g, w in zip(got, want):
        np.testing.assert_allclose(n(g), np.asarray(w), atol=1e-5)
    assert abs(float(loss.l1_loss(t(a), t(b)))
               - float(jloss.l1_loss(jnp.asarray(a), jnp.asarray(b)))) < 1e-5
    assert abs(float(loss.l2_loss(t(a), t(b)))
               - float(jloss.l2_loss(jnp.asarray(a), jnp.asarray(b)))) < 1e-5


def test_expon_lr_and_lr_tree_match_gsjax():
    cfg = OptimizationConfig()
    kw = dict(lr_init=cfg.position_lr_init * SPATIAL_LR_SCALE,
              lr_final=cfg.position_lr_final * SPATIAL_LR_SCALE,
              lr_delay_mult=cfg.position_lr_delay_mult,
              max_steps=cfg.position_lr_max_steps)
    steps = np.array([0, 1, 15_000, 30_000], np.int32)
    got = n(schedule.expon_lr(t(steps), **kw))
    want = np.asarray(jschedule.expon_lr(jnp.asarray(steps), **kw))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(
        n(schedule.expon_lr(t(steps), lr_init=1e-2, lr_final=1e-4,
                            lr_delay_steps=100, lr_delay_mult=0.1)),
        np.asarray(jschedule.expon_lr(jnp.asarray(steps), lr_init=1e-2,
                                      lr_final=1e-4, lr_delay_steps=100,
                                      lr_delay_mult=0.1)),
        rtol=1e-6,
    )
    # gsjax's fields alike; the port's own 3DGS-MCMC fields apart.
    ours = {k: v for k, v in dataclasses.asdict(cfg).items() if k not in MCMC_FIELDS}
    assert ours == dataclasses.asdict(JaxOptimizationConfig())
    for step in (1, 7000):
        got = optimizer.make_lr_tree(cfg, SPATIAL_LR_SCALE, torch.tensor(step))
        want = jopt.make_lr_tree(JaxOptimizationConfig(), SPATIAL_LR_SCALE,
                                 jnp.int32(step))
        for k in PARAM_NAMES:
            np.testing.assert_allclose(n(got[k]), np.asarray(getattr(want, k)),
                                       rtol=1e-6, err_msg=k)


def _random_tree(rng, scene_params, positive=False):
    out = {}
    for k in PARAM_NAMES:
        shape = np.asarray(getattr(scene_params, k)).shape
        v = rng.standard_normal(shape).astype(np.float32)
        out[k] = np.abs(v) * 1e-3 if positive else v
    return out


def test_adam_update_matches_gsjax():
    jparams, _ = random_scene(50, seed=2)
    rng = np.random.default_rng(5)
    grads = _random_tree(rng, jparams)
    mu = _random_tree(rng, jparams)
    nu = _random_tree(rng, jparams, positive=True)
    cfg = OptimizationConfig()
    jstate = jopt.AdamState(count=jnp.int32(4), mu=type(jparams)(**mu),
                            nu=type(jparams)(**nu))
    jlr = jopt.make_lr_tree(JaxOptimizationConfig(), 1.0, jnp.int32(5))
    want_params, want_state = jopt.adam_update(
        type(jparams)(**grads), jstate, jparams, jlr)

    state = train_state_from_numpy({
        "params": {k: np.asarray(getattr(jparams, k)) for k in PARAM_NAMES},
        "opt": {"count": 4, "mu": mu, "nu": nu},
        "aux": {"alive": np.ones(50, bool), "max_radii2d": np.zeros(50),
                "xyz_grad_accum": np.zeros(50), "denom": np.zeros(50)},
        "step": 5,
    }, "cpu")
    new = optimizer.adam_update(
        {k: t(v) for k, v in grads.items()}, state.opt, state.params,
        optimizer.make_lr_tree(cfg, 1.0, state.step))
    assert int(new.count) == int(want_state.count) == 5
    for k in PARAM_NAMES:
        # rtol 1e-6: the same f32 operations in the same order; XLA may
        # fuse a multiply-add, an ulp or two apart.
        np.testing.assert_allclose(n(new.mu[k]), np.asarray(getattr(want_state.mu, k)),
                                   rtol=1e-6, err_msg=k)
        np.testing.assert_allclose(n(new.nu[k]), np.asarray(getattr(want_state.nu, k)),
                                   rtol=1e-6, err_msg=k)
        np.testing.assert_allclose(n(getattr(state.params, k)),
                                   np.asarray(getattr(want_params, k)),
                                   rtol=1e-6, err_msg=k)


def test_add_densification_stats_matches_gsjax():
    rng = np.random.default_rng(6)
    c = 64
    jaux = JaxGaussianAux.create(c, 40).replace(
        max_radii2d=jnp.asarray(rng.uniform(0, 5, c).astype(np.float32)),
        xyz_grad_accum=jnp.asarray(rng.uniform(0, 1, c).astype(np.float32)),
        denom=jnp.asarray(rng.integers(0, 3, c).astype(np.float32)),
    )
    radii = rng.integers(0, 8, c).astype(np.int32)
    screen = rng.standard_normal((c, 2)).astype(np.float32)
    want = jdensify.add_densification_stats(jaux, jnp.asarray(radii), jnp.asarray(screen))
    aux = aux_from_numpy({k: np.asarray(getattr(jaux, k)) for k in
                          ("alive", "max_radii2d", "xyz_grad_accum", "denom")}, "cpu")
    got = densify.add_densification_stats(aux, t(radii), t(screen))
    for k in ("max_radii2d", "xyz_grad_accum", "denom"):
        np.testing.assert_allclose(n(getattr(got, k)), np.asarray(getattr(want, k)),
                                   rtol=1e-6, err_msg=k)
    assert torch.equal(got.alive, aux.alive)


def test_train_step_matches_gsjax():
    """One port step against one gsjax step from the same state: two gsjax
    steps taken first and carried across (the first Adam step moves every
    parameter by +-lr whatever the gradient's size, so a near-zero gradient
    whose sign differs between the frameworks would move it by 2 lr)."""
    _step_against_gsjax(reset=False)


def test_train_step_after_opacity_reset_matches_gsjax():
    """As test_train_step_matches_gsjax, from the carried state after
    gsjax's opacity reset (opacity clamped to 0.01, its Adam moments
    zeroed): the step that follows a reset, where the trainers' quality
    curves part (ROADMAP F3), is held to the same tolerances."""
    _step_against_gsjax(reset=True)


def _step_against_gsjax(reset: bool) -> None:
    jparams, jaux = random_scene(200, seed=0)
    cam = look_at_origin_camera(W, H)
    rng = np.random.default_rng(1)
    gt_u8 = rng.integers(0, 256, (3, H, W), dtype=np.uint8)
    bank = CameraBank.from_cameras([cam], [gt_u8], [np.full((1, H, W), 255, np.uint8)])
    jcfg = JaxRasterConfig(tile_size=16, max_instances=1 << 14, interpret=True)
    cfg = RasterConfig(tile_size=16, max_instances=1 << 14)
    opt_cfg = OptimizationConfig()
    bg = np.array([0.2, 0.3, 0.4], np.float32)
    jstate = jstep.TrainState(params=jparams, opt=jopt.adam_init(jparams),
                              aux=jaux, step=jnp.int32(1))
    kw = dict(active_sh_degree=3, opt_cfg=JaxOptimizationConfig(),
              raster_cfg=jcfg, spatial_lr_scale=SPATIAL_LR_SCALE)
    for _ in range(2):
        jstate, _ = jstep.train_step(jstate, bank, jnp.int32(0), jnp.asarray(bg), **kw)
    if reset:
        params, opt = jdensify.reset_opacity(jstate.params, jstate.opt)
        jstate = jstate.replace(params=params, opt=opt)
    carried = train_state_to_numpy(jstate)
    jstate, jm = jstep.train_step(jstate, bank, jnp.int32(0), jnp.asarray(bg), **kw)
    want = train_state_to_numpy(jstate)

    state = train_state_from_numpy(carried, "cpu")
    state, m = train_step(
        state, to_torch_camera(cam), t(gt_u8.astype(np.float32) / 255.0), t(bg),
        active_sh_degree=3, opt_cfg=opt_cfg, raster_cfg=cfg,
        spatial_lr_scale=SPATIAL_LR_SCALE,
    )
    # Loss and L1 within 1e-4: images agree within the render tolerance
    # (2e-3 per pixel), averaged over the frame.
    assert abs(float(m.loss) - float(jm.loss)) < 1e-4
    assert abs(float(m.l1) - float(jm.l1)) < 1e-4
    assert int(m.num_instances) == int(jm.num_instances)
    assert int(m.num_rows) == int(jm.num_rows)
    assert int(state.step) == int(want["step"]) == 4
    assert int(state.opt.count) == int(want["opt"]["count"]) == 3
    # Densification stats: visibility is integer-exact; the screen-space
    # gradient norms carry the gradient tolerance (5e-3 of the largest,
    # relative 1e-3 on these magnitudes).
    for k in ("max_radii2d", "denom"):
        np.testing.assert_array_equal(n(getattr(state.aux, k)), want["aux"][k])
    np.testing.assert_allclose(n(state.aux.xyz_grad_accum),
                               want["aux"]["xyz_grad_accum"], rtol=1e-3,
                               atol=1e-3 * want["aux"]["xyz_grad_accum"].max())
    lr = {k: float(v) for k, v in optimizer.make_lr_tree(
        opt_cfg, SPATIAL_LR_SCALE, t(carried["step"])).items()}
    for k in PARAM_NAMES:
        # New params within 0.25 lr of gsjax's (measured: at most 0.15 lr,
        # features_dc). gsjax's backward sums in bf16 hi/lo halves, which
        # leaves ~1e-3 of the largest gradient as a floor on the two
        # frameworks' agreement, and Adam turns an element whose gradient
        # sits near that floor into a step of order lr either way.
        np.testing.assert_allclose(n(getattr(state.params, k)), want["params"][k],
                                   atol=0.25 * lr[k], rtol=0, err_msg=k)
        # Moments, scaled by their largest entry, within the gradient
        # tolerance 5e-3: they are sums of the gradients and their squares
        # (measured: at most 1.0e-3).
        for mom in ("mu", "nu"):
            scaled_close(n(getattr(state.opt, mom)[k]), want["opt"][mom][k],
                          what=f"{mom} {k}")
