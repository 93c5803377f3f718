"""The plain reference against gsjax_torch's CPU path (its kernels' plain
versions) at the scale of the repository's CPU tests: 200 Gaussians,
64x48. Images within 1e-6, losses within 1e-6 relative, gradients within
1e-5 of each parameter's largest, an Adam step the same."""

from __future__ import annotations

import pytest
import torch

from gsbench.reference import render as R
from gsbench.reference import train as RT
from gsjax_torch.config import RasterConfig
from gsjax_torch.model import GaussianParams
from gsjax_torch.render.api import render
from gsjax_torch.synthetic import look_at_origin_camera, orbit_camera, random_scene
from gsjax_torch.train.loss import l1_loss, ssim
from gsjax_torch.train.optimizer import AdamState, adam_update

torch.set_num_threads(2)
W, H = 64, 48
NAMES = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity")
CFG = RasterConfig(tile_size=16, max_instances=1 << 14, max_rows=1 << 14)
BG = torch.tensor([0.2, 0.3, 0.4])


@pytest.fixture(scope="module")
def scene():
    params, aux = random_scene(200, seed=0, device="cpu")
    return {k: getattr(params, k).detach() for k in NAMES}, aux.alive


CAMERAS = [lambda: look_at_origin_camera(W, H, device="cpu"),
           lambda: orbit_camera(0.7, width=W, height=H, device="cpu")]


def _ref_cam(cam):
    return R.Cam(cam.view, cam.full_proj, cam.cam_center, cam.tan_fovx, cam.tan_fovy, W, H)


@pytest.mark.parametrize("make_cam", CAMERAS, ids=["origin", "orbit"])
def test_image_and_counts(scene, make_cam):
    raw, alive = scene
    cam = make_cam()
    out = render(GaussianParams(**raw), cam, active_sh_degree=3, bg_color=BG, cfg=CFG, alive=alive)
    frame = R.render(raw, _ref_cam(cam), BG, 3)
    assert (out.image - frame.image).abs().max() < 1e-6
    assert 0 < frame.tile_pairs <= int(out.num_instances)
    assert frame.live_pairs > frame.tile_pairs


@pytest.mark.parametrize("make_cam", CAMERAS, ids=["origin", "orbit"])
def test_loss_and_gradients(scene, make_cam):
    raw, alive = scene
    cam = make_cam()
    gt = torch.rand((3, H, W), generator=torch.Generator().manual_seed(1))
    gp = GaussianParams(**{k: v.clone() for k, v in raw.items()})
    img = render(gp, cam, active_sh_degree=3, bg_color=BG, cfg=CFG, alive=alive).image
    loss = 0.8 * l1_loss(img, gt) + 0.2 * (1.0 - ssim(img, gt))
    grads = torch.autograd.grad(loss, [getattr(gp, k) for k in NAMES])

    leaves = {k: v.clone().requires_grad_(True) for k, v in raw.items()}
    image = R.render(leaves, _ref_cam(cam), BG, 3).image.requires_grad_(True)
    ref_loss = RT.loss_of(image, gt, 0.2)
    (g_image,) = torch.autograd.grad(ref_loss, [image])
    R.backward(leaves, _ref_cam(cam), BG, 3, g_image)
    loss, ref_loss = float(loss.detach()), float(ref_loss.detach())
    assert abs(loss - ref_loss) <= 1e-6 * abs(ref_loss)
    for k, g in zip(NAMES, grads):
        ref = leaves[k].grad
        assert (g - ref).abs().max() <= 1e-5 * ref.abs().max(), k


def test_small_tile_chunks_give_the_same_image(scene):
    raw, _ = scene
    cam = _ref_cam(orbit_camera(0.7, width=W, height=H, device="cpu"))
    whole = R.render(raw, cam, BG, 3).image
    chunked = R.render(raw, cam, BG, 3, max_elems=256 * 8).image
    assert torch.equal(whole, chunked)


def test_adam_step_matches_the_port(scene):
    raw, _ = scene
    g = torch.Generator().manual_seed(2)
    grads = {k: torch.randn(v.shape, generator=g) * 1e-3 for k, v in raw.items()}
    mu = {k: torch.randn(v.shape, generator=g) * 1e-4 for k, v in raw.items()}
    nu = {k: torch.rand(v.shape, generator=g) * 1e-6 for k, v in raw.items()}
    lrs = RT.learning_rates({"position_lr_init": 1.6e-4, "position_lr_final": 1.6e-6,
                             "position_lr_max_steps": 30000, "feature_lr": 2.5e-3,
                             "scaling_lr": 5e-3, "rotation_lr": 1e-3, "opacity_lr": 0.05},
                            4.4, 15000)
    params = GaussianParams(**{k: v.clone() for k, v in raw.items()})
    state = AdamState(count=torch.tensor(15000, dtype=torch.int32),
                      mu={k: v.clone() for k, v in mu.items()},
                      nu={k: v.clone() for k, v in nu.items()})
    adam_update(grads, state, params, {k: torch.tensor(v, dtype=torch.float32)
                                       for k, v in lrs.items()})
    for k in NAMES:
        m = mu[k] * RT.BETA1 + (1 - RT.BETA1) * grads[k]
        v = nu[k] * RT.BETA2 + (1 - RT.BETA2) * grads[k] ** 2
        t = 15001
        want = raw[k] - lrs[k] * (m / (1 - RT.BETA1**t)) / (
            torch.sqrt(v / (1 - RT.BETA2**t)) + RT.EPS)
        assert torch.allclose(getattr(params, k), want, rtol=1e-6, atol=1e-9), k
