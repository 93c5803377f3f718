"""Plain training step: L1 + D-SSIM loss, its gradient through the plain
render, and Adam (published train.py, utils/loss_utils.py,
scene/gaussian_model.py training_setup / update_learning_rate).

The SSIM window (11 taps, sigma 1.5, zero padding) runs as two products
with banded matrices, the separable form of the published depthwise
convolution.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gsbench.reference import render as ref_render

BETA1, BETA2, EPS = 0.9, 0.999, 1e-15
C1, C2 = 0.01**2, 0.03**2


def window_matrix(n: int, size: int = 11, sigma: float = 1.5, device=None) -> torch.Tensor:
    """[n, n] banded matrix of the normalized Gaussian window: a product
    with it is the zero-padded 1-D convolution."""
    xs = np.arange(size, dtype=np.float64)
    g = np.exp(-((xs - size // 2) ** 2) / (2.0 * sigma**2))
    g = (g / g.sum()).astype(np.float32)
    m = np.zeros((n, n), np.float32)
    for off in range(size):
        d = off - size // 2
        idx = np.arange(max(0, -d), min(n, n - d))
        m[idx, idx + d] = g[off]
    return torch.as_tensor(m, device=device)


def ssim(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Mean SSIM of two [3, H, W] images (utils/loss_utils.py ssim)."""
    h, w = img1.shape[1:]
    gh = window_matrix(h, device=img1.device)
    gw = window_matrix(w, device=img1.device)

    def blur(x):
        return gh @ x @ gw.T

    mu1, mu2 = blur(img1), blur(img2)
    s1 = blur(img1 * img1) - mu1 * mu1
    s2 = blur(img2 * img2) - mu2 * mu2
    s12 = blur(img1 * img2) - mu1 * mu2
    m = ((2.0 * mu1 * mu2 + C1) * (2.0 * s12 + C2)) / (
        (mu1 * mu1 + mu2 * mu2 + C1) * (s1 + s2 + C2))
    return m.mean()


def loss_of(image: torch.Tensor, gt: torch.Tensor, lambda_dssim: float) -> torch.Tensor:
    """(1 - lambda) L1 + lambda (1 - SSIM) (train.py)."""
    l1 = torch.abs(image - gt).mean()
    return (1.0 - lambda_dssim) * l1 + lambda_dssim * (1.0 - ssim(image, gt))


def expon_lr(step: int, lr_init: float, lr_final: float, max_steps: int) -> float:
    """get_expon_lr_func without the delay (utils/general_utils.py)."""
    if step < 0 or (lr_init == 0.0 and lr_final == 0.0):
        return 0.0
    t = min(max(step / max_steps, 0.0), 1.0)
    return math.exp(math.log(lr_init) * (1.0 - t) + math.log(lr_final) * t)


def learning_rates(opt: dict, spatial_lr_scale: float, step: int) -> dict[str, float]:
    """Per-group rates (training_setup), the position rate on its schedule
    read at the step counter before the step."""
    return {
        "xyz": expon_lr(step, opt["position_lr_init"] * spatial_lr_scale,
                        opt["position_lr_final"] * spatial_lr_scale,
                        opt["position_lr_max_steps"]),
        "features_dc": opt["feature_lr"],
        "features_rest": opt["feature_lr"] / 20.0,
        "scaling": opt["scaling_lr"],
        "rotation": opt["rotation_lr"],
        "opacity": opt["opacity_lr"],
    }


def step(state: dict, cam: ref_render.Cam, gt: torch.Tensor, bg: torch.Tensor,
         degree: int, opt: dict, spatial_lr_scale: float,
         half: bool = False) -> tuple[float, dict]:
    """One step on one view. state: {params, mu, nu: {name: tensor},
    count, step: int}, updated in place. Returns (loss, gradients). With
    `half` the loss leaves out the right half of the image (a fault the
    output check must catch)."""
    params = {k: v.detach().requires_grad_(True) for k, v in state["params"].items()}
    frame = ref_render.render(params, cam, bg, degree)
    image = frame.image.requires_grad_(True)
    cols = image.shape[-1] // 2 if half else image.shape[-1]
    loss = loss_of(image[..., :cols], gt[..., :cols], opt["lambda_dssim"])
    (g_image,) = torch.autograd.grad(loss, [image])
    ref_render.backward(params, cam, bg, degree, g_image)
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p)) for k, p in params.items()}
    lrs = learning_rates(opt, spatial_lr_scale, state["step"])
    t = state["count"] + 1
    bc1, bc2 = 1.0 - BETA1**t, 1.0 - BETA2**t
    with torch.no_grad():
        for k, g in grads.items():
            m = state["mu"][k].mul_(BETA1).add_((1.0 - BETA1) * g)
            v = state["nu"][k].mul_(BETA2).add_((1.0 - BETA2) * g * g)
            state["params"][k] = state["params"][k] - lrs[k] * (m / bc1) / (
                torch.sqrt(v / bc2) + EPS)
    state["count"] = t
    state["step"] += 1
    return float(loss.detach()), grads
