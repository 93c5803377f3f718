"""Training losses: L1, L2 and SSIM.

SSIM: 11x11 Gaussian window, sigma 1.5, per-channel (depthwise)
convolution with zero padding, C1 = 0.01^2, C2 = 0.03^2 (reference:
utils/loss_utils.py:23-63). The window runs as two separable slice-FMA
passes in f32, as `gsjax.train.loss` writes it, and through no convolution
library: a float32 convolution on the card goes through cuDNN in TF32 by
default, which would change the loss.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def l1_loss(output: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """(reference: utils/loss_utils.py:17-18)"""
    return torch.mean(torch.abs(output - gt))


def l2_loss(output: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """(reference: utils/loss_utils.py:20-21)"""
    return torch.mean((output - gt) ** 2)


@functools.lru_cache(maxsize=4)
def _gaussian_taps(window_size: int, sigma: float) -> tuple[float, ...]:
    """Normalized 1-D Gaussian taps, computed in float64 and rounded to
    float32 (reference: utils/loss_utils.py:23-31; the reference's 2-D
    window is their outer product)."""
    xs = np.arange(window_size, dtype=np.float64)
    g = np.exp(-((xs - window_size // 2) ** 2) / (2.0 * sigma**2))
    g /= g.sum()
    return tuple(float(v) for v in g.astype(np.float32))


def _depthwise_conv(
    img: torch.Tensor, taps, pad: int, pad_h: bool = True
) -> torch.Tensor:
    """[C,H,W] zero-padded depthwise conv of the separable window: a row
    pass then a column pass, each a chain of shifted slices times a tap
    (the 2-D kernel is outer(g, g), so this is the same linear map).

    pad_h=False runs the column pass in VALID mode (output H = input H -
    2*pad): the caller supplies its own pad halo rows top and bottom, as the
    tile-sharded loss does with its neighbours' rows."""
    k = len(taps)
    h, w = img.shape[-2], img.shape[-1]
    xp = F.pad(img, (pad, pad))
    row = taps[0] * xp[:, :, 0:w]
    for i in range(1, k):
        row = row + taps[i] * xp[:, :, i:i + w]
    if pad_h:
        rp, h_out = F.pad(row, (0, 0, pad, pad)), h
    else:
        rp, h_out = row, h - 2 * pad
    out = taps[0] * rp[:, 0:h_out, :]
    for i in range(1, k):
        out = out + taps[i] * rp[:, i:i + h_out, :]
    return out


def _ssim_terms(img1, img2, window_size, sigma, pad_h=True):
    """Window means and the four SSIM factor maps A, B, C, D with
    S = A B / (C D) (the reference's fraction, utils/loss_utils.py:52-63)."""
    window = _gaussian_taps(window_size, sigma)
    pad = window_size // 2
    mu1 = _depthwise_conv(img1, window, pad, pad_h)
    mu2 = _depthwise_conv(img2, window, pad, pad_h)
    e1 = _depthwise_conv(img1 * img1, window, pad, pad_h)
    e2 = _depthwise_conv(img2 * img2, window, pad, pad_h)
    e12 = _depthwise_conv(img1 * img2, window, pad, pad_h)
    c1 = 0.01**2
    c2 = 0.03**2
    a = 2.0 * mu1 * mu2 + c1
    b = 2.0 * (e12 - mu1 * mu2) + c2
    c = mu1 * mu1 + mu2 * mu2 + c1
    d = (e1 - mu1 * mu1) + (e2 - mu2 * mu2) + c2
    return mu1, mu2, a, b, c, d


class _SSIMMap(torch.autograd.Function):
    """S = A B / (C D) with a closed-form backward through the window.

    With G the window conv (self-adjoint: symmetric taps, zero padding),
    p = u B/(CD), q = u A/(CD), r = -q B/C, t = -q B/D:
      d_img1 = G(2(mu2 (p-q) + mu1 (r-t))) + 2 img1 G(t) + img2 G(2q)
      d_img2 = G(2(mu1 (p-q) + mu2 (r-t))) + 2 img2 G(t) + img1 G(2q)
    With pad_h=False the column pass is VALID over the caller's halo rows;
    its adjoint is the same conv of the cotangent zero-padded by pad rows
    (a FULL conv, the taps being symmetric).
    """

    @staticmethod
    def forward(ctx, img1, img2, window_size, sigma, pad_h):
        mu1, mu2, a, b, c, d = _ssim_terms(img1, img2, window_size, sigma, pad_h)
        ctx.window = (window_size, sigma, pad_h)
        ctx.save_for_backward(img1, img2, mu1, mu2, a, b, c, d)
        return (a * b) / (c * d)

    @staticmethod
    def backward(ctx, u):
        img1, img2, mu1, mu2, a, b, c, d = ctx.saved_tensors
        window_size, sigma, pad_h = ctx.window
        window = _gaussian_taps(window_size, sigma)
        pad = window_size // 2

        def gstar(y):
            if not pad_h:
                y = F.pad(y, (0, 0, pad, pad))
            return _depthwise_conv(y, window, pad)

        inv_cd = 1.0 / (c * d)
        p = u * b * inv_cd
        q = u * a * inv_cd
        qb = q * b
        r = -qb / c
        t = -qb / d
        pq = p - q
        rt = r - t
        g_mu1 = 2.0 * (mu2 * pq + mu1 * rt)
        g_mu2 = 2.0 * (mu1 * pq + mu2 * rt)
        gt = gstar(t)
        gq2 = gstar(2.0 * q)
        d1 = gstar(g_mu1) + 2.0 * img1 * gt + img2 * gq2
        d2 = gstar(g_mu2) + 2.0 * img2 * gt + img1 * gq2
        return d1, d2, None, None, None


def ssim_map(
    img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
    sigma: float = 1.5, pad_h: bool = True,
) -> torch.Tensor:
    """Per-pixel SSIM map of a [C,H,W] pair (reference:
    utils/loss_utils.py:43-63). With pad_h=False the inputs carry
    window_size//2 halo rows top and bottom, and the map covers only the
    interior rows (what the whole image's map holds for those rows)."""
    return _SSIMMap.apply(img1, img2, window_size, sigma, pad_h)


def ssim(
    img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
    sigma: float = 1.5,
) -> torch.Tensor:
    """Mean SSIM over a [C,H,W] image pair (reference:
    utils/loss_utils.py:33-63)."""
    return torch.mean(ssim_map(img1, img2, window_size, sigma))
