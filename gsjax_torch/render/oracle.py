"""Naive O(N * pixels) reference rasterizer.

The executable spec for the tiled path: depth-sorted front-to-back alpha
compositing over all Gaussians for every pixel, one Gaussian per step.
Slow by construction; used by the tests and the chip smoke run at small
sizes.

Compositing semantics mirror the CUDA renderCUDA loop:
  alpha   = min(0.99, opacity * exp(-0.5 d^T conic d))    [cap]
  skip    alpha < 1/255
  done    when T * (1 - alpha) < 1e-4  (that contribution is NOT applied)
  color   = sum_i rgb_i * alpha_i * T_i  +  T_final * bg
The 0.99 cap uses a straight-through gradient (the CUDA convention).

With `tile_size` set, a Gaussian only reaches pixels whose tile meets its
3-sigma bounding square, as the tiled path culls.
"""

from __future__ import annotations

import torch

from gsjax_torch.core.cameras import Camera
from gsjax_torch.render.preprocess import Projected

ALPHA_CAP = 0.99
ALPHA_SKIP = 1.0 / 255.0
T_EPS = 1e-4


def _capped_alpha(raw: torch.Tensor) -> torch.Tensor:
    """min(0.99, raw) with straight-through gradient (CUDA convention)."""
    return raw + (torch.clamp(raw, max=ALPHA_CAP) - raw).detach()


def tile_rect(
    mean_pix: torch.Tensor,
    radius: torch.Tensor,
    tiles_x: int,
    tiles_y: int,
    tile_size: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Inclusive-exclusive tile rectangle touched by each splat's bounding
    square, clamped to the grid (the CUDA getRect helper), int32."""
    mp = mean_pix.detach()
    r = radius.to(torch.float32)

    def to_i(v, hi):
        return torch.clamp(v, 0, hi).to(torch.int32)

    x0 = to_i((mp[:, 0] - r) / tile_size, tiles_x)
    y0 = to_i((mp[:, 1] - r) / tile_size, tiles_y)
    x1 = to_i(torch.ceil((mp[:, 0] + r + 1.0) / tile_size), tiles_x)
    y1 = to_i(torch.ceil((mp[:, 1] + r + 1.0) / tile_size), tiles_y)
    empty = radius <= 0
    return x0, y0, torch.where(empty, x0, x1), torch.where(empty, y0, y1)


def composite_oracle(
    proj: Projected,
    camera: Camera,
    bg: torch.Tensor,
    tile_size: int | None = 16,
) -> torch.Tensor:
    """Composite all projected Gaussians into a [3, H, W] image.

    Args:
      proj: preprocess() output (radius == 0 rows are skipped).
      camera: provides image dims.
      bg: [3] background composited under residual transmittance.
      tile_size: if set, cull to the bounding square's tiles at this
        granularity; None disables culling (pure EWA).
    """
    H, W = camera.height, camera.width
    dev = proj.depth.device
    px = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    py = torch.arange(H, dtype=torch.float32, device=dev)[:, None]

    order = torch.sort(proj.depth.detach(), stable=True).indices
    order = order[proj.radius[order] > 0]  # invisible splats never count
    if tile_size is not None:
        tiles_x = (W + tile_size - 1) // tile_size
        tiles_y = (H + tile_size - 1) // tile_size
        rect = tile_rect(proj.mean_pix, proj.radius, tiles_x, tiles_y, tile_size)
        tile_col = torch.arange(W, device=dev)[None, :] // tile_size
        tile_row = torch.arange(H, device=dev)[:, None] // tile_size

    T = torch.ones((H, W), dtype=torch.float32, device=dev)
    C = torch.zeros((3, H, W), dtype=torch.float32, device=dev)
    done = torch.zeros((H, W), dtype=torch.bool, device=dev)
    for i in order.tolist():
        mean, conic = proj.mean_pix[i], proj.conic[i]
        dx = mean[0] - px
        dy = mean[1] - py
        power = -0.5 * (conic[0] * dx * dx + conic[2] * dy * dy) - conic[1] * dx * dy
        g = torch.exp(torch.clamp(power, max=0.0))
        alpha = _capped_alpha(proj.opacity[i] * g)
        keep = (alpha >= ALPHA_SKIP) & (power <= 0.0)
        if tile_size is not None:
            x0, y0, x1, y1 = (v[i] for v in rect)
            keep = keep & (tile_col >= x0) & (tile_col < x1) & (tile_row >= y0) & (tile_row < y1)
        alpha = torch.where(keep, alpha, 0.0)
        # A pixel is done once a contribution WOULD push T below eps; that
        # contribution is skipped and the pixel never resumes.
        done = done | ((T * (1.0 - alpha) < T_EPS) & keep)
        alpha = torch.where(done, 0.0, alpha)
        C = C + proj.rgb[i][:, None, None] * (alpha * T)[None, :, :]
        T = T * (1.0 - alpha)
    return C + T[None, :, :] * bg[:, None, None]
