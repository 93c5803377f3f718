"""Image quality metrics: MSE and PSNR (reference: utils/image_utils.py:14-19).

LPIPS (reference: lpipsPyTorch/) is not ported yet: `lpips_available()`
returns False, and the metrics CLI reports LPIPS as null, as gsjax does
when it has no pretrained weights.
"""

from __future__ import annotations

import torch


def mse(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Per-image mean squared error over flattened pixels
    (reference: utils/image_utils.py:14-15). Takes [C,H,W] or [B,C,H,W];
    returns [1,1,1,1] or [B,1,1,1]."""
    if img1.ndim == 3:
        img1, img2 = img1[None], img2[None]
    return torch.mean((img1 - img2) ** 2, dim=tuple(range(1, img1.ndim)), keepdim=True)


def psnr(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """20 * log10(1 / sqrt(mse)) per image (reference:
    utils/image_utils.py:17-19), in mse's shape."""
    return 20.0 * torch.log10(1.0 / torch.sqrt(mse(img1, img2)))


def lpips_available() -> bool:
    """False: the LPIPS network (VGG16 trunk and linear heads) is not
    ported yet, so there is nothing to score with even where weights
    exist."""
    return False
