"""Quaternion / covariance math for anisotropic 3D Gaussians.

Sigma = L L^T with L = R(q) diag(s), stored as the upper-triangular
6-vector (xx, xy, xz, yy, yz, zz) (reference: utils/general_utils.py:64-110,
scene/gaussian_model.py:26-41). Batched over a leading axis, f32.
"""

from __future__ import annotations

import torch


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """logit; used for opacity init/reset (reference: utils/general_utils.py:18-19)."""
    return torch.log(x / (1.0 - x))


def build_rotation(q: torch.Tensor) -> torch.Tensor:
    """[..., 4] quaternions (w, x, y, z), normalized here -> [..., 3, 3]
    rotation matrices (reference: utils/general_utils.py:78-98)."""
    norm = torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True))
    q = q / norm
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack(
        [1.0 - 2.0 * (y * y + z * z), 2.0 * (x * y - r * z), 2.0 * (x * z + r * y)],
        dim=-1,
    )
    row1 = torch.stack(
        [2.0 * (x * y + r * z), 1.0 - 2.0 * (x * x + z * z), 2.0 * (y * z - r * x)],
        dim=-1,
    )
    row2 = torch.stack(
        [2.0 * (x * z - r * y), 2.0 * (y * z + r * x), 1.0 - 2.0 * (x * x + y * y)],
        dim=-1,
    )
    return torch.stack([row0, row1, row2], dim=-2)


def build_scaling_rotation(s: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """L = R(q) @ diag(s) (reference: utils/general_utils.py:100-110)."""
    return build_rotation(q) * s[..., None, :]


def strip_symmetric(sym: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] symmetric -> [..., 6] upper triangle
    (reference: utils/general_utils.py:64-77)."""
    return torch.stack(
        [
            sym[..., 0, 0],
            sym[..., 0, 1],
            sym[..., 0, 2],
            sym[..., 1, 1],
            sym[..., 1, 2],
            sym[..., 2, 2],
        ],
        dim=-1,
    )


def build_covariance(
    scaling: torch.Tensor, scaling_modifier: float, rotation: torch.Tensor
) -> torch.Tensor:
    """[..., 6] 3D covariance from activated scales [..., 3] and quaternions
    [..., 4] (reference: scene/gaussian_model.py:26-31)."""
    L = build_scaling_rotation(scaling_modifier * scaling, rotation)
    return strip_symmetric(L @ L.transpose(-1, -2))


def cov6_to_mat(cov6: torch.Tensor) -> torch.Tensor:
    """[..., 6] upper triangle -> [..., 3, 3] full symmetric matrix."""
    xx, xy, xz, yy, yz, zz = cov6.unbind(-1)
    return torch.stack(
        [
            torch.stack([xx, xy, xz], dim=-1),
            torch.stack([xy, yy, yz], dim=-1),
            torch.stack([xz, yz, zz], dim=-1),
        ],
        dim=-2,
    )
