"""Synthetic scene generators shared by tests, benchmarks and the chip
smoke run.

`random_scene` makes the same numpy draws in the same order as
`gsjax.synthetic.random_scene`, so one seed gives both packages the same
scene.
"""

from __future__ import annotations

import numpy as np
import torch

from gsjax_torch.config import resolve_device
from gsjax_torch.core.cameras import Camera
from gsjax_torch.core.transforms import inverse_sigmoid
from gsjax_torch.model import GaussianAux, GaussianParams


def random_scene(
    n: int,
    capacity: int | None = None,
    sh_degree: int = 3,
    seed: int = 0,
    spread: float = 1.0,
    scale_range: tuple[float, float] = (0.02, 0.12),
    opacity_range: tuple[float, float] = (0.2, 0.95),
    depth_range: tuple[float, float] = (2.0, 6.0),
    device: torch.device | str | None = None,
) -> tuple[GaussianParams, GaussianAux]:
    """Random Gaussians in a box in front of the default camera (+z)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    capacity = capacity or n
    xyz = np.zeros((capacity, 3), np.float32)
    xyz[:n, 0] = rng.uniform(-spread, spread, n)
    xyz[:n, 1] = rng.uniform(-spread, spread, n)
    xyz[:n, 2] = rng.uniform(*depth_range, n)
    k = (sh_degree + 1) ** 2
    f_dc = rng.uniform(-1.0, 1.5, (capacity, 1, 3)).astype(np.float32)
    f_rest = (rng.standard_normal((capacity, k - 1, 3)) * 0.2).astype(np.float32)
    scales = np.log(
        rng.uniform(*scale_range, (capacity, 3)).astype(np.float32)
    )
    rots = rng.standard_normal((capacity, 4)).astype(np.float32)
    rots[:, 0] += 2.0  # bias toward identity to avoid near-zero quats
    opac_lin = rng.uniform(*opacity_range, (capacity, 1)).astype(np.float32)

    def t(a):
        return torch.as_tensor(a, device=dev)

    params = GaussianParams(
        xyz=t(xyz),
        features_dc=t(f_dc),
        features_rest=t(f_rest),
        scaling=t(scales),
        rotation=t(rots),
        opacity=inverse_sigmoid(t(opac_lin)),
    )
    return params, GaussianAux.create(capacity, n, dev)


def look_at_origin_camera(
    width: int = 64,
    height: int = 48,
    fov: float = 0.9,
    device: torch.device | str | None = None,
) -> Camera:
    """Camera at the world origin looking down +z (identity view)."""
    R = np.eye(3, dtype=np.float32)
    t = np.zeros(3, dtype=np.float32)
    fov_y = 2.0 * np.arctan(np.tan(fov / 2.0) * height / width)
    return Camera.create(
        R, t, fov_x=fov, fov_y=float(fov_y), width=width, height=height,
        device=device,
    )


def orbit_camera(
    angle: float,
    radius: float = 4.0,
    width: int = 64,
    height: int = 48,
    fov: float = 0.9,
    device: torch.device | str | None = None,
) -> Camera:
    """Camera orbiting the point (0,0,4) in the x-z plane, looking at it."""
    target = np.array([0.0, 0.0, 4.0])
    pos = target + radius * np.array([np.sin(angle), 0.0, -np.cos(angle)])
    fwd = target - pos
    fwd /= np.linalg.norm(fwd)
    up = np.array([0.0, -1.0, 0.0])  # COLMAP convention: y down
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    up2 = np.cross(fwd, right)
    # world->cam rotation rows = (right, up2, fwd)
    R_w2c = np.stack([right, up2, fwd], axis=0)
    t = -R_w2c @ pos
    # Camera.create expects the COLMAP-style transposed rotation (c2w).
    fov_y = 2.0 * np.arctan(np.tan(fov / 2.0) * height / width)
    return Camera.create(
        R_w2c.T.astype(np.float32),
        t.astype(np.float32),
        fov_x=fov,
        fov_y=float(fov_y),
        width=width,
        height=height,
        device=device,
    )
