"""Camera model and projective math.

Column-vector convention (x_cam = view @ x_world, clip = proj @ view @
x_world); the matrices are built in numpy exactly as `gsjax.core.cameras`
builds them and then placed on the camera's device. znear/zfar and the
OpenGL-style projection mirror the reference
(reference: scene/cameras.py:47-48, utils/graphics_utils.py:51-71).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from gsjax_torch.config import resolve_device

ZNEAR = 0.01
ZFAR = 100.0


def fov2focal(fov: float, pixels: float) -> float:
    """(reference: utils/graphics_utils.py:73-74)"""
    return pixels / (2.0 * math.tan(fov / 2.0))


def focal2fov(focal: float, pixels: float) -> float:
    """(reference: utils/graphics_utils.py:76-77)"""
    return 2.0 * math.atan(pixels / (2.0 * focal))


def world_to_view(
    R: np.ndarray,
    t: np.ndarray,
    translate: np.ndarray | None = None,
    scale: float = 1.0,
) -> np.ndarray:
    """World-to-camera 4x4 (column-vector convention).

    R is the COLMAP-style transposed rotation (camera-to-world), t the
    world-to-camera translation (reference: utils/graphics_utils.py:38-48).
    """
    Rt = np.zeros((4, 4), dtype=np.float64)
    Rt[:3, :3] = R.T
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    if translate is not None or scale != 1.0:
        translate = np.zeros(3) if translate is None else np.asarray(translate)
        c2w = np.linalg.inv(Rt)
        cam_center = (c2w[:3, 3] + translate) * scale
        c2w[:3, 3] = cam_center
        Rt = np.linalg.inv(c2w)
    return Rt.astype(np.float32)


def projection_matrix(znear: float, zfar: float, fov_x: float, fov_y: float) -> np.ndarray:
    """OpenGL-style perspective, column-vector form
    (reference: utils/graphics_utils.py:51-71)."""
    tan_y = math.tan(fov_y / 2.0)
    tan_x = math.tan(fov_x / 2.0)
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = 1.0 / tan_x
    P[1, 1] = 1.0 / tan_y
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    P[3, 2] = 1.0
    return P


@dataclasses.dataclass(frozen=True)
class Camera:
    """One camera, ready for rendering: f32 tensors on one device.

    view: [4,4] world->camera (column-vector).
    full_proj: [4,4] proj @ view.
    cam_center: [3] camera position in world space.
    tan_fovx / tan_fovy: [] tangents of the half field of view.
    """

    view: torch.Tensor
    full_proj: torch.Tensor
    cam_center: torch.Tensor
    tan_fovx: torch.Tensor
    tan_fovy: torch.Tensor
    width: int
    height: int

    @classmethod
    def create(
        cls,
        R: np.ndarray,
        t: np.ndarray,
        fov_x: float,
        fov_y: float,
        width: int,
        height: int,
        znear: float = ZNEAR,
        zfar: float = ZFAR,
        translate: np.ndarray | None = None,
        scale: float = 1.0,
        device: torch.device | str | None = None,
    ) -> "Camera":
        dev = resolve_device(device)
        view = world_to_view(R, t, translate, scale)
        full = (projection_matrix(znear, zfar, fov_x, fov_y) @ view).astype(np.float32)
        c2w = np.linalg.inv(view.astype(np.float64))

        def tensor(a):
            return torch.as_tensor(np.array(a, np.float32), device=dev)

        return cls(
            view=tensor(view),
            full_proj=tensor(full),
            cam_center=tensor(c2w[:3, 3]),
            tan_fovx=tensor(math.tan(fov_x / 2.0)),
            tan_fovy=tensor(math.tan(fov_y / 2.0)),
            width=int(width),
            height=int(height),
        )

    @classmethod
    def from_matrices(
        cls,
        view_rowmajor: np.ndarray,
        full_proj_rowmajor: np.ndarray,
        fov_x: float,
        fov_y: float,
        width: int,
        height: int,
        device: torch.device | str | None = None,
    ) -> "Camera":
        """Build from reference-convention (transposed) matrices, as the
        network viewer supplies them (reference: scene/cameras.py:59-70).
        The view is inverted in float64 with numpy, as gsjax does, so that
        cam_center agrees bit for bit."""
        dev = resolve_device(device)
        view = np.asarray(view_rowmajor, dtype=np.float32).T
        full = np.asarray(full_proj_rowmajor, dtype=np.float32).T
        c2w = np.linalg.inv(view.astype(np.float64))

        def tensor(a):
            return torch.as_tensor(np.array(a, np.float32), device=dev)

        return cls(
            view=tensor(view),
            full_proj=tensor(full),
            cam_center=tensor(c2w[:3, 3]),
            tan_fovx=tensor(math.tan(fov_x / 2.0)),
            tan_fovy=tensor(math.tan(fov_y / 2.0)),
            width=int(width),
            height=int(height),
        )

    @property
    def device(self) -> torch.device:
        return self.view.device

    @property
    def focal_x(self) -> torch.Tensor:
        return _true_div(self.width, 2.0 * self.tan_fovx)

    @property
    def focal_y(self) -> torch.Tensor:
        return _true_div(self.height, 2.0 * self.tan_fovy)


def _true_div(num: float, den: torch.Tensor) -> torch.Tensor:
    """num / den as one f32 division (`num / tensor` multiplies by the
    reciprocal, an ulp away). The numerator is filled on the device, so a
    CUDA graph can capture it."""
    return torch.div(torch.full_like(den, num), den)


def ndc_to_pixel(ndc: torch.Tensor, size: torch.Tensor | float) -> torch.Tensor:
    """NDC in [-1,1] -> continuous pixel coordinate (the CUDA rasterizer's
    ndc2Pix: ((v + 1) * S - 1) / 2)."""
    return ((ndc + 1.0) * size - 1.0) * 0.5
