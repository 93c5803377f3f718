"""Camera loading: the resolution policy and image preparation.

The port's copy of `gsjax.data.camera_utils`; `load_camera` returns the
port's Camera on the device asked for (CUDA by default).

Mirrors the reference loader (reference: utils/camera_utils.py:19-60):
-r in {1,2,4,8} divides; -r -1 auto-caps width at 1600px; other values set
the target width. Images resize through PIL (matching PILtoTorch,
reference: utils/general_utils.py:21-27) and RGBA alpha is kept separate so
the GT premultiply happens in f32 on device (reference: scene/cameras.py:39-44).
"""

from __future__ import annotations

import numpy as np
import torch

from gsjax_torch.core.cameras import Camera, fov2focal
from gsjax_torch.data.dataset import CameraInfo

_WARNED = False


def resolve_resolution(
    orig_w: int, orig_h: int, resolution: int, resolution_scale: float = 1.0
) -> tuple[int, int]:
    """(reference: utils/camera_utils.py:22-39)"""
    global _WARNED
    if resolution in (1, 2, 4, 8):
        return (
            round(orig_w / (resolution_scale * resolution)),
            round(orig_h / (resolution_scale * resolution)),
        )
    if resolution == -1:
        if orig_w > 1600:
            if not _WARNED:
                print(
                    "[ INFO ] Encountered quite large input images (>1.6K pixels "
                    "width), rescaling to 1.6K.\n If this is not desired, please "
                    "explicitly specify '--resolution/-r' as 1"
                )
                _WARNED = True
            global_down = orig_w / 1600
        else:
            global_down = 1
    else:
        global_down = orig_w / resolution
    scale = float(global_down) * float(resolution_scale)
    return int(orig_w / scale), int(orig_h / scale)


def load_camera(
    info: CameraInfo,
    uid: int,
    resolution: int,
    resolution_scale: float = 1.0,
    device: torch.device | str | None = None,
) -> tuple[Camera, np.ndarray, np.ndarray]:
    """Load one camera: returns (Camera, rgb_u8 [3,H,W], alpha_u8 [1,H,W]).

    alpha is 255 everywhere when the source has no alpha channel (the
    reference multiplies by ones then, reference: scene/cameras.py:41-44).
    """
    from PIL import Image

    img = info.load_image()
    pil = Image.fromarray(img) if isinstance(img, np.ndarray) else img
    orig_w, orig_h = pil.size
    w, h = resolve_resolution(orig_w, orig_h, resolution, resolution_scale)
    resized = np.asarray(pil.resize((w, h)))
    if resized.ndim == 2:
        resized = resized[:, :, None].repeat(3, axis=2)
    rgb = resized[:, :, :3].transpose(2, 0, 1).astype(np.uint8)
    if resized.shape[2] == 4:
        alpha = resized[:, :, 3:4].transpose(2, 0, 1).astype(np.uint8)
    else:
        alpha = np.full((1, h, w), 255, np.uint8)
    cam = Camera.create(
        info.R, info.T, fov_x=info.fov_x, fov_y=info.fov_y, width=w, height=h,
        device=device,
    )
    return cam, rgb, alpha


def camera_to_json(idx: int, info: CameraInfo) -> dict:
    """Viewer-compatible camera entry (reference: utils/camera_utils.py:62-81)."""
    Rt = np.zeros((4, 4))
    Rt[:3, :3] = info.R.transpose()
    Rt[:3, 3] = info.T
    Rt[3, 3] = 1.0
    w2c = np.linalg.inv(Rt)
    return {
        "id": idx,
        "img_name": info.image_name,
        "width": info.width,
        "height": info.height,
        "position": w2c[:3, 3].tolist(),
        "rotation": [r.tolist() for r in w2c[:3, :3]],
        "fy": fov2focal(info.fov_y, info.height),
        "fx": fov2focal(info.fov_x, info.width),
    }
