"""Carry weights and cameras across from numpy arrays.

The mappings hold the arrays the JAX package's `GaussianParams` and
`Camera` carry, under the same names, so a caller holding that package's
state (as numpy) gives this package exactly the same inputs.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from gsjax_torch.config import resolve_device
from gsjax_torch.core.cameras import Camera
from gsjax_torch.model import PARAM_NAMES, GaussianParams

CAMERA_ARRAYS = ("view", "full_proj", "cam_center", "tan_fovx", "tan_fovy")


def params_from_numpy(
    mapping: Mapping[str, np.ndarray],
    device: torch.device | str | None = None,
) -> GaussianParams:
    """GaussianParams from {"xyz", "features_dc", "features_rest",
    "scaling", "rotation", "opacity"} numpy arrays (raw, pre-activation)."""
    dev = resolve_device(device)
    return GaussianParams(
        **{
            k: torch.as_tensor(np.array(mapping[k], np.float32), device=dev)
            for k in PARAM_NAMES
        }
    )


def camera_from_numpy(
    mapping: Mapping[str, np.ndarray | int | float],
    device: torch.device | str | None = None,
) -> Camera:
    """Camera from {"view", "full_proj", "cam_center", "tan_fovx",
    "tan_fovy", "width", "height"}."""
    dev = resolve_device(device)
    arrays = {
        k: torch.as_tensor(np.array(mapping[k], np.float32), device=dev)
        for k in CAMERA_ARRAYS
    }
    return Camera(
        **arrays, width=int(mapping["width"]), height=int(mapping["height"])
    )
