"""Carry weights, cameras and training state across from numpy arrays.

The mappings hold the arrays the JAX package's `GaussianParams`, `Camera`,
`AdamState`, `GaussianAux` and `TrainState` carry, under the same names,
so a caller holding that package's state (as numpy) gives this package
exactly the same inputs, and both can take a step from the same state.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from gsjax_torch.config import resolve_device
from gsjax_torch.core.cameras import Camera
from gsjax_torch.model import PARAM_NAMES, GaussianAux, GaussianParams
from gsjax_torch.train.optimizer import AdamState
from gsjax_torch.train.step import TrainState

CAMERA_ARRAYS = ("view", "full_proj", "cam_center", "tan_fovx", "tan_fovy")
AUX_ARRAYS = ("alive", "max_radii2d", "xyz_grad_accum", "denom")


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


def adam_state_from_numpy(
    mapping: Mapping, device: torch.device | str | None = None
) -> AdamState:
    """AdamState from {"count": int, "mu": {name: array}, "nu": {name:
    array}}, the moments keyed like PARAM_NAMES."""
    dev = resolve_device(device)

    def moments(m):
        return {
            k: torch.as_tensor(np.array(m[k], np.float32), device=dev)
            for k in PARAM_NAMES
        }

    return AdamState(
        count=torch.as_tensor(np.array(mapping["count"], np.int32), device=dev),
        mu=moments(mapping["mu"]),
        nu=moments(mapping["nu"]),
    )


def aux_from_numpy(
    mapping: Mapping[str, np.ndarray], device: torch.device | str | None = None
) -> GaussianAux:
    """GaussianAux from {"alive" (bool), "max_radii2d", "xyz_grad_accum",
    "denom"}."""
    dev = resolve_device(device)
    return GaussianAux(
        alive=torch.as_tensor(np.array(mapping["alive"], bool), device=dev),
        **{
            k: torch.as_tensor(np.array(mapping[k], np.float32), device=dev)
            for k in AUX_ARRAYS[1:]
        },
    )


def train_state_from_numpy(
    mapping: Mapping, device: torch.device | str | None = None
) -> TrainState:
    """TrainState from {"params": ..., "opt": ..., "aux": ..., "step": int},
    each part as its own loader above takes it."""
    dev = resolve_device(device)
    return TrainState(
        params=params_from_numpy(mapping["params"], dev),
        opt=adam_state_from_numpy(mapping["opt"], dev),
        aux=aux_from_numpy(mapping["aux"], dev),
        step=torch.as_tensor(np.array(mapping["step"], np.int32), device=dev),
    )
