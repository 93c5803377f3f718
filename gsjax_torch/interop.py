"""Carry weights, cameras and training state across from numpy arrays,
and back.

The mappings hold the arrays the JAX package's `GaussianParams`, `Camera`,
`AdamState`, `GaussianAux`, `TrainState`, `DensifyStats` and `CameraBank`
carry, under the same names, so a caller holding that package's state (as
numpy) gives this package exactly the same inputs, and both can take a
step from the same state; `train_state_to_numpy` gives the port's state
back in the same form.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from gsjax_torch.config import resolve_device
from gsjax_torch.core.cameras import Camera
from gsjax_torch.model import PARAM_NAMES, GaussianAux, GaussianParams
from gsjax_torch.scene import CameraBank
from gsjax_torch.train.densify import DensifyStats
from gsjax_torch.train.optimizer import AdamState
from gsjax_torch.train.step import TrainState

CAMERA_ARRAYS = ("view", "full_proj", "cam_center", "tan_fovx", "tan_fovy")
AUX_ARRAYS = ("alive", "max_radii2d", "xyz_grad_accum", "denom")
STATS_ARRAYS = ("n_alive", "n_cloned", "n_split", "n_pruned", "n_dropped")
BANK_ARRAYS = ("views", "full_projs", "centers", "tan_fovx", "tan_fovy")


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


def train_state_to_numpy(state: TrainState) -> dict:
    """The nested numpy mapping train_state_from_numpy takes, from the
    port's TrainState, with the JAX package's dtypes (float32, bool alive,
    int32 count and step)."""
    def arrays(tensors: Mapping[str, torch.Tensor]) -> dict:
        return {k: v.detach().cpu().numpy() for k, v in tensors.items()}

    return {
        "params": arrays({k: getattr(state.params, k) for k in PARAM_NAMES}),
        "opt": {
            "count": state.opt.count.cpu().numpy(),
            "mu": arrays(state.opt.mu),
            "nu": arrays(state.opt.nu),
        },
        "aux": arrays({k: getattr(state.aux, k) for k in AUX_ARRAYS}),
        "step": state.step.cpu().numpy(),
    }


def densify_stats_from_numpy(
    mapping: Mapping[str, np.ndarray], device: torch.device | str | None = None
) -> DensifyStats:
    """DensifyStats from {"n_alive", "n_cloned", "n_split", "n_pruned",
    "n_dropped"} ([] int32 each)."""
    dev = resolve_device(device)
    return DensifyStats(**{
        k: torch.as_tensor(np.array(mapping[k], np.int32), device=dev)
        for k in STATS_ARRAYS
    })


def camera_bank_from_numpy(
    mapping: Mapping, device: torch.device | str | None = None
) -> CameraBank:
    """CameraBank from {"views", "full_projs", "centers", "tan_fovx",
    "tan_fovy", "gt_rgb" (uint8), "alpha" (uint8), "width", "height"}."""
    dev = resolve_device(device)
    arrays = {
        k: torch.as_tensor(np.array(mapping[k], np.float32), device=dev)
        for k in BANK_ARRAYS
    }
    return CameraBank(
        **arrays,
        gt_rgb=torch.as_tensor(np.array(mapping["gt_rgb"], np.uint8), device=dev),
        alpha=torch.as_tensor(np.array(mapping["alpha"], np.uint8), device=dev),
        width=int(mapping["width"]), height=int(mapping["height"]),
    )
