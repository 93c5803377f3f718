"""Helpers shared by the tests that hold gsjax_torch against gsjax: the
same scene and camera handed to both packages as numpy arrays."""

from __future__ import annotations

import numpy as np
import torch

from gsjax_torch.interop import CAMERA_ARRAYS as CAMERA_FIELDS
from gsjax_torch.interop import camera_from_numpy, params_from_numpy
from gsjax_torch.model import PARAM_NAMES


def to_torch_params(jax_params):
    """The port's GaussianParams (CPU) holding gsjax params' arrays."""
    return params_from_numpy(
        {k: np.asarray(getattr(jax_params, k)) for k in PARAM_NAMES}, "cpu"
    )


def to_torch_camera(jax_camera):
    """The port's Camera (CPU) holding a gsjax camera's arrays."""
    fields = {k: np.asarray(getattr(jax_camera, k)) for k in CAMERA_FIELDS}
    fields.update(width=jax_camera.width, height=jax_camera.height)
    return camera_from_numpy(fields, "cpu")


def t(a, dtype=None) -> torch.Tensor:
    """numpy (or jax) array -> CPU tensor."""
    return torch.as_tensor(np.array(a), dtype=dtype)


def n(x) -> np.ndarray:
    """tensor -> numpy."""
    return x.detach().cpu().numpy()
