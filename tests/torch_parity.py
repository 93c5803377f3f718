"""Helpers shared by the tests that hold gsjax_torch against gsjax: the
same scene and camera handed to both packages as numpy arrays."""

from __future__ import annotations

import numpy as np
import torch

from gsjax_torch.interop import AUX_ARRAYS
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


def train_state_to_numpy(jax_state) -> dict:
    """A gsjax TrainState as the nested numpy mapping that
    interop.train_state_from_numpy takes."""
    def arrays(obj, names):
        return {k: np.asarray(getattr(obj, k)) for k in names}

    return {
        "params": arrays(jax_state.params, PARAM_NAMES),
        "opt": {
            "count": np.asarray(jax_state.opt.count),
            "mu": arrays(jax_state.opt.mu, PARAM_NAMES),
            "nu": arrays(jax_state.opt.nu, PARAM_NAMES),
        },
        "aux": arrays(jax_state.aux, AUX_ARRAYS),
        "step": np.asarray(jax_state.step),
    }


def t(a, dtype=None) -> torch.Tensor:
    """numpy (or jax) array -> CPU tensor."""
    return torch.as_tensor(np.array(a), dtype=dtype)


def n(x) -> np.ndarray:
    """tensor -> numpy."""
    return x.detach().cpu().numpy()


def scaled_close(got, want, atol=5e-3, what="") -> None:
    """|got - want| / max|want| <= atol: the gradient tolerance that
    tests/test_renderer.py holds gsjax's own kernels to."""
    scale = max(float(np.abs(want).max()), 1e-8)
    np.testing.assert_allclose(got / scale, want / scale, atol=atol, err_msg=what)
