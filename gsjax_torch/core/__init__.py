"""Camera, spherical-harmonics and covariance math."""

from gsjax_torch.core.cameras import Camera, focal2fov, fov2focal, projection_matrix, world_to_view
from gsjax_torch.core.sh import SH2RGB, RGB2SH, eval_sh, num_sh_coeffs
from gsjax_torch.core.transforms import (
    build_covariance,
    build_rotation,
    build_scaling_rotation,
    inverse_sigmoid,
    strip_symmetric,
)

__all__ = [
    "Camera",
    "focal2fov",
    "fov2focal",
    "projection_matrix",
    "world_to_view",
    "SH2RGB",
    "RGB2SH",
    "eval_sh",
    "num_sh_coeffs",
    "build_covariance",
    "build_rotation",
    "build_scaling_rotation",
    "inverse_sigmoid",
    "strip_symmetric",
]
