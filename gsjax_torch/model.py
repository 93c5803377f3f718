"""The Gaussian scene model: raw parameters at a fixed capacity.

Every tensor is sized to a static CAPACITY with an `alive` mask, as in
`gsjax.model`. Parameters are stored raw (pre-activation), as the reference
does: scaling = log-scale (exp activation), opacity = logit (sigmoid
activation), rotation = unnormalized quaternion
(reference: scene/gaussian_model.py:26-41).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from gsjax_torch.config import resolve_device
from gsjax_torch.core.sh import RGB2SH, num_sh_coeffs
from gsjax_torch.core.transforms import build_rotation, inverse_sigmoid

PARAM_NAMES = (
    "xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity",
)


class GaussianParams(nn.Module):
    """Optimizable parameters, capacity-padded.

    xyz: [C,3]; features_dc: [C,1,3]; features_rest: [C,K-1,3];
    scaling: [C,3] (log); rotation: [C,4]; opacity: [C,1] (logit).
    """

    def __init__(
        self,
        xyz: torch.Tensor,
        features_dc: torch.Tensor,
        features_rest: torch.Tensor,
        scaling: torch.Tensor,
        rotation: torch.Tensor,
        opacity: torch.Tensor,
    ) -> None:
        super().__init__()
        self.xyz = nn.Parameter(xyz)
        self.features_dc = nn.Parameter(features_dc)
        self.features_rest = nn.Parameter(features_rest)
        self.scaling = nn.Parameter(scaling)
        self.rotation = nn.Parameter(rotation)
        self.opacity = nn.Parameter(opacity)

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    @property
    def max_sh_degree(self) -> int:
        k = 1 + self.features_rest.shape[1]
        return int(round(k**0.5)) - 1

    @property
    def device(self) -> torch.device:
        return self.xyz.device

    # --- activations (reference: scene/gaussian_model.py:95-118) ---------
    def get_scaling(self) -> torch.Tensor:
        return torch.exp(self.scaling)

    def get_rotation(self) -> torch.Tensor:
        return self.rotation / torch.linalg.vector_norm(
            self.rotation, dim=-1, keepdim=True
        ).clamp(min=1e-12)

    def get_opacity(self) -> torch.Tensor:
        return torch.sigmoid(self.opacity)

    def get_features(self) -> torch.Tensor:
        """[C, K, 3] concatenated SH coefficients."""
        return torch.cat([self.features_dc, self.features_rest], dim=1)

    def get_rotation_matrices(self) -> torch.Tensor:
        return build_rotation(self.rotation)


@dataclasses.dataclass
class GaussianAux:
    """Non-optimized per-Gaussian state.

    alive: [C] bool capacity mask.
    max_radii2d: [C] f32 running max screen radius (prune criterion).
    xyz_grad_accum: [C] f32 accumulated screen-space grad norms.
    denom: [C] f32 accumulation counts.
    (reference: scene/gaussian_model.py:53-55,405-407)
    """

    alive: torch.Tensor
    max_radii2d: torch.Tensor
    xyz_grad_accum: torch.Tensor
    denom: torch.Tensor

    def n_alive(self) -> torch.Tensor:
        """[] int32 count of live slots, on the mask's device (no sync)."""
        return torch.sum(self.alive.to(torch.int32), dtype=torch.int32)

    @classmethod
    def create(
        cls, capacity: int, n_alive: int, device: torch.device
    ) -> "GaussianAux":
        return cls(
            alive=torch.arange(capacity, device=device) < n_alive,
            max_radii2d=torch.zeros(capacity, device=device),
            xyz_grad_accum=torch.zeros(capacity, device=device),
            denom=torch.zeros(capacity, device=device),
        )


def create_from_pcd(
    points: np.ndarray,
    colors: np.ndarray,
    sh_degree: int,
    capacity: int | None = None,
    knn_dist2: np.ndarray | None = None,
    device: torch.device | str | None = None,
) -> tuple[GaussianParams, GaussianAux]:
    """Initialize the model from a seed point cloud
    (reference: scene/gaussian_model.py:124-147).

    Scales: log(sqrt(max(mean 3-NN squared distance, 1e-7))), isotropic.
    Rotations: identity quaternion. Opacity: sigmoid^-1(0.1).

    Args:
      points/colors: [N,3] float arrays (colors in [0,1]).
      sh_degree: max SH degree (features sized (deg+1)^2).
      capacity: static buffer size; default = max(next power of two >= N,
        1024).
      knn_dist2: optional precomputed [N] mean 3-NN squared distances;
        otherwise the native library's 3-NN, or gsjax_torch.knn's on the
        device when the library is unavailable.
      device: where the model lives (default CUDA).
    """
    dev = resolve_device(device)
    n = points.shape[0]
    if capacity is None:
        capacity = max(1 << (n - 1).bit_length(), 1024)
    if capacity < n:
        raise ValueError(f"capacity {capacity} < point count {n}")
    k = num_sh_coeffs(sh_degree)

    pts_np = np.asarray(points, np.float32)
    pts = torch.as_tensor(pts_np, device=dev)
    if knn_dist2 is None:
        from gsjax_torch.native import mean_knn_dist2_native

        native = mean_knn_dist2_native(pts_np)
        if native is not None:
            dist2 = torch.as_tensor(native, device=dev)
        else:
            from gsjax_torch.knn import mean_knn_dist2

            dist2 = mean_knn_dist2(pts)
    else:
        dist2 = torch.as_tensor(np.asarray(knn_dist2, np.float32), device=dev)
    floor = torch.tensor(1e-7, dtype=torch.float32, device=dev)
    scales = torch.log(torch.sqrt(torch.maximum(dist2, floor)))[:, None].repeat(1, 3)

    cols = torch.as_tensor(np.asarray(colors, np.float32), device=dev)
    rots = torch.zeros((n, 4), dtype=torch.float32, device=dev)
    rots[:, 0] = 1.0
    params = pad_gaussian_params(
        xyz=pts,
        features_dc=RGB2SH(cols)[:, None, :],
        features_rest=torch.zeros((n, k - 1, 3), dtype=torch.float32, device=dev),
        scaling=scales,
        rotation=rots,
        opacity=inverse_sigmoid(
            torch.full((n, 1), 0.1, dtype=torch.float32, device=dev)),
        capacity=capacity,
    )
    return params, GaussianAux.create(capacity, n, dev)


# Dead-slot fill convention shared by padding, capacity growth, and densify
# compaction: tiny log-scale, ~zero logit opacity, identity quaternion —
# masked math stays finite (zero quats would NaN on normalize).
DEAD_SCALING_FILL = -10.0
DEAD_OPACITY_FILL = -10.0


@torch.no_grad()
def pad_gaussian_params(
    *,
    xyz: torch.Tensor,
    features_dc: torch.Tensor,
    features_rest: torch.Tensor,
    scaling: torch.Tensor,
    rotation: torch.Tensor,
    opacity: torch.Tensor,
    capacity: int,
) -> GaussianParams:
    """Pad per-Gaussian tensors of length n to `capacity` with the dead-slot
    fill convention, on their device. Raises if capacity is too small."""
    n = xyz.shape[0]
    if capacity < n:
        raise ValueError(f"capacity ({capacity}) < point count ({n})")

    def pad(x: torch.Tensor, fill: float = 0.0) -> torch.Tensor:
        out = x.new_full((capacity, *x.shape[1:]), fill)
        out[:n] = x
        return out

    rot = pad(rotation)
    rot[n:, 0] = 1.0
    return GaussianParams(
        xyz=pad(xyz),
        features_dc=pad(features_dc),
        features_rest=pad(features_rest),
        scaling=pad(scaling, DEAD_SCALING_FILL),
        rotation=rot,
        opacity=pad(opacity, DEAD_OPACITY_FILL),
    )
