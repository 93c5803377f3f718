"""The Gaussian scene model: raw parameters at a fixed capacity.

Every tensor is sized to a static CAPACITY with an `alive` mask, as in
`gsjax.model`. Parameters are stored raw (pre-activation), as the reference
does: scaling = log-scale (exp activation), opacity = logit (sigmoid
activation), rotation = unnormalized quaternion
(reference: scene/gaussian_model.py:26-41).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from gsjax_torch.core.transforms import build_rotation

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
