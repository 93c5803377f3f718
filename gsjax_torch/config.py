"""Configuration dataclasses and device selection.

The same groups, fields and defaults as `gsjax.config` (the published 3DGS
recipe, reference: arguments/__init__.py:47-90), minus `RasterConfig.interpret`:
the port runs its kernels on the device its tensors lie on.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


def resolve_device(device: torch.device | str | None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another. Raises when CUDA is asked for (or defaulted to) and absent —
    the port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Scene/model loading options (reference: arguments/__init__.py:47-62)."""

    sh_degree: int = 3
    source_path: str = ""
    model_path: str = ""
    images: str = "images"
    resolution: int = -1
    white_background: bool = False
    data_device: str = "cuda"
    eval: bool = False
    # Skysphere extension: number of far-field sky Gaussians initialized on
    # a sphere of sky_radius_scale * cameras_extent. 0 = vanilla.
    sky_gaussians: int = 0
    sky_radius_scale: float = 10.0


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Render-pipeline toggles (reference: arguments/__init__.py:64-69).

    convert_SHs_python / compute_cov3D_python run the SH -> RGB and
    covariance math outside the fused preprocess, as an A/B hook
    (reference: gaussian_renderer/__init__.py:57-82).
    """

    convert_SHs_python: bool = False
    compute_cov3D_python: bool = False
    debug: bool = False


@dataclasses.dataclass(frozen=True)
class OptimizationConfig:
    """Training hyperparameters (reference: arguments/__init__.py:71-89)."""

    iterations: int = 30_000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 0.0002
    random_background: bool = False


@dataclasses.dataclass(frozen=True)
class RasterConfig:
    """Rasterizer configuration.

    Attributes:
      tile_size: pixel tile edge used when tile_w/tile_h are unset.
      tile_w / tile_h: optional rectangular tile shape. The instance count
        (and every instance-rate stage) shrinks with bigger tiles while the
        per-tile composite cost grows with tile area.
      chunk: alignment unit of the budgets, and the instance step of the
        plain compositor's per-tile walk.
      max_instances: static budget for exact (gaussian, tile) pairs (pairs
        whose tile holds a pixel with alpha >= 1/255). Pairs past the
        budget are dropped deepest-first; overflow is reported.
      max_rows: static budget for (gaussian, tile-row) runs, the middle
        level of the two-level instance expansion.
      strips: per-tile early-termination granularity of the reference
        kernels; it never changes the output, and the port's compositors
        accept and ignore it.
      fast_fwd: inference-only forward, within 4e-3 of exact; the port
        runs the exact walk for it, which on the card is the faster one.
        Differentiating such a render raises ValueError.
    """

    tile_size: int = 16
    tile_w: Optional[int] = None
    tile_h: Optional[int] = None
    strips: int = 1
    chunk: int = 128
    max_instances: int = 2 ** 21
    max_rows: int = 2 ** 21
    fast_fwd: bool = False

    def __post_init__(self) -> None:
        if self.max_instances % self.chunk:
            raise ValueError(
                f"max_instances ({self.max_instances}) must be a multiple "
                f"of chunk ({self.chunk})"
            )
        if self.max_rows % self.chunk:
            raise ValueError(
                f"max_rows ({self.max_rows}) must be a multiple of chunk "
                f"({self.chunk})"
            )
        if self.tw * self.th % 8:
            raise ValueError("tile area must be a multiple of 8 sublanes")
        if self.tw * self.th % (8 * self.strips):
            raise ValueError("strips must divide the tile into 8-sublane "
                             "multiples")

    @property
    def tw(self) -> int:
        return self.tile_w if self.tile_w is not None else self.tile_size

    @property
    def th(self) -> int:
        return self.tile_h if self.tile_h is not None else self.tile_size

    @property
    def pixels_per_tile(self) -> int:
        return self.tw * self.th


MIN_RASTER_BUDGET = 1 << 16


def pow2_budget(peak: int, headroom: float = 1.3) -> int:
    """Smallest power-of-two budget holding peak * headroom."""
    need = max(int(peak * headroom), MIN_RASTER_BUDGET)
    return 1 << (need - 1).bit_length()
