"""gsjax_torch — the PyTorch / CUDA port of gsjax (3D Gaussian Splatting).

A package of its own beside `gsjax`: it imports torch, numpy and the
standard library only. Entry points run on the CUDA device unless the
caller passes device="cpu"; the render path's kernels are hand-written
CUDA for Hopper (render/kernels.py, csrc/), built and loaded at their
first launch, never on import.

Re-exports gsjax's package-level names: the version it ports and the four
configs.
"""

__version__ = "0.1.0"

from gsjax_torch.config import (
    ModelConfig,
    OptimizationConfig,
    PipelineConfig,
    RasterConfig,
)

__all__ = [
    "ModelConfig",
    "OptimizationConfig",
    "PipelineConfig",
    "RasterConfig",
]
