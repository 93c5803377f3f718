"""The plain reference of the benchmark's configurations: 3D Gaussian
splatting as the published 3DGS code states it (Kerbl et al., SIGGRAPH
2023; the diff-gaussian-rasterization forward and its derivative, the
L1 + D-SSIM loss and Adam of train.py), written in plain PyTorch in
float32, tile by tile so that it fits beside the program. It imports
nothing of the program under test, nor JAX.

`precision(tf32)` sets whether matrix products may run in TF32: the
reference runs with TF32 off; the benchmark's control runs the same code
with it on.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def precision(tf32: bool):
    """Matrix products and convolutions in TF32 (tf32=True) or in full
    float32, restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
