"""gsjax_torch — the PyTorch / CUDA port of gsjax (3D Gaussian Splatting).

A package of its own beside `gsjax`: it imports torch, numpy and the
standard library only. Entry points run on the CUDA device unless the
caller passes device="cpu"; the render path's kernels are hand-written
CUDA for Hopper (render/kernels.py, csrc/).
"""
