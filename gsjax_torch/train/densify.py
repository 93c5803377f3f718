"""Adaptive density control: the statistics every training step
accumulates. The clone, split and prune that read them, with their
Adam-moment surgery (`gsjax.train.densify.densify_and_prune`), are not
ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

from gsjax_torch.model import GaussianAux


def add_densification_stats(
    aux: GaussianAux, radii: torch.Tensor, screen_grad: torch.Tensor
) -> GaussianAux:
    """Per-iteration stat accumulation (reference: train.py:115-116,
    scene/gaussian_model.py:405-407). radii: [C] int32 screen radii (0 =
    not visible); screen_grad: [C,2] NDC position gradient."""
    visible = radii > 0
    norm = torch.linalg.vector_norm(screen_grad, dim=-1)
    return dataclasses.replace(
        aux,
        max_radii2d=torch.where(
            visible, torch.maximum(aux.max_radii2d, radii.to(torch.float32)),
            aux.max_radii2d,
        ),
        xyz_grad_accum=aux.xyz_grad_accum
        + torch.where(visible, norm, torch.zeros_like(norm)),
        denom=aux.denom + visible.to(torch.float32),
    )
