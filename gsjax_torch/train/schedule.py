"""Plenoxels-style log-linear learning-rate schedule
(reference: utils/general_utils.py:29-62), on f32 tensors so it runs
inside the training step on the step counter's device."""

from __future__ import annotations

import math

import torch


def expon_lr(
    step: torch.Tensor,
    lr_init: float,
    lr_final: float,
    lr_delay_steps: int = 0,
    lr_delay_mult: float = 1.0,
    max_steps: int = 1_000_000,
) -> torch.Tensor:
    """Log-lerp from lr_init to lr_final over max_steps, with optional
    reverse-cosine warmup. Negative steps or a zero schedule return 0."""
    step = torch.as_tensor(step).to(torch.float32)
    if lr_init == 0.0 and lr_final == 0.0:
        return torch.zeros_like(step)
    if lr_delay_steps > 0:
        delay_rate = lr_delay_mult + (1.0 - lr_delay_mult) * torch.sin(
            0.5 * math.pi * torch.clamp(step / lr_delay_steps, 0.0, 1.0)
        )
    else:
        delay_rate = 1.0
    t = torch.clamp(step / max_steps, 0.0, 1.0)
    log_init = torch.log(step.new_tensor(lr_init))
    log_final = torch.log(step.new_tensor(lr_final))
    log_lerp = torch.exp(log_init * (1.0 - t) + log_final * t)
    return torch.where(step < 0, torch.zeros_like(step), delay_rate * log_lerp)
