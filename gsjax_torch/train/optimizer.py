"""Adam with per-parameter-group learning rates, as functions on tensors.

Matches the reference's torch.optim.Adam(eps=1e-15) setup with six groups
at different learning rates and a per-step xyz rate from the exponential
schedule (reference: scene/gaussian_model.py:149-175). The moments are
plain dictionaries keyed like `model.PARAM_NAMES`, so densification can
gather and zero their rows alongside the parameters.

The bias-correction step count is one shared counter, as in
`gsjax.train.optimizer`: rows appended to a tensor inherit its step
count with zeroed moments, as the reference's optimizer-state surgery
does.
"""

from __future__ import annotations

import dataclasses

import torch

from gsjax_torch.config import OptimizationConfig
from gsjax_torch.model import PARAM_NAMES, GaussianParams
from gsjax_torch.train.schedule import expon_lr

BETA1 = 0.9
BETA2 = 0.999
EPS = 1e-15


@dataclasses.dataclass
class AdamState:
    """count: [] int32 steps taken; mu / nu: first and second moments,
    {name: tensor shaped like the parameter}."""

    count: torch.Tensor
    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]


def adam_init(params: GaussianParams) -> AdamState:
    return AdamState(
        count=torch.zeros((), dtype=torch.int32, device=params.device),
        mu={k: torch.zeros_like(getattr(params, k)) for k in PARAM_NAMES},
        nu={k: torch.zeros_like(getattr(params, k)) for k in PARAM_NAMES},
    )


@torch.no_grad()
def adam_update(
    grads: dict[str, torch.Tensor],
    state: AdamState,
    params: GaussianParams,
    lr_tree: dict[str, torch.Tensor],
) -> AdamState:
    """One Adam step over every group of `params`.

    Updates the parameters and the moment tensors in place (the step
    holds no second copy of either) and returns the state with the new
    count. lr_tree: {name: [] f32 learning rate}.
    """
    count = state.count + 1
    c = count.to(torch.float32)
    # Constants filled on the device (torch.full_like), never copied from
    # the host, here and in make_lr_tree: the step is captured as a graph.
    bc1 = 1.0 - torch.pow(torch.full_like(c, BETA1), c)
    bc2 = 1.0 - torch.pow(torch.full_like(c, BETA2), c)
    for name in PARAM_NAMES:
        g = grads[name]
        m = state.mu[name].mul_(BETA1).add_((1.0 - BETA1) * g)
        v = state.nu[name].mul_(BETA2).add_((1.0 - BETA2) * g * g)
        step = lr_tree[name] * (m / bc1) / (torch.sqrt(v / bc2) + EPS)
        getattr(params, name).sub_(step)
    return AdamState(count=count, mu=state.mu, nu=state.nu)


def make_lr_tree(
    cfg: OptimizationConfig, spatial_lr_scale: float, step: torch.Tensor
) -> dict[str, torch.Tensor]:
    """Per-group learning rates, {name: [] f32} on the step's device
    (reference: scene/gaussian_model.py:154-167, train.py:69)."""
    xyz_lr = expon_lr(
        step,
        lr_init=cfg.position_lr_init * spatial_lr_scale,
        lr_final=cfg.position_lr_final * spatial_lr_scale,
        lr_delay_mult=cfg.position_lr_delay_mult,
        max_steps=cfg.position_lr_max_steps,
    )

    def f32(v: float) -> torch.Tensor:
        return torch.full((), v, dtype=torch.float32, device=xyz_lr.device)

    return {
        "xyz": xyz_lr,
        "features_dc": f32(cfg.feature_lr),
        "features_rest": f32(cfg.feature_lr / 20.0),
        "scaling": f32(cfg.scaling_lr),
        "rotation": f32(cfg.rotation_lr),
        "opacity": f32(cfg.opacity_lr),
    }
