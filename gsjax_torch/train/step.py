"""One training step: render -> L1 + SSIM loss -> backward -> Adam.

The body of the reference hot loop (reference: train.py:69-128), as
`gsjax.train.step._step_core` runs it for one view. The screen-space
position gradient that the reference reads from its dummy means2D tensor
is the gradient of an explicit zero `mean2d_offset` input, taken in the
same backward pass.
"""

from __future__ import annotations

import dataclasses

import torch

from gsjax_torch.config import OptimizationConfig, RasterConfig
from gsjax_torch.core.cameras import Camera
from gsjax_torch.model import PARAM_NAMES, GaussianAux, GaussianParams
from gsjax_torch.render.api import render
from gsjax_torch.train.densify import add_densification_stats
from gsjax_torch.train.loss import l1_loss, ssim
from gsjax_torch.train.optimizer import AdamState, adam_update, make_lr_tree


@dataclasses.dataclass
class TrainState:
    params: GaussianParams
    opt: AdamState
    aux: GaussianAux
    step: torch.Tensor  # [] int32, 1-based like the reference loop


@dataclasses.dataclass
class StepMetrics:
    loss: torch.Tensor
    l1: torch.Tensor
    num_instances: torch.Tensor
    num_rows: torch.Tensor


def train_step(
    state: TrainState,
    camera: Camera,
    gt_image: torch.Tensor,
    bg: torch.Tensor,
    *,
    active_sh_degree: int,
    opt_cfg: OptimizationConfig,
    raster_cfg: RasterConfig,
    spatial_lr_scale: float,
) -> tuple[TrainState, StepMetrics]:
    """One optimization iteration on one view.

    Args:
      state: updated in place: the parameters and Adam moments are
        overwritten, and the returned state holds the same tensors.
      camera: the view.
      gt_image: [3,H,W] f32 ground truth in [0, 1].
      bg: [3] background for this step.
    """
    params = state.params
    offset = torch.zeros(
        (params.capacity, 2), dtype=torch.float32, device=params.device,
        requires_grad=True,
    )
    out = render(
        params, camera, active_sh_degree=active_sh_degree, bg_color=bg,
        cfg=raster_cfg, alive=state.aux.alive, mean2d_offset=offset,
    )
    l1 = l1_loss(out.image, gt_image)
    lam = opt_cfg.lambda_dssim
    loss = (1.0 - lam) * l1 + lam * (1.0 - ssim(out.image, gt_image))
    leaves = [getattr(params, k) for k in PARAM_NAMES]
    *g_params, g_offset = torch.autograd.grad(loss, [*leaves, offset])

    aux = add_densification_stats(state.aux, out.radii, g_offset)
    lr_tree = make_lr_tree(opt_cfg, spatial_lr_scale, state.step)
    # In place, under no_grad (inside adam_update): the parameters and the
    # moments are overwritten rather than copied.
    opt = adam_update(dict(zip(PARAM_NAMES, g_params)), state.opt, params, lr_tree)

    new_state = TrainState(params=params, opt=opt, aux=aux, step=state.step + 1)
    metrics = StepMetrics(
        loss=loss.detach(), l1=l1.detach(), num_instances=out.num_instances,
        num_rows=out.num_rows,
    )
    return new_state, metrics
