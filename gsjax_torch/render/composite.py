"""Tile compositing as a `torch.autograd.Function` over the instance gather
and the composite kernels.

All float inputs are depth-ordered (callers permute by binning.perm);
the integer binning products carry no gradient. The forward is the
instance gather (common.build_inst_data) and kernels.composite_forward.
The backward replays the walk with kernels.composite_backward into
per-instance gradients, regroups them by owner (the expansion order, in
which each Gaussian's instances form one run) with one row gather, and
sums each owner's run with kernels.segment_sum.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gsjax_torch.render import kernels
from gsjax_torch.render.common import N_FIELDS, build_inst_data


class CompositeStatic(NamedTuple):
    """Static geometry of one composite call."""

    n_tiles: int
    tiles_x: int
    tile_w: int
    tile_h: int
    chunk: int
    strips: int
    fast_fwd: bool = False


def pack_fields(mean_pix, conic, rgb, opacity) -> torch.Tensor:
    """Pack the differentiable per-Gaussian fields into the [N, 9] layout
    composite consumes (columns as in common.ROW_*)."""
    return torch.cat([mean_pix, conic, rgb, opacity.reshape(-1, 1)], dim=-1)


def _geometry(static: CompositeStatic) -> dict:
    return dict(
        n_tiles=static.n_tiles, tiles_x=static.tiles_x, tile_w=static.tile_w,
        tile_h=static.tile_h, chunk=static.chunk, strips=static.strips,
    )


def composite_cotangent(d_color, d_t, tile_color, tile_t) -> torch.Tensor:
    """The backward kernel's per-pixel cotangent (T, PIX, 4): the color
    cotangent and the initial suffix A'_0 = sum_ch dC * C_total + dT *
    T_final, one 16-byte row per pixel."""
    suffix0 = torch.sum(d_color * tile_color, dim=-1) + d_t * tile_t
    return torch.cat([d_color, suffix0[..., None]], dim=-1).contiguous()


def owner_sums(inst_grads, sorted_slot, gm_start) -> torch.Tensor:
    """Per-Gaussian [N, N_FIELDS] sums of the tile-order instance gradients
    (P, ROWS). sorted_slot (int32) maps each tile-order slot to its
    expansion-order slot and is a permutation, so its int32 inverse is one
    collision-free scatter; one row gather (kernels.row_gather) then
    regroups the grads by owner, and segment_sum adds each owner's run."""
    inverse = torch.empty_like(sorted_slot)
    inverse[sorted_slot] = torch.arange(
        sorted_slot.shape[0], dtype=sorted_slot.dtype, device=sorted_slot.device)
    vals = kernels.row_gather(inst_grads, inverse)
    return kernels.segment_sum(vals, gm_start)[:, :N_FIELDS]


class _Composite(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fields, sorted_owner, tile_start, sorted_slot, gm_start,
                static):
        inst = build_inst_data(fields, sorted_owner)
        tile_color, tile_t = kernels.composite_forward(
            inst, tile_start, **_geometry(static)
        )
        ctx.static = static
        # inst is kept (P x 64 bytes): rebuilding it in the backward would
        # repeat the instance-rate gather.
        ctx.save_for_backward(
            inst, tile_start, sorted_slot, gm_start, tile_color, tile_t
        )
        return tile_color, tile_t

    @staticmethod
    def backward(ctx, d_color, d_t):
        static = ctx.static
        if static.fast_fwd:
            raise ValueError(
                "cannot differentiate a fast_fwd render: RasterConfig.fast_fwd "
                "is inference-only"
            )
        inst, tile_start, sorted_slot, gm_start, tile_color, tile_t = (
            ctx.saved_tensors
        )
        cot = composite_cotangent(d_color, d_t, tile_color, tile_t)
        inst_grads = kernels.composite_backward(
            inst, tile_start, cot, **_geometry(static)
        )
        d_fields = owner_sums(inst_grads, sorted_slot, gm_start)
        return d_fields, None, None, None, None, None


def composite(
    fields: torch.Tensor, binning, static: CompositeStatic
) -> tuple[torch.Tensor, torch.Tensor]:
    """Composite per-Gaussian splats into per-tile color/transmittance.

    Args:
      fields: [N, 9] packed (mean_pix, conic, rgb, opacity) f32 in depth
        order (see pack_fields).
      binning: the frame's Binning layout.

    Returns:
      tile_color [T, PIX, 3] (premultiplied, background not applied) and
      tile_t [T, PIX] final transmittance. Differentiable in `fields`,
      except after a fast_fwd forward, whose backward raises ValueError.
    """
    return _Composite.apply(
        fields, binning.sorted_owner, binning.tile_start, binning.sorted_slot,
        binning.gm_start, static,
    )
