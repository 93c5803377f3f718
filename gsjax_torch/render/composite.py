"""Tile compositing as a `torch.autograd.Function` over the instance gather
and the composite kernel.

All float inputs are depth-ordered (callers permute by binning.perm);
the integer binning products carry no gradient. The forward is the
instance gather (common.build_inst_data) and kernels.composite_forward; the
backward kernel comes with the training path.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gsjax_torch.render import kernels
from gsjax_torch.render.common import build_inst_data


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


class _Composite(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fields, sorted_owner, tile_start, static):
        inst = build_inst_data(fields, sorted_owner)
        return kernels.composite_forward(
            inst,
            tile_start,
            n_tiles=static.n_tiles,
            tiles_x=static.tiles_x,
            tile_w=static.tile_w,
            tile_h=static.tile_h,
            chunk=static.chunk,
            strips=static.strips,
            fast=static.fast_fwd,
        )

    @staticmethod
    def backward(ctx, d_color, d_t):
        raise NotImplementedError(
            "composite backward lands with the training slice"
        )


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
      tile_t [T, PIX] final transmittance.
    """
    return _Composite.apply(
        fields, binning.sorted_owner, binning.tile_start, static
    )
