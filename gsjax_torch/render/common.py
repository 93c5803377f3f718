"""Shared compositing layout: instance-stream fields, constants, pixel
coordinates, the instance gather and the untiling.

Compositing semantics mirror the CUDA renderCUDA loop (see oracle.py):
  alpha   = min(0.99, opacity * exp(power)),  power = -0.5 d^T conic d
  skip    alpha < 1/255 or power > 0
  done    when T * (1 - alpha) < 1e-4 (that contribution is not applied)

The instance stream is (P, ROWS) row-major: one 64-byte row per
(gaussian, tile) instance, fields at the ROW_* columns.
"""

from __future__ import annotations

import torch

# Instance-stream field columns.
ROW_MX = 0  # mean x, continuous pixels
ROW_MY = 1  # mean y
ROW_CA = 2  # conic a (xx)
ROW_CB = 3  # conic b (xy)
ROW_CC = 4  # conic c (yy)
ROW_R = 5  # color r
ROW_G = 6  # color g
ROW_B = 7  # color b
ROW_OP = 8  # opacity (activated)
N_FIELDS = 9
ROWS = 16  # row width: 64-byte instance rows

ALPHA_CAP = 0.99
ALPHA_SKIP = 1.0 / 255.0
T_EPS = 1e-4


def tile_pixel_coords(
    tile_id: torch.Tensor, tiles_x: int, tile_w: int, tile_h: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Continuous pixel coordinates of the pixels of tiles `tile_id` [...],
    shape [..., PIX]; pixel order within a tile is row-major
    (idx = row * tile_w + col)."""
    idx = torch.arange(tile_w * tile_h, device=tile_id.device)
    tx = (tile_id % tiles_x)[..., None]
    ty = (tile_id // tiles_x)[..., None]
    px = (tx * tile_w + idx % tile_w).to(torch.float32)
    py = (ty * tile_h + idx // tile_w).to(torch.float32)
    return px, py


def build_inst_data(
    fields: torch.Tensor, sorted_owner: torch.Tensor
) -> torch.Tensor:
    """Gather depth-ordered per-Gaussian fields [N, N_FIELDS] into the
    tile-sorted instance stream (P, ROWS) with one row gather
    (kernels.row_gather, at binning's int32 owners); dead slots (owner ==
    N) read a zero row whose opacity 0 makes them no-ops."""
    # Imported here: kernels imports tiled, which imports this module.
    from gsjax_torch.render import kernels

    padded = torch.nn.functional.pad(fields, (0, ROWS - N_FIELDS, 0, 1))
    return kernels.row_gather(padded, sorted_owner)


def untile_image(
    tile_color: torch.Tensor,
    tile_t: torch.Tensor,
    height: int,
    width: int,
    tiles_x: int,
    tiles_y: int,
    tile_w: int,
    tile_h: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """[T, PIX, 3] tiles -> ([3, H, W] color, [H, W] transmittance), cropped
    to the true image size."""
    c = tile_color.reshape(tiles_y, tiles_x, tile_h, tile_w, 3)
    c = c.permute(4, 0, 2, 1, 3).reshape(
        3, tiles_y * tile_h, tiles_x * tile_w
    )[:, :height, :width]
    t = tile_t.reshape(tiles_y, tiles_x, tile_h, tile_w)
    t = t.permute(0, 2, 1, 3).reshape(tiles_y * tile_h, tiles_x * tile_w)[
        :height, :width
    ]
    return c, t
