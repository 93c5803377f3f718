"""Tile-slab-sharded rendering (gsjax/parallel/render.py).

Each rank of the mesh's "tile" dimension rasterizes a horizontal slab of
tile rows against the full (replicated) Gaussian set: preprocess is
recomputed on every rank (O(N)); binning and the composite kernels run on
the local slab only, so the per-pixel work is 1/n_tile per rank.

Slab geometry: the image is padded to whole tile rows; tile rank i owns
tile rows [i*rows, (i+1)*rows). Splat math is translation invariant, so a
slab is rendered by shifting mean_pix.y by -py0 and binning against a
slab-local tile grid; the last slab may extend past the image and is
cropped after the gather.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from gsjax_torch.config import RasterConfig
from gsjax_torch.core.cameras import Camera
from gsjax_torch.model import GaussianParams
from gsjax_torch.parallel.mesh import dim_size
from gsjax_torch.render.binning import bin_gaussians, depth_order, num_tiles, permute_rows
from gsjax_torch.render.common import untile_image
from gsjax_torch.render.composite import CompositeStatic, composite, pack_fields
from gsjax_torch.render.preprocess import preprocess


def slab_rows(height: int, n_tile: int, tile_h: int) -> int:
    """Tile rows per tile rank; the padded tile grid is split evenly (the
    last rank's slab may extend past the true image and is cropped after
    the gather)."""
    tiles_y = -(-height // tile_h)
    return -(-tiles_y // n_tile)


def composite_slab(
    mean_pix: torch.Tensor,
    conic: torch.Tensor,
    rgb: torch.Tensor,
    opacity: torch.Tensor,
    depth: torch.Tensor,
    ext: torch.Tensor,
    qmax: torch.Tensor,
    *,
    height: int,
    width: int,
    cfg: RasterConfig,
    py0: float,
    rows: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Bin + composite preprocessed Gaussians into the slab of `rows` tile
    rows starting at pixel row `py0`. Differentiable in (mean_pix, conic,
    rgb, opacity); depth, ext and qmax only steer binning.

    Returns (color [3, rows*th, W_pad], transmittance [rows*th, W_pad],
    counts [num_instances, num_rows] int32): the uncropped tile-space slab,
    no background applied.
    """
    tiles_x, _ = num_tiles(height, width, cfg.tw, cfg.th)
    slab_px = rows * cfg.th
    w_pad = tiles_x * cfg.tw

    mean_local = torch.cat([mean_pix[:, :1], mean_pix[:, 1:] - py0], dim=1)

    # One fused N-rate depth permute for binning and the composite fields,
    # as render.api.depth_sorted_bins does.
    perm = depth_order(depth)
    fields12 = torch.cat(
        [pack_fields(mean_local, conic, rgb, opacity), ext, qmax[:, None]], dim=-1)
    f12 = permute_rows(fields12, perm)
    binning = bin_gaussians(
        f12[:, 0:2], depth, f12[:, 9:11], f12[:, 2:5], f12[:, 11],
        slab_px, w_pad, cfg, perm=perm,
    )
    static = CompositeStatic(
        n_tiles=tiles_x * rows,
        tiles_x=tiles_x,
        tile_w=cfg.tw,
        tile_h=cfg.th,
        chunk=cfg.chunk,
        strips=cfg.strips,
        fast_fwd=cfg.fast_fwd,
    )
    tile_color, tile_t = composite(f12[:, 0:9], binning, static)
    color, transmittance = untile_image(
        tile_color, tile_t, slab_px, w_pad, tiles_x, rows, cfg.tw, cfg.th)
    counts = torch.stack([binning.num_instances, binning.num_rows])
    return color, transmittance, counts


def render_slab(
    params: GaussianParams,
    camera: Camera,
    *,
    active_sh_degree: int,
    cfg: RasterConfig,
    py0: float,
    rows: int,
    scaling_modifier: float = 1.0,
    mean2d_offset: torch.Tensor | None = None,
    alive: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rasterize the slab of `rows` tile rows starting at pixel row `py0`.

    Returns (color [3, rows*th, W_pad], transmittance [rows*th, W_pad],
    radii [N] int32, counts [num_instances, num_rows] int32): the uncropped
    tile-space slab, no background applied (the background is composited
    after the gather).
    """
    proj = preprocess(
        xyz=params.xyz,
        sh=params.get_features(),
        opacity=params.get_opacity(),
        scaling=params.get_scaling(),
        rotation=params.rotation,
        camera=camera,
        active_sh_degree=active_sh_degree,
        scaling_modifier=scaling_modifier,
        mean2d_offset=mean2d_offset,
        alive=alive,
    )
    color, transmittance, counts = composite_slab(
        proj.mean_pix, proj.conic, proj.rgb, proj.opacity,
        proj.depth, proj.ext, proj.qmax,
        height=camera.height, width=camera.width, cfg=cfg, py0=py0, rows=rows,
    )
    return color, transmittance, proj.radius, counts


@torch.no_grad()
def render_sharded(
    params: GaussianParams,
    camera: Camera,
    *,
    mesh,
    active_sh_degree: int,
    bg_color: torch.Tensor,
    cfg: RasterConfig = RasterConfig(),
    scaling_modifier: float = 1.0,
    alive: torch.Tensor | None = None,
) -> torch.Tensor:
    """Render one view with its tile rows sharded over the mesh's "tile"
    dimension; every rank calls it with the same arguments.

    Gaussians are replicated; each tile rank rasterizes its slab; the
    slabs are gathered over the "tile" group (all_gather), cropped to
    [3, H, W] and composited with the background. Every data group
    computes the same image. Returns the image on every rank.
    """
    n_tile = dim_size(mesh, "tile")
    ts = cfg.th
    rows = slab_rows(camera.height, n_tile, ts)
    t_idx = mesh.get_local_rank("tile")
    color, t, _, _ = render_slab(
        params, camera, active_sh_degree=active_sh_degree, cfg=cfg,
        py0=float(t_idx * rows * ts), rows=rows, scaling_modifier=scaling_modifier,
        alive=alive,
    )
    # One gather of color and transmittance as a [4, slab, W_pad] block.
    block = torch.cat([color, t[None]], dim=0).contiguous()
    slabs = [torch.empty_like(block) for _ in range(n_tile)]
    dist.all_gather(slabs, block, group=mesh.get_group("tile"))
    full = torch.cat(slabs, dim=1)[:, : camera.height, : camera.width]
    return full[:3] + full[3][None] * bg_color[:, None, None]
