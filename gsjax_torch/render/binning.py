"""Tile binning: expand depth-ordered (gaussian, tile) instance pairs and
group them per tile for the compositor.

The layout of `gsjax.render.binning`, integer for integer:

1. Gaussians are depth-sorted first (stable), so "depth order" is "owner
   index order" and the per-tile grouping is a stable sort on the tile key
   alone.
2. Expansion is two-level and exact: gaussians expand to (gaussian, tile
   row) runs, each row's exact tile x-interval (the x-extent of the
   alpha >= 1/255 ellipse in the row's pixel strip, in closed form) gives
   its instances, and rows expand to instances. The fused level 1 is the
   row-engine kernel; the row -> instance expansion is the rank-prefix
   kernel over packed (owner << bits_tile | tile) words.
3. Per-tile ranges are raw [start, end) offsets into the sorted stream.
4. Budget overflow drops pairs deepest-first; the true counts are reported.

Everything here is integer bookkeeping without gradients, except
`permute_rows`, whose backward gathers through the inverse permutation.
"""

from __future__ import annotations

import dataclasses

import torch

from gsjax_torch.config import RasterConfig
from gsjax_torch.render import kernels


@dataclasses.dataclass
class Binning:
    """Instance layout for one frame (int32 tensors).

    perm: [N] depth order -> original gaussian index.
    sorted_owner: [P] depth-order gaussian index per sorted instance slot;
      N marks dead/overflow slots.
    sorted_slot: [P] pre-sort (expansion-order) instance index per
      tile-order slot (the tile sort's permutation).
    tile_start: [T+1] instance offsets per tile into the sorted stream.
    gm_start: [N+1] per-owner instance run boundaries in expansion order.
    num_instances: [] exact pair count over the rows that fit the row
      budget (above max_instances = instance overflow).
    num_rows: [] true (unclamped) (gaussian, tile-row) run count (above
      max_rows = row overflow).
    """

    perm: torch.Tensor
    sorted_owner: torch.Tensor
    sorted_slot: torch.Tensor
    tile_start: torch.Tensor
    gm_start: torch.Tensor
    num_instances: torch.Tensor
    num_rows: torch.Tensor


def num_tiles(height: int, width: int, tile_w: int, tile_h: int) -> tuple[int, int]:
    return -(-width // tile_w), -(-height // tile_h)


def depth_order(depth: torch.Tensor) -> torch.Tensor:
    """Stable depth-ascending permutation (ties keep original index order)."""
    return torch.sort(depth.detach(), stable=True).indices.to(torch.int32)


class _PermuteRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, perm):
        ctx.save_for_backward(perm)
        return kernels.row_gather(x.contiguous(), perm)

    @staticmethod
    def backward(ctx, ct):
        (perm,) = ctx.saved_tensors
        inverse = torch.empty_like(perm)
        inverse[perm] = torch.arange(perm.shape[0], dtype=perm.dtype, device=perm.device)
        return kernels.row_gather(ct.contiguous(), inverse), None


def permute_rows(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Rows of x (N, W) f32, W in kernels.GATHER_WIDTHS, in the order of
    the permutation perm (int32 or int64), by kernels.row_gather.

    A permutation's cotangent map is itself a permutation, so the backward
    is a row gather through the inverse permutation (one collision-free
    scatter to invert), not the generic gather transpose, a scatter-add."""
    return _PermuteRows.apply(x, perm)


def _f2i_clamped(v: torch.Tensor, hi: int) -> torch.Tensor:
    """clip(v, 0, hi) -> int32 (truncation; v is >= 0 after the clip)."""
    return torch.clamp(v, 0, hi).to(torch.int32)


def tile_rect_ext(
    mean_pix: torch.Tensor,
    ext: torch.Tensor,
    tiles_x: int,
    tiles_y: int,
    tile_w: int,
    tile_h: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Inclusive-exclusive tile rectangle from per-axis extents, clamped to
    the grid (the CUDA getRect helper with the tight rect of
    preprocess.Projected.ext). Returns (x0, y0, x1, y1) int32."""
    mp = mean_pix.detach()
    x0 = _f2i_clamped((mp[:, 0] - ext[:, 0]) / tile_w, tiles_x)
    y0 = _f2i_clamped((mp[:, 1] - ext[:, 1]) / tile_h, tiles_y)
    x1 = _f2i_clamped(torch.ceil((mp[:, 0] + ext[:, 0] + 1.0) / tile_w), tiles_x)
    y1 = _f2i_clamped(torch.ceil((mp[:, 1] + ext[:, 1] + 1.0) / tile_h), tiles_y)
    empty = (ext[:, 0] <= 0.0) | (ext[:, 1] <= 0.0)
    x1 = torch.where(empty, x0, x1)
    y1 = torch.where(empty, y0, y1)
    return x0, y0, x1, y1


# Safety margin on the alpha-threshold level of the interval cull: the
# conic determinant ca*cc - cb^2 cancels in f32 for needle-thin splats,
# which could over-tighten intervals; keeping borderline instances is
# always output-safe (the compositor's skip mask zeroes them).
CULL_QMAX_MARGIN = 1.05


def _f2i(v: torch.Tensor) -> torch.Tensor:
    """Bit-preserving f32 -> int32, so float columns ride an int32 table."""
    return v.contiguous().view(torch.int32)


def _i2f(v: torch.Tensor) -> torch.Tensor:
    return v.contiguous().view(torch.float32)


def _expand(start: torch.Tensor, budget: int) -> tuple[torch.Tensor, torch.Tensor]:
    """owner[s] for each of `budget` slots given exclusive run starts:
    boundary-mark scatter (starts >= budget dropped) + running cumsum.
    Returns (owner, slot iota), int32."""
    dev = start.device
    s = torch.arange(budget, dtype=torch.int32, device=dev)
    st = start.long()
    # Starts past the budget land in a spare last mark, sliced off: no
    # boolean selection, whose size would need a host sync (the step is
    # captured as a CUDA graph).
    marks = torch.zeros(budget + 1, dtype=torch.int32, device=dev)
    marks.index_add_(0, st.clamp(max=budget), torch.ones_like(st, dtype=torch.int32))
    owner = (torch.cumsum(marks[:budget], dim=0) - 1).to(torch.int32)
    return owner, s


def _bits(v: int) -> int:
    return max(v.bit_length(), 1)


def bin_gaussians(
    mean_pix: torch.Tensor,
    depth: torch.Tensor,
    ext: torch.Tensor,
    conic: torch.Tensor,
    qmax: torch.Tensor,
    height: int,
    width: int,
    cfg: RasterConfig,
    packed_paths: bool | None = None,
    perm: torch.Tensor | None = None,
) -> Binning:
    """Build the depth-sorted, tile-grouped instance layout.

    Args:
      mean_pix: [N,2] continuous pixel centers.
      depth: [N] view-space z (sort key; ignored when `perm` is given).
      ext: [N,2] tight pixel extents (0 = skip).
      conic: [N,3] inverse 2D covariance (a, b, c).
      qmax: [N] alpha-threshold level 2 ln(255 op).
      height/width: image dims.
      cfg: rasterizer config.
      packed_paths: None (default) takes the row-engine + packed paths when
        the bit budgets fit; False forces the gather / 3-array-sort path.
      perm: optional precomputed depth permutation; when given, all array
        inputs are already in depth order.
    """
    mean_pix = mean_pix.detach()
    conic = conic.detach()
    ext = ext.detach()
    qmax = qmax.detach()
    dev = mean_pix.device
    n = mean_pix.shape[0]
    tiles_x, tiles_y = num_tiles(height, width, cfg.tw, cfg.th)
    n_tiles = tiles_x * tiles_y
    P = cfg.max_instances
    R = cfg.max_rows

    if perm is None:
        perm = depth_order(depth)
        packed = torch.cat([mean_pix, conic, ext, qmax[:, None]], dim=-1)
        packed = permute_rows(packed, perm)  # (N, 8)
        mp, co, ex, qm = packed[:, 0:2], packed[:, 2:5], packed[:, 5:7], packed[:, 7]
    else:
        perm = perm.detach()
        mp, co, ex, qm = mean_pix, conic, ext, qmax

    x0, y0, x1, y1 = tile_rect_ext(mp, ex, tiles_x, tiles_y, cfg.tw, cfg.th)
    row_counts = y1 - y0
    rcum = torch.cumsum(row_counts, dim=0, dtype=torch.int32)
    rstart = rcum - row_counts
    total_rows = rcum[-1]
    qm_cull = _f2i(qm * CULL_QMAX_MARGIN + 1e-6)
    g_iota = torch.arange(n, dtype=torch.int32, device=dev)

    auto = packed_paths is not False
    bits_tile = _bits(n_tiles - 1)  # tile values < n_tiles
    bits_g = _bits(n - 1)  # owner values < n
    bits_p = _bits(P - 1)  # slot values < P
    bits_tile_s = _bits(n_tiles)  # sort key incl. sentinel
    p = torch.arange(P, dtype=torch.int32, device=dev)
    if auto and bits_g + bits_tile <= 32:
        zeros = torch.zeros_like(g_iota)
        table = torch.stack(
            [
                rstart, rcum, y0, x0, x1,
                _f2i(mp[:, 0]), _f2i(mp[:, 1]),
                _f2i(co[:, 0]), _f2i(co[:, 1]), _f2i(co[:, 2]),
                qm_cull, g_iota, zeros, zeros, zeros, zeros,
            ],
            dim=0,
        )  # (16, N)
        istart, delta, u, total = kernels.row_engine(
            table, total_rows, budget=R, tiles_x=tiles_x, tile_w=cfg.tw,
            tile_h=cfg.th, bits_tile=bits_tile,
        )
        w = kernels.rank_prefix(
            istart, delta, budget=P, plus_iota=True, dcum=u,
        ).to(torch.int64) & 0xFFFFFFFF
        ivalid = p < torch.clamp(total, max=P)
        g = (w >> bits_tile).to(torch.int32)
        tile = (w & ((1 << bits_tile) - 1)).to(torch.int32)
        tile = torch.where(ivalid, tile, n_tiles)  # sentinel sorts last
        g = torch.where(ivalid, g.clamp(0, n - 1), n)
        inst_of_row = torch.cat([istart, total[None]])  # [R+1]
        return _group_and_finish(
            perm, g, tile, p, inst_of_row, rstart, rcum, total, total_rows,
            n, n_tiles, P, R, bits_tile_s, bits_p, auto,
        )
    if auto:
        # Sorted-run expansion by rank (bit-identical to _expand).
        rowner = kernels.rank_prefix(
            rstart, torch.ones_like(rstart), budget=R, init=-1,
        )
        r = torch.arange(R, dtype=torch.int32, device=dev)
    else:
        rowner, r = _expand(rstart, R)
    rvalid = r < torch.clamp(total_rows, max=R)
    rg = rowner.clamp(0, n - 1).long()
    row_table = torch.stack(
        [
            rstart, y0, x0, x1,
            _f2i(mp[:, 0]), _f2i(mp[:, 1]),
            _f2i(co[:, 0]), _f2i(co[:, 1]), _f2i(co[:, 2]), qm_cull,
        ],
        dim=-1,
    )  # (N, 10) int32
    rt = row_table[rg]  # (R, 10)
    counts, tile_base = kernels.row_tiles(
        rt[:, 1].long() + (r - rt[:, 0]).long(),
        _i2f(rt[:, 4]), _i2f(rt[:, 5]),
        _i2f(rt[:, 6]), _i2f(rt[:, 7]), _i2f(rt[:, 8]), _i2f(rt[:, 9]),
        rt[:, 2], rt[:, 3], rvalid,
        tiles_x=tiles_x, tile_w=cfg.tw, tile_h=cfg.th,
    )
    inst_counts = counts.to(torch.int32)
    tile_base = tile_base.to(torch.int32)

    icum = torch.cumsum(inst_counts, dim=0, dtype=torch.int32)
    istart = icum - inst_counts
    total = icum[-1]

    # Level 2: rows -> instances (gather path).
    ivalid = p < torch.clamp(total, max=P)
    iowner, _ = _expand(istart, P)
    ir = iowner.clamp(0, R - 1).long()
    inst_table = torch.stack([istart, tile_base, rowner.clamp(0, n - 1)], dim=-1)
    it = inst_table[ir]  # (P, 3)
    tile = it[:, 1] + (p - it[:, 0])
    tile = torch.where(ivalid, tile, n_tiles)
    g = torch.where(ivalid, it[:, 2].clamp(0, n - 1), n)
    inst_of_row = torch.cat([istart, icum[-1:]])
    return _group_and_finish(
        perm, g, tile, p, inst_of_row, rstart, rcum, total, total_rows,
        n, n_tiles, P, R, bits_tile_s, bits_p, auto,
    )


def _group_and_finish(
    perm, g, tile, p, inst_of_row, rstart, rcum, total, total_rows,
    n, n_tiles, P, R, bits_tile_s, bits_p, auto,
) -> Binning:
    """Group the expanded (owner, tile) stream by tile (stable) and build
    the run boundaries — the shared tail of both expansion paths. When
    (tile, slot) fit one 32-bit word the slot rides the key's low bits:
    unique keys, so any sort gives the stable order."""
    dev = g.device
    if auto and bits_tile_s + bits_p <= 32:
        key = (tile.long() << bits_p) | p.long()
        skey, order = torch.sort(key)
        sorted_owner = g[order]
        sorted_tile = (skey >> bits_p).to(torch.int32)
        sorted_slot = (skey & ((1 << bits_p) - 1)).to(torch.int32)
        bounds = torch.arange(n_tiles + 1, dtype=torch.int64, device=dev) << bits_p
        tile_start = torch.searchsorted(skey, bounds).to(torch.int32)
    else:
        sorted_tile, order = torch.sort(tile, stable=True)
        sorted_owner = g[order]
        sorted_slot = p[order]
        bounds = torch.arange(n_tiles + 1, dtype=torch.int32, device=dev)
        tile_start = torch.searchsorted(sorted_tile, bounds).to(torch.int32)
    sorted_owner = torch.where(sorted_tile < n_tiles, sorted_owner, n).to(torch.int32)

    # Gaussian-major run boundaries: owner o's instances start at the
    # instance offset of its first row (budget-clamped).
    row_of_owner = torch.clamp(torch.cat([rstart, rcum[-1:]]), max=R).long()
    gm_start = torch.clamp(inst_of_row[row_of_owner], max=P).to(torch.int32)

    return Binning(
        perm=perm,
        sorted_owner=sorted_owner,
        sorted_slot=sorted_slot,
        tile_start=tile_start,
        gm_start=gm_start,
        num_instances=total,
        num_rows=total_rows,
    )
