"""Plain PyTorch tiled compositor: the twin of the composite kernel.

Walks every tile's depth-sorted instance range [tile_start[t],
tile_start[t+1]) in chunk-sized steps with the unpadded-range lane masks
of the reference kernels (a chunk at a range edge carries foreign
instances, which the mask zeroes). All tiles of a batch take their j-th
chunk together, so the walk is a short Python loop over chunk steps of
batched (tiles, PIX, chunk) tensor math; the in-chunk front-to-back
dependence is a log-space cumulative sum.

Forward only. It runs on any device; the kernel wrapper sends it only CPU
tensors (kernels.composite_forward), and the chip smoke run times it on the
card beside the kernel.
"""

from __future__ import annotations

import torch

from gsjax_torch.render.common import (
    ALPHA_CAP,
    ALPHA_SKIP,
    ROW_B,
    ROW_CA,
    ROW_CB,
    ROW_CC,
    ROW_MX,
    ROW_MY,
    ROW_OP,
    ROW_R,
    T_EPS,
    tile_pixel_coords,
)

# Elements of one (tiles, PIX, chunk) intermediate per tile batch.
_BATCH_ELEMS = 1 << 25


def _chunk_alpha(f, px, py, mask):
    """Capped, skip-masked alpha (tiles, PIX, K) of chunk fields f
    (tiles, K, ROWS) at pixels px/py (tiles, PIX, 1)."""
    def col(i):
        return f[:, None, :, i]

    dx = col(ROW_MX) - px
    dy = col(ROW_MY) - py
    power = -0.5 * (col(ROW_CA) * dx * dx + col(ROW_CC) * dy * dy) - (
        col(ROW_CB) * dx * dy
    )
    g = torch.exp(torch.clamp(power, max=0.0))
    capped = torch.clamp(col(ROW_OP) * g, max=ALPHA_CAP)
    keep = (capped >= ALPHA_SKIP) & (power <= 0.0) & mask[:, None, :]
    return torch.where(keep, capped, torch.zeros_like(capped))


def exact_step(t_cur, done, alpha):
    """The exact walk's skip/termination rule over one chunk.

    t_cur (tiles, PIX, 1) transmittance and done (tiles, PIX, 1) before the
    chunk; alpha (tiles, PIX, K). The contribution that would push T below
    T_EPS is itself skipped and the pixel stays done. T after lane k is
    t_in * e_excl_k * (1 - alpha_k), nonincreasing in k, so the "some lane
    <= k fired" test is one compare per lane.

    Returns e_excl (in-chunk transmittance before each lane), skip (lanes
    that add nothing), live (~skip as floats) and T after the chunk.
    """
    lg = torch.log1p(-alpha)
    e_excl = torch.exp(torch.cumsum(lg, dim=-1) - lg)
    skip = done | (t_cur * e_excl * (1.0 - alpha) < T_EPS)
    live = (~skip).to(alpha.dtype)
    t_next = t_cur * torch.exp(torch.sum(lg * live, dim=-1, keepdim=True))
    return e_excl, skip, live, t_next


def composite_tiles(
    inst: torch.Tensor,
    tile_start: torch.Tensor,
    *,
    n_tiles: int,
    tiles_x: int,
    tile_w: int,
    tile_h: int,
    chunk: int = 128,
    strips: int = 1,
    fast: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Composite the tile-sorted instance stream into per-tile buffers.

    Args:
      inst: (P, ROWS) f32 instance rows (common.build_inst_data).
      tile_start: (n_tiles + 1,) int32 range offsets into the stream.
      chunk: instances per walk step.
      strips: accepted for the kernels' signature; it never changes the
        output.
      fast: inference-only walk without per-pixel termination; a tile
        stops once every pixel's transmittance is below T_EPS.

    Returns:
      tile_color (n_tiles, PIX, 3) premultiplied color (no background) and
      tile_t (n_tiles, PIX) final transmittance.
    """
    del strips
    dev = inst.device
    pix = tile_w * tile_h
    p_total = inst.shape[0]
    tile_color = torch.zeros((n_tiles, pix, 3), dtype=torch.float32, device=dev)
    tile_t = torch.ones((n_tiles, pix), dtype=torch.float32, device=dev)
    if n_tiles == 0 or p_total == 0:
        return tile_color, tile_t
    i0 = tile_start[:-1].long()
    i1 = tile_start[1:].long()
    c0 = i0 // chunk
    n_chunks = torch.where(i1 > i0, (i1 + chunk - 1) // chunk - c0, 0)
    lanes = torch.arange(chunk, device=dev)
    batch = max(1, _BATCH_ELEMS // (pix * chunk))

    for t0 in range(0, n_tiles, batch):
        t1 = min(n_tiles, t0 + batch)
        steps = int(n_chunks[t0:t1].max())
        if steps == 0:
            continue
        tiles = torch.arange(t0, t1, device=dev)
        px, py = tile_pixel_coords(tiles, tiles_x, tile_w, tile_h)
        px, py = px[..., None], py[..., None]  # (tb, PIX, 1)
        nt = t1 - t0
        t_cur = torch.ones((nt, pix, 1), dtype=torch.float32, device=dev)
        done = torch.zeros((nt, pix, 1), dtype=torch.bool, device=dev)
        stopped = torch.zeros((nt, 1), dtype=torch.bool, device=dev)
        acc = torch.zeros((nt, pix, 3), dtype=torch.float32, device=dev)
        for j in range(steps):
            idx = (c0[t0:t1, None] + j) * chunk + lanes  # (tb, K)
            mask = (idx >= i0[t0:t1, None]) & (idx < i1[t0:t1, None])
            if fast:
                mask = mask & ~stopped
            f = inst[idx.clamp(0, p_total - 1)]  # (tb, K, ROWS)
            alpha = _chunk_alpha(f, px, py, mask)
            c3 = f[:, :, ROW_R:ROW_B + 1]  # (tb, K, 3)
            if fast:
                lg = torch.log1p(-alpha)
                cum_incl = torch.cumsum(lg, dim=-1)
                e_excl = torch.exp(cum_incl - lg)
                acc = acc + t_cur * torch.bmm(alpha * e_excl, c3)
                t_cur = t_cur * torch.exp(cum_incl[..., -1:])
                stopped = stopped | (t_cur.amax(dim=1) < T_EPS)
                continue
            e_excl, skip, live, t_next = exact_step(t_cur, done, alpha)
            acc = acc + torch.bmm(alpha * t_cur * e_excl * live, c3)
            t_cur, done = t_next, skip[..., -1:]
        tile_color[t0:t1] = acc
        tile_t[t0:t1] = t_cur[..., 0]
    return tile_color, tile_t
