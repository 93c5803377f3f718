"""Plain PyTorch tiled compositor: the twin of the composite kernels.

Walks every tile's depth-sorted instance range [tile_start[t],
tile_start[t+1]) in chunk-sized steps with the unpadded-range lane masks
of the reference kernels (a chunk at a range edge carries foreign
instances, which the mask zeroes). All tiles of a batch take their j-th
chunk together, so the walk is a short Python loop over chunk steps of
batched (tiles, PIX, chunk) tensor math; the in-chunk front-to-back
dependence is a log-space cumulative sum.

`composite_tiles` is the forward, `composite_backward_tiles` the backward
(per-instance gradients by the suffix algebra, written out: autograd
through the forward's capped alpha would give the cap a zero gradient,
where the reference's cap is straight-through). Both run on any device;
the kernel wrappers send them only CPU tensors (render/kernels.py), and
the chip smoke run times them on the card beside the kernels.
"""

from __future__ import annotations

import torch

from gsjax_torch.render.common import (
    ALPHA_CAP,
    ALPHA_SKIP,
    N_FIELDS,
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


def _chunk_falloff(f, px, py, mask):
    """Per (pixel, instance) terms of chunk fields f (tiles, K, ROWS) at
    pixels px/py (tiles, PIX, 1): dx = mx - px, dy = my - py, the falloff
    G = exp(min(power, 0)), the skip mask keep (alpha >= 1/255, power <= 0,
    lane in range) and the capped, masked alpha, each (tiles, PIX, K).
    The operation order is the kernels' (csrc/composite_walk.cuh), which
    fuse two of the power's multiply-adds."""
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
    alpha = torch.where(keep, capped, torch.zeros_like(capped))
    return dx, dy, g, keep, alpha


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


def _tile_batches(inst, tile_start, *, n_tiles, tiles_x, tile_w, tile_h,
                  chunk):
    """The chunk walk's batches of tiles: yields (t0, t1, px, py, chunks)
    for tiles [t0, t1) with pixel coordinates px/py (tb, PIX, 1); `chunks`
    yields, front to back, the slot indices idx (tb, K) of each chunk step,
    their range mask and their fields f (tb, K, ROWS)."""
    dev = inst.device
    pix = tile_w * tile_h
    p_total = inst.shape[0]
    if n_tiles == 0 or p_total == 0:
        return
    i0 = tile_start[:-1].long()
    i1 = tile_start[1:].long()
    c0 = i0 // chunk
    n_chunks = torch.where(i1 > i0, (i1 + chunk - 1) // chunk - c0, 0)
    lanes = torch.arange(chunk, device=dev)
    batch = max(1, _BATCH_ELEMS // (pix * chunk))

    def chunks(t0, t1, steps):
        for j in range(steps):
            idx = (c0[t0:t1, None] + j) * chunk + lanes  # (tb, K)
            mask = (idx >= i0[t0:t1, None]) & (idx < i1[t0:t1, None])
            yield idx, mask, inst[idx.clamp(0, p_total - 1)]

    for t0 in range(0, n_tiles, batch):
        t1 = min(n_tiles, t0 + batch)
        steps = int(n_chunks[t0:t1].max())
        if steps == 0:
            continue
        tiles = torch.arange(t0, t1, device=dev)
        px, py = tile_pixel_coords(tiles, tiles_x, tile_w, tile_h)
        yield t0, t1, px[..., None], py[..., None], chunks(t0, t1, steps)


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
) -> tuple[torch.Tensor, torch.Tensor]:
    """Composite the tile-sorted instance stream into per-tile buffers.

    Args:
      inst: (P, ROWS) f32 instance rows (common.build_inst_data).
      tile_start: (n_tiles + 1,) int32 range offsets into the stream.
      chunk: instances per walk step.
      strips: accepted for the kernels' signature; it never changes the
        output.

    Returns:
      tile_color (n_tiles, PIX, 3) premultiplied color (no background) and
      tile_t (n_tiles, PIX) final transmittance.
    """
    del strips
    dev = inst.device
    pix = tile_w * tile_h
    tile_color = torch.zeros((n_tiles, pix, 3), dtype=torch.float32, device=dev)
    tile_t = torch.ones((n_tiles, pix), dtype=torch.float32, device=dev)
    for t0, t1, px, py, chunks in _tile_batches(
        inst, tile_start, n_tiles=n_tiles, tiles_x=tiles_x, tile_w=tile_w,
        tile_h=tile_h, chunk=chunk,
    ):
        nt = t1 - t0
        t_cur = torch.ones((nt, pix, 1), dtype=torch.float32, device=dev)
        done = torch.zeros((nt, pix, 1), dtype=torch.bool, device=dev)
        acc = torch.zeros((nt, pix, 3), dtype=torch.float32, device=dev)
        for _, mask, f in chunks:
            *_, alpha = _chunk_falloff(f, px, py, mask)
            c3 = f[:, :, ROW_R:ROW_B + 1]  # (tb, K, 3)
            e_excl, skip, live, t_next = exact_step(t_cur, done, alpha)
            acc = acc + torch.bmm(alpha * t_cur * e_excl * live, c3)
            t_cur, done = t_next, skip[..., -1:]
        tile_color[t0:t1] = acc
        tile_t[t0:t1] = t_cur[..., 0]
    return tile_color, tile_t


def composite_backward_tiles(
    inst: torch.Tensor,
    tile_start: torch.Tensor,
    cot: torch.Tensor,
    *,
    n_tiles: int,
    tiles_x: int,
    tile_w: int,
    tile_h: int,
    chunk: int = 128,
    strips: int = 1,
) -> torch.Tensor:
    """Per-instance gradients of the composite, by forward-order replay.

    The suffix algebra of the reference backward (gsjax/render/common.py,
    chunk_backward) in plain f32: for instance k with weight
    w_k = alpha_k T_k and s_k = dC . color_k, the per-pixel suffix
    A' (initially sum dC * C_total + dT * T_final) drops by w_k s_k, and
      d_alpha_k = s_k T_k - A'_k / (1 - alpha_k),
    q = G d_alpha (the 0.99 cap is straight-through), d_op = sum q,
    d_rgb = sum w dC, and the mean/conic gradients chain d_power = op q
    through power = -0.5 (a dx^2 + c dy^2) - b dx dy. Skip and termination
    are the forward's own (exact_step).

    Args:
      inst: (P, ROWS) f32 instance rows, as the forward read them.
      tile_start: (n_tiles + 1,) int32 range offsets into the stream.
      cot: (n_tiles, PIX, 4) f32 per-pixel [dC_r, dC_g, dC_b, A'_0].
      chunk / strips: as in composite_tiles; neither changes the output.

    Returns:
      (P, ROWS) f32, columns [dmx, dmy, dca, dcb, dcc, dr, dg, db, dop, 0...];
      rows no tile range covers are zero.
    """
    del strips
    dev = inst.device
    pix = tile_w * tile_h
    grads = torch.zeros_like(inst)
    for t0, t1, px, py, chunks in _tile_batches(
        inst, tile_start, n_tiles=n_tiles, tiles_x=tiles_x, tile_w=tile_w,
        tile_h=tile_h, chunk=chunk,
    ):
        nt = t1 - t0
        d_color = cot[t0:t1, :, 0:3]  # (tb, PIX, 3)
        suffix = cot[t0:t1, :, 3:4]  # (tb, PIX, 1)
        t_cur = torch.ones((nt, pix, 1), dtype=torch.float32, device=dev)
        done = torch.zeros((nt, pix, 1), dtype=torch.bool, device=dev)
        for idx, mask, f in chunks:
            dx, dy, g, keep, alpha = _chunk_falloff(f, px, py, mask)
            e_excl, skip, live, t_next = exact_step(t_cur, done, alpha)
            t_before = t_cur * e_excl
            w = alpha * t_before * live  # (tb, PIX, K)
            c3 = f[:, :, ROW_R:ROW_B + 1]  # (tb, K, 3)
            s = torch.bmm(d_color, c3.transpose(1, 2))  # (tb, PIX, K)
            cum_u = torch.cumsum(w * s, dim=-1)
            d_alpha = (s * t_before - (suffix - cum_u) / (1.0 - alpha)) * live
            suffix = suffix - cum_u[..., -1:]
            q = g * d_alpha * keep
            qx, qy = q * dx, q * dy
            s_q, s_x, s_y = q.sum(1), qx.sum(1), qy.sum(1)  # (tb, K)
            s_xx, s_xy, s_yy = (qx * dx).sum(1), (qx * dy).sum(1), (qy * dy).sum(1)

            def col(i):
                return f[:, :, i]

            op = col(ROW_OP)
            g9 = torch.cat(
                [
                    torch.stack(
                        [
                            -op * (col(ROW_CA) * s_x + col(ROW_CB) * s_y),
                            -op * (col(ROW_CC) * s_y + col(ROW_CB) * s_x),
                            -0.5 * op * s_xx,
                            -op * s_xy,
                            -0.5 * op * s_yy,
                        ],
                        dim=-1,
                    ),
                    torch.bmm(w.transpose(1, 2), d_color),  # d_rgb (tb, K, 3)
                    s_q[..., None],
                ],
                dim=-1,
            )  # (tb, K, 9)
            grads[idx[mask], :N_FIELDS] = g9[mask]
            t_cur, done = t_next, skip[..., -1:]
    return grads
