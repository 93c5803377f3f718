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

The kernels' cull, in plain form: `warp_pixels` is the kernels' warp map
(which pixels each warp of a tile covers), `footprint_box` the box about
a row's mean outside of which the exact step skips it, and `warp_keep`
the per-warp mask of the rows whose box meets the warp's pixels. Given
`cull_warp_w`, both walks mask every pixel's rows by its warp's mask, as
the kernels do; the output is the same bit for bit.
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

# The main kernels' warp map: a warp covers WARP_W x (32 // WARP_W) pixels
# (csrc/composite_walk.cuh kWarpW).
WARP_W = 8

# The footprint box's bounds and margins (csrc/composite_walk.cuh).
_BOX_COORD_MAX = 2.0 ** 24
_BOX_CONIC_MAX = 2.0 ** 40
_BOX_SHRINK = 2.0 ** -16
_BOX_ETA = 2.0 ** -10
_BOX_GROW = 1.0 + 2.0 ** -9
_BOX_DET_MIN = 2.0 ** -10


def warp_map(tile_w: int, tile_h: int, warp_w: int = WARP_W) -> int:
    """The warp width the kernels use for this tile: warp_w when warp_w x
    (32 // warp_w) blocks tile it exactly, else 0 (the row-major map)."""
    fits = warp_w > 0 and tile_w % warp_w == 0 and tile_h % (32 // warp_w) == 0
    return warp_w if fits else 0


def warp_pixels(tile_w: int, tile_h: int, warp_w: int = WARP_W,
                device=None) -> torch.Tensor:
    """The kernels' warp map: (W, 32) int64, the row-major tile pixel of
    each lane of each of the tile's W = ceil(PIX / 32) warps (-1 where a
    lane has none). Virtual thread v = 32 w + l: with the row-major map it
    takes pixel v; else warp w takes block w of the tile's warp_w x
    (32 // warp_w) blocks in row-major order and lane l the block's pixel
    (l % warp_w, l // warp_w)."""
    pix = tile_w * tile_h
    w = warp_map(tile_w, tile_h, warp_w)
    v = torch.arange(-(-pix // 32) * 32, device=device)
    if w == 0:
        p = v
    else:
        b, lane = v // 32, v % 32
        blocks_x = tile_w // w
        x = (b % blocks_x) * w + lane % w
        y = (b // blocks_x) * (32 // w) + lane // w
        p = y * tile_w + x
    return torch.where(v < pix, p, -1).reshape(-1, 32)


def footprint_box(rows: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Half-widths (hx, hy) of each instance row's footprint box (rows
    (..., ROWS) f32): the exact step skips the row at every pixel with
    |mx - px| > hx or |my - py| > hy. The step takes a pair only if
    Q = ca dx^2 + 2 cb dx dy + cc dy^2 <= r = 2 ln(op / ALPHA_SKIP), and
    that ellipse lies inside |dx| <= sqrt(r cc / det), |dy| <= sqrt(r ca /
    det), det = ca cc - cb^2; the box inflates it to cover f32 rounding.
    -inf: skipped everywhere (op <= 0, or a negative radius); +inf: never
    culled (a row where the walk's arithmetic could overflow, ca or cc
    outside [2^-40, 2^40], a near-degenerate or indefinite conic, NaN)."""
    def col(i):
        return rows[..., i]

    mx, my, ca, cb, cc, op = (col(i) for i in (ROW_MX, ROW_MY, ROW_CA, ROW_CB,
                                               ROW_CC, ROW_OP))
    in_range = (
        (mx.abs() <= _BOX_COORD_MAX) & (my.abs() <= _BOX_COORD_MAX)
        & (ca.abs() <= _BOX_CONIC_MAX) & (cb.abs() <= _BOX_CONIC_MAX)
        & (cc.abs() <= _BOX_CONIC_MAX) & (op.abs() <= _BOX_CONIC_MAX)
    )
    r = 2.0 * torch.log(op / ALPHA_SKIP)
    rs = r + r.abs() * _BOX_ETA + _BOX_ETA
    everywhere = in_range & ((op <= 0.0) | (rs < 0.0))
    a = ca * (1.0 - _BOX_SHRINK)
    c = cc * (1.0 - _BOX_SHRINK)
    det = a * c - cb * cb
    boxed = (in_range & ~everywhere & (ca >= 1.0 / _BOX_CONIC_MAX)
             & (cc >= 1.0 / _BOX_CONIC_MAX) & (det > _BOX_DET_MIN * (ca * cc)))
    inf = torch.full_like(mx, float("inf"))

    def half(num):
        h = torch.sqrt(rs * num / det) * _BOX_GROW + _BOX_ETA
        return torch.where(everywhere, -inf, torch.where(boxed, h, inf))

    return half(c), half(a)


def warp_rects(px: torch.Tensor, py: torch.Tensor,
               warp_px: torch.Tensor) -> torch.Tensor:
    """(..., W, 4) f32 rectangles (x0, x1, y0, y1) of the pixels of each
    warp (warp_px (W, 32), as warp_pixels gives it) at pixel coordinates
    px/py (..., PIX); a warp with no pixel gets x0 = y0 = inf, x1 = y1 =
    -inf."""
    valid = warp_px >= 0
    idx = warp_px.clamp(min=0)
    inf = float("inf")
    out = []
    for c in (px, py):
        vals = c[..., idx]  # (..., W, 32)
        out += [torch.where(valid, vals, inf).amin(-1),
                torch.where(valid, vals, -inf).amax(-1)]
    return torch.stack(out, dim=-1)


def warp_keep(f: torch.Tensor, rects: torch.Tensor) -> torch.Tensor:
    """The kernels' per-warp cull mask: (tb, W, K) bool, true where row k
    of chunk fields f (tb, K, ROWS) has a footprint box that meets warp
    w's rectangle (rects (tb, W, 4)). A false entry is a row every pixel
    of the warp skips; a NaN keeps the row."""
    hx, hy = (h[:, None, :] for h in footprint_box(f))
    mx, my = f[:, None, :, ROW_MX], f[:, None, :, ROW_MY]
    x0, x1, y0, y1 = (rects[..., j, None] for j in range(4))
    outside = (x0 - mx > hx) | (mx - x1 > hx) | (y0 - my > hy) | (my - y1 > hy)
    return ~outside


def _chunk_falloff(f, px, py, mask):
    """Per (pixel, instance) terms of chunk fields f (tiles, K, ROWS) at
    pixels px/py (tiles, PIX, 1): dx = mx - px, dy = my - py, the falloff
    G = exp(min(power, 0)), the skip mask keep (alpha >= 1/255, power <= 0,
    lane in range) and the capped, masked alpha, each (tiles, PIX, K).
    The operation order is the kernels' (csrc/composite_walk.cuh), which
    fuse two of the power's multiply-adds. `mask` is (tiles, K), or
    (tiles, PIX, K) for a per-pixel mask (the cull)."""
    def col(i):
        return f[:, None, :, i]

    if mask.dim() == 2:
        mask = mask[:, None, :]

    dx = col(ROW_MX) - px
    dy = col(ROW_MY) - py
    power = -0.5 * (col(ROW_CA) * dx * dx + col(ROW_CC) * dy * dy) - (
        col(ROW_CB) * dx * dy
    )
    g = torch.exp(torch.clamp(power, max=0.0))
    capped = torch.clamp(col(ROW_OP) * g, max=ALPHA_CAP)
    keep = (capped >= ALPHA_SKIP) & (power <= 0.0) & mask
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
                  chunk, cull_warp_w=None):
    """The chunk walk's batches of tiles: yields (t0, t1, px, py, chunks)
    for tiles [t0, t1) with pixel coordinates px/py (tb, PIX, 1); `chunks`
    yields, front to back, the slot indices idx (tb, K) of each chunk step,
    their range mask (tb, K) and their fields f (tb, K, ROWS). With
    cull_warp_w the mask is (tb, PIX, K): the range mask and the cull mask
    of each pixel's warp under that warp map."""
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

    if cull_warp_w is not None:
        warp_px = warp_pixels(tile_w, tile_h, cull_warp_w, device=dev)
        # Each pixel's warp (every pixel has one).
        pixel_warp = torch.empty(pix, dtype=torch.long, device=dev)
        valid = warp_px >= 0
        pixel_warp[warp_px[valid]] = torch.nonzero(valid)[:, 0]

    def chunks(t0, t1, steps, rects):
        for j in range(steps):
            idx = (c0[t0:t1, None] + j) * chunk + lanes  # (tb, K)
            mask = (idx >= i0[t0:t1, None]) & (idx < i1[t0:t1, None])
            f = inst[idx.clamp(0, p_total - 1)]
            if rects is not None:
                mask = mask[:, None, :] & warp_keep(f, rects)[:, pixel_warp]
            yield idx, mask, f

    for t0 in range(0, n_tiles, batch):
        t1 = min(n_tiles, t0 + batch)
        steps = int(n_chunks[t0:t1].max())
        if steps == 0:
            continue
        tiles = torch.arange(t0, t1, device=dev)
        px, py = tile_pixel_coords(tiles, tiles_x, tile_w, tile_h)
        rects = None if cull_warp_w is None else warp_rects(px, py, warp_px)
        yield t0, t1, px[..., None], py[..., None], chunks(t0, t1, steps, rects)


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
    cull_warp_w: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Composite the tile-sorted instance stream into per-tile buffers.

    Args:
      inst: (P, ROWS) f32 instance rows (common.build_inst_data).
      tile_start: (n_tiles + 1,) int32 range offsets into the stream.
      chunk: instances per walk step.
      strips: accepted for the kernels' signature; it never changes the
        output.
      cull_warp_w: walk each pixel through its warp's cull mask under this
        warp map, as the kernels do; it never changes the output.

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
        tile_h=tile_h, chunk=chunk, cull_warp_w=cull_warp_w,
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
    cull_warp_w: int | None = None,
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
      chunk / strips / cull_warp_w: as in composite_tiles; none changes
        the output.

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
        tile_h=tile_h, chunk=chunk, cull_warp_w=cull_warp_w,
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
            in_range = mask if mask.dim() == 2 else mask.any(dim=1)
            grads[idx[in_range], :N_FIELDS] = g9[in_range]
            t_cur, done = t_next, skip[..., -1:]
    return grads
