"""Mean squared distance to the 3 nearest neighbors, for scale init.

The port of `gsjax.knn.mean_knn_dist2`, the stand-in for the simple-knn
submodule's `distCUDA2(points) -> [N]` (reference:
scene/gaussian_model.py:20,134). It runs once at scene init, in plain
torch on the points' device, when the native library is unavailable.

Exact, blocked: pairwise squared distances in blocks with a running top-3,
self masked, slots left unmatched (n <= 3) counted as 0. Two choices
differ from gsjax's TPU form, and neither changes which neighbours count:
* distances are summed coordinate differences, as the native library
  computes them, not |r|^2 - 2 r.c + |c|^2: that form cancels to ~1e-5
  absolute on scenes a few units from the origin, a relative error of
  ~1e-2 on the bench scene's spacing; and it needs no matmul, so no TF32;
* rows go in blocks of Morton order, and each block meets only the points
  inside its bounding box grown by the largest third distance it found
  among its Morton neighbours. No nearer point lies outside that box, so
  the top-3 is still exact, and the work is ~N * block instead of N^2.
"""

from __future__ import annotations

import torch

ROW_BLOCK = 1024
COL_BLOCK = 8192
_MORTON_BITS = 10


def _morton(points: torch.Tensor) -> torch.Tensor:
    """[N] int64 Morton codes of the points on a 2^10 grid over their box."""
    lo = points.min(0).values
    span = (points.max(0).values - lo).clamp(min=1e-30)
    top = (1 << _MORTON_BITS) - 1
    q = ((points - lo) / span * top).to(torch.int64).clamp(0, top)
    code = torch.zeros(points.shape[0], dtype=torch.int64, device=points.device)
    for b in range(_MORTON_BITS):
        for axis in range(3):
            code |= ((q[:, axis] >> b) & 1) << (3 * b + axis)
    return code


def _top3(rows, row_ids, cols, col_ids, best, col_block):
    """Merge cols into each row's ascending [rb, 3] smallest squared
    distances; a column with the row's own id is skipped."""
    for c0 in range(0, cols.shape[0], col_block):
        c = cols[c0:c0 + col_block]
        d2 = None
        for axis in range(3):
            d = rows[:, axis:axis + 1] - c[None, :, axis]
            d2 = d * d if d2 is None else d2 + d * d
        own = row_ids[:, None] == col_ids[None, c0:c0 + col_block]
        d2 = d2.masked_fill(own, float("inf"))
        best = torch.cat([best, d2], 1).topk(3, dim=1, largest=False).values
    return best


def mean_knn_dist2(
    points: torch.Tensor, row_block: int = ROW_BLOCK, col_block: int = COL_BLOCK
) -> torch.Tensor:
    """[N,3] points -> [N] mean squared distance to the 3 nearest neighbors
    (excluding self), on the points' device."""
    n = points.shape[0]
    dev = points.device
    pts = points.to(torch.float32)
    if n == 0:
        return torch.zeros(0, dtype=torch.float32, device=dev)
    order = torch.argsort(_morton(pts))
    sp = pts[order]
    ids = torch.arange(n, device=dev)
    # Rounding margin of the box test: a few ulps of the largest coordinate.
    ulps = 1e-6 * float(sp.abs().max())
    out = torch.empty(n, dtype=torch.float32, device=dev)
    three = torch.tensor(3.0, device=dev)
    for r0 in range(0, n, row_block):
        r1 = min(r0 + row_block, n)
        rows, row_ids = sp[r0:r1], ids[r0:r1]
        w0, w1 = max(r0 - row_block, 0), min(r1 + row_block, n)
        init = torch.full((r1 - r0, 3), float("inf"), device=dev)
        best = _top3(rows, row_ids, sp[w0:w1], ids[w0:w1], init, col_block)
        reach = float(best[:, 2].max().sqrt()) * 1.001 + ulps
        lo, hi = rows.min(0).values - reach, rows.max(0).values + reach
        inside = ((sp >= lo) & (sp <= hi)).all(1)
        inside[w0:w1] = False
        cand = torch.nonzero(inside).squeeze(1)
        if cand.numel():
            best = _top3(rows, row_ids, sp[cand], cand, best, col_block)
        best = torch.where(torch.isfinite(best), best, torch.zeros_like(best))
        # A tensor divisor: CUDA divides by a Python scalar as a product
        # with its reciprocal, an ulp from the CPU's quotient.
        out[r0:r1] = (best[:, 0] + best[:, 1] + best[:, 2]) / three
    result = torch.empty_like(out)
    result[order] = out
    return result
