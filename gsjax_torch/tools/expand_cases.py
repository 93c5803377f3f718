"""Inputs that break load-balanced expansions, for the two binning kernels
that expand sorted starts into items: row_engine (Gaussians -> tile-row
runs) and rank_prefix (runs -> slots).

Each case is made from a numpy seed and returned as numpy arrays with the
wrapper's keyword arguments, so that the CPU tests can hand the same case
to the JAX package's Pallas kernels and to the port's plain versions, and
the card tests and chip_smoke.py to the CUDA kernels. `scale="small"`
keeps budgets at a few thousand (the CPU tests); `scale="card"` makes the
same shapes at sizes where blocks and the look-back between them matter.

row_engine cases: a stretch of more Gaussians without rows than a block
spans, one Gaussian with more rows than a block (a tall view in 8x8
tiles), more rows than the budget, budgets of 1 and of a block + 1, no
rows at all, degenerate and NaN conics (every count within tiles_x; at
card scale also conics clamped to eps), and 24x16 tiles. rank_prefix
cases: one run over several blocks, a first start above 0, every start
at or past the budget, a single run, and runs of equal starts, with
full-range uint32 deltas.
"""

from __future__ import annotations

import math

import numpy as np

# Runs + Gaussians per block of csrc/row_engine.cu (kSpan), and the Pallas
# kernels' output block.
ROW_SPAN, PALLAS_BLOCK = 512, 1024


def _f32_bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


def gaussians(rng, n: int, width: int, height: int, tile_w: int, tile_h: int,
              sigma=(1.0, 30.0)) -> dict:
    """n random splats on a width x height view: centres, conics, the
    alpha level qmax (binning's culled form) and their tile rectangles from
    3-sigma extents, as bin_gaussians builds them."""
    tiles_x, tiles_y = -(-width // tile_w), -(-height // tile_h)
    mx = rng.uniform(-20.0, width + 20.0, n)
    my = rng.uniform(-20.0, height + 20.0, n)
    s1, s2 = rng.uniform(*sigma, (2, n))
    th = rng.uniform(0.0, math.pi, n)
    c, s = np.cos(th), np.sin(th)
    cxx = c * c * s1 * s1 + s * s * s2 * s2
    cyy = s * s * s1 * s1 + c * c * s2 * s2
    cxy = c * s * (s1 * s1 - s2 * s2)
    det = cxx * cyy - cxy * cxy
    op = rng.uniform(0.02, 1.0, n)
    ex, ey = 3.0 * np.sqrt(cxx), 3.0 * np.sqrt(cyy)
    return {
        "mx": mx, "my": my, "ca": cyy / det, "cb": -cxy / det, "cc": cxx / det,
        "qmax": 2.0 * np.log(255.0 * op) * 1.05 + 1e-6,
        "x0": np.clip(np.floor((mx - ex) / tile_w), 0, tiles_x),
        "x1": np.clip(np.ceil((mx + ex + 1.0) / tile_w), 0, tiles_x),
        "y0": np.clip(np.floor((my - ey) / tile_h), 0, tiles_y),
        "y1": np.clip(np.ceil((my + ey + 1.0) / tile_h), 0, tiles_y),
        "geometry": dict(tiles_x=tiles_x, tile_w=tile_w, tile_h=tile_h,
                         bits_tile=max((tiles_x * tiles_y - 1).bit_length(), 1)),
    }


def row_table(g: dict) -> tuple[np.ndarray, np.ndarray]:
    """The row engine's (16, N) int32 table (render/kernels.py TAB_*) and
    total_rows [] int32 of a `gaussians` dict."""
    y0, y1 = g["y0"].astype(np.int32), g["y1"].astype(np.int32)
    rows = np.maximum(y1 - y0, 0).astype(np.int64)
    rcum = np.cumsum(rows).astype(np.int32)
    rstart = (rcum - rows).astype(np.int32)
    n = rows.shape[0]
    zeros = np.zeros(n, np.int32)
    table = np.stack([
        rstart, rcum, y0, g["x0"].astype(np.int32), g["x1"].astype(np.int32),
        _f32_bits(g["mx"]), _f32_bits(g["my"]), _f32_bits(g["ca"]),
        _f32_bits(g["cb"]), _f32_bits(g["cc"]), _f32_bits(g["qmax"]),
        np.arange(n, dtype=np.int32), zeros, zeros, zeros, zeros,
    ]).astype(np.int32)
    return table, np.asarray(rcum[-1] if n else 0, np.int32)


def row_engine_cases(scale: str = "small", seed: int = 0) -> dict:
    """name -> dict(table, total_rows, budget, tiles_x, tile_w, tile_h,
    bits_tile). Small: budgets of 1 to 4097; card: up to 2^19."""
    big = scale == "card"
    rng = np.random.default_rng(seed)
    n = 60_000 if big else 1500
    cases = {}

    def add(name, g, budget):
        table, total = row_table(g)
        cases[name] = dict(table=table, total_rows=total, budget=int(budget),
                           **g["geometry"])

    # A stretch of Gaussians without rows, longer than any block's span.
    g = gaussians(rng, n + (5000 if big else 1200), 640, 480, 16, 16)
    lo = n // 3
    g["y1"][lo:lo + (5000 if big else 1200)] = g["y0"][lo:lo + (5000 if big else 1200)]
    add("empty_stretch", g, 1 << 19 if big else 4096)
    # One Gaussian taller than a block: 8x8 tiles on a tall view.
    height = 8 * (20_000 if big else 1500)
    g = gaussians(rng, 2000 if big else 40, 64, height, 8, 8, sigma=(1.0, 12.0))
    for i in (3, len(g["y0"]) // 2):
        g["my"][i], g["y0"][i], g["y1"][i] = height / 2, 0, height // 8
        g["ca"][i], g["cb"][i], g["cc"][i] = 0.01, 0.0, 1e-9
    add("tall_gaussian", g, 1 << 16 if big else 4096)
    # More rows than the budget.
    g = gaussians(rng, n, 640, 480, 16, 16)
    total = int(np.maximum(g["y1"] - g["y0"], 0).sum())
    add("rows_over_budget", g, max(total // 2, 1))
    # A budget of one run, and of a block's span + 1 (the CUDA kernel's and
    # the Pallas kernel's).
    g = gaussians(rng, 300, 320, 240, 16, 16)
    for budget in (1, ROW_SPAN + 1, PALLAS_BLOCK + 1):
        add(f"budget_{budget}", g, budget)
    # No Gaussian with a row.
    g = gaussians(rng, 3 * ROW_SPAN if big else 2500, 320, 240, 16, 16)
    g["y1"] = g["y0"].copy()
    add("all_empty", g, 2048)
    # Degenerate and NaN conics, negative and NaN levels, NaN centres. (An
    # infinite level would saturate the x-interval to a count past tiles_x,
    # outside the Pallas kernel's contract: its bf16 cumsum takes counts
    # <= tiles_x.)
    g = gaussians(rng, n, 640, 480, 16, 16)
    k = np.arange(n) % 8
    g["cb"][k == 1] = 10.0 * np.abs(g["ca"][k == 1]) + 1.0  # det < 0
    g["cb"][k == 2] = np.nan
    g["ca"][k == 3] = np.nan
    g["qmax"][k == 4] = -1.0
    g["qmax"][k == 5] = np.nan
    g["mx"][k == 6] = np.nan
    add("degenerate_conics", g, 1 << 18 if big else 4096)
    if big:
        # Conics clamped to eps (all zero; a negative ca): the strip edge
        # then falls where the last ulp of disc = qmax*ca - det*y^2 decides,
        # and a negative ca saturates the interval past tiles_x. The CUDA
        # kernel and the plain version (both without fused multiply-adds)
        # agree bit for bit; the Pallas kernel in interpret mode does not
        # (XLA:CPU fuses a*b - c), so this case is held on the card only.
        g = gaussians(rng, n, 640, 480, 16, 16)
        k = np.arange(n) % 4
        g["ca"][k == 0], g["cb"][k == 0], g["cc"][k == 0] = 0.0, 0.0, 0.0
        g["ca"][k == 1] = -g["ca"][k == 1]
        add("clamped_conics", g, 1 << 18)
    # A tile width that is not a power of two: the CUDA kernel divides by
    # it (by a power of two it multiplies by the exact reciprocal).
    g = gaussians(rng, n, 640, 480, 24, 16)
    add("tile_24x16", g, 1 << 18 if big else 4096)
    return cases


def _starts(counts, first: int = 0) -> np.ndarray:
    counts = np.asarray(counts, np.int64)
    return (first + np.cumsum(counts) - counts).astype(np.int32)


def rank_prefix_cases(scale: str = "small", seed: int = 0) -> dict:
    """name -> dict(start, delta (int32 holding uint32 bits), budget,
    plus_iota, init). Small: budgets of a few thousand; card: a run of
    10^5 slots and budgets up to 2^20."""
    big = scale == "card"
    rng = np.random.default_rng(seed)
    mult = 100 if big else 1
    cases = {}

    def add(name, start, budget, **kw):
        delta = rng.integers(0, 2**32, start.shape[0], dtype=np.uint64)
        cases[name] = dict(start=start, delta=delta.astype(np.uint32).view(np.int32),
                           budget=int(budget), **kw)

    # One run over several blocks, between runs of a few slots.
    counts = rng.integers(0, 6, 1000 * mult)
    counts[len(counts) // 2] = 100_000 if big else 5000
    add("long_run", _starts(counts), int(counts.sum()) + 100, plus_iota=True)
    # A first start above 0: the slots before it take no run (k = 0).
    counts = rng.integers(0, 4, 700 * mult)
    add("first_start_above_0", _starts(counts, first=777 * mult),
        3000 * mult, init=5)
    # Every start at or past the budget.
    add("all_past_budget", _starts(rng.integers(0, 4, 500 * mult), first=3000 * mult),
        3000 * mult, plus_iota=True, init=-3)
    # A single run.
    add("single_run", np.asarray([37], np.int32), 2500 * mult, plus_iota=True)
    # Runs of equal starts (empty runs: the last one wins), in the owner
    # form of binning's rank path (ones, init = -1) and with deltas.
    counts = rng.integers(0, 3, 2000 * mult) * (rng.random(2000 * mult) < 0.3)
    counts[100:1500 * mult] = 0
    start = _starts(counts)
    cases["equal_starts_owner"] = dict(
        start=start, delta=np.ones(start.shape[0], np.int32),
        budget=int(counts.sum()) + 50, init=-1)
    add("equal_starts", start, 2 * int(counts.sum()) + 7, plus_iota=True)
    return cases
