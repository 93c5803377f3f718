"""The plain versions of the two expansion kernels against the JAX
package's Pallas kernels (interpret mode), on the inputs that break
load-balanced designs (gsjax_torch/tools/expand_cases.py): row_engine_plain
against row_engine_pallas and rank_prefix_plain against
rank_prefix_pallas, bit for bit. The card tests hold the CUDA kernels to
the plain versions on the same generators at larger sizes.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsjax.render.pallas_kernels as jpk
from gsjax_torch.render import kernels
from gsjax_torch.tools import expand_cases
from tests.torch_parity import n, t

torch.set_num_threads(1)
ROW_CASES = expand_cases.row_engine_cases("small")
RANK_CASES = expand_cases.rank_prefix_cases("small")


@pytest.mark.parametrize("case", list(ROW_CASES))
def test_row_engine_plain_matches_pallas(case):
    c = ROW_CASES[case]
    geometry = {k: c[k] for k in ("budget", "tiles_x", "tile_w", "tile_h", "bits_tile")}
    want = jpk.row_engine_pallas(
        jnp.asarray(c["table"]), jnp.asarray(c["table"][0]),
        jnp.asarray(c["total_rows"]), interpret=True, **geometry,
    )
    got = kernels.row_engine_plain(t(c["table"]), t(c["total_rows"]), **geometry)
    for name, g, w in zip(("istart", "delta", "u", "total"), got, want):
        np.testing.assert_array_equal(n(g), np.asarray(w).astype(np.int32), name)
    # The case is what its name says, and inside the Pallas kernel's
    # contract (counts <= tiles_x).
    counts = np.diff(np.append(n(got[0]).astype(np.int64), int(n(got[3]))))
    assert counts.min() >= 0 and counts.max() <= c["tiles_x"]
    rows = int(c["total_rows"])
    if case == "rows_over_budget":
        assert rows > c["budget"]
    if case == "all_empty":
        assert rows == 0 and int(n(got[3])) == 0
    if case == "tall_gaussian":
        assert int(np.max(c["table"][1] - c["table"][0])) > expand_cases.PALLAS_BLOCK


@pytest.mark.parametrize("case", list(RANK_CASES))
def test_rank_prefix_plain_matches_pallas(case):
    c = RANK_CASES[case]
    kw = {k: c[k] for k in ("budget", "plus_iota", "init") if k in c}
    want = jpk.rank_prefix_pallas(
        jnp.asarray(c["start"]), jnp.asarray(c["delta"].view(np.uint32)),
        interpret=True, **kw,
    )
    got = kernels.rank_prefix_plain(t(c["start"]), t(c["delta"]), **kw)
    np.testing.assert_array_equal(n(got).view(np.uint32), np.asarray(want))


def _row_x_interval_f32(y0s, y1s, ca, cb, cc, qmax):
    """binning's closed-form row interval in numpy float32, whose sqrt is
    correctly rounded (IEEE), as the CUDA kernel's is."""
    f = np.float32
    eps = f(1e-12)
    safe_ca, safe_cc = np.maximum(ca, eps), np.maximum(cc, eps)
    det = np.maximum(ca * cc - cb * cb, eps)
    y_span = np.sqrt(np.maximum(qmax * safe_ca / det, f(0)))
    lo_y, hi_y = np.maximum(y0s, -y_span), np.minimum(y1s, y_span)
    x_star = np.sqrt(np.maximum(qmax * safe_cc / det, f(0)))
    ys_hi = np.minimum(np.maximum(-cb * x_star / safe_cc, lo_y), hi_y)
    ys_lo = np.minimum(np.maximum(cb * x_star / safe_cc, lo_y), hi_y)
    disc_hi = qmax * safe_ca - det * ys_hi * ys_hi
    disc_lo = qmax * safe_ca - det * ys_lo * ys_lo
    x_hi = (-cb * ys_hi + np.sqrt(np.maximum(disc_hi, f(0)))) / safe_ca
    x_lo = (-cb * ys_lo - np.sqrt(np.maximum(disc_lo, f(0)))) / safe_ca
    return x_lo, x_hi, lo_y <= hi_y


@pytest.mark.parametrize("case", ["degenerate_conics", "clamped_conics"])
def test_row_x_interval_rounds_as_ieee(case):
    """The plain interval math equals an IEEE float32 evaluation bit for
    bit, on every row of conics clamped to eps, where one ulp of a square
    root decides the sign of disc (torch's vectorised CPU sqrt is one ulp
    off for some inputs, so the plain version takes a correctly rounded
    one)."""
    c = expand_cases.row_engine_cases("card")[case]
    tab = c["table"]
    rows = tab[1] - tab[0]
    g = np.repeat(np.arange(tab.shape[1]), rows)
    ty = tab[2][g] + (np.arange(g.shape[0]) - tab[0][g])
    f = lambda k: tab[k].view(np.float32)[g]
    y0s = ty.astype(np.float32) * np.float32(c["tile_h"]) - f(6)
    y1s = y0s + np.float32(c["tile_h"] - 1)
    args = (y0s, y1s, f(7), f(8), f(9), f(10))
    want = _row_x_interval_f32(*args)
    got = kernels.row_x_interval(*map(torch.from_numpy, args))
    for name, a, b in zip(("x_lo", "x_hi", "nonempty"), got, want):
        np.testing.assert_array_equal(n(a), b, name)
