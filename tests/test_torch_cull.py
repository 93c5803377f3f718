"""The composite kernels' cull, in its plain form (render/tiled.py), on the
CPU: the footprint box never excludes a (row, pixel) pair that the exact
step takes, and the plain walks taken through the per-warp masks equal the
walks without them bit for bit.

- Hypothesis cases: Gaussians' conics (covariances with the renderer's 0.3
  pixel blur, and raw conics of any sign), opacities down to the skip
  threshold, pixels on a grid about the mean, on the box's edges and one
  ulp outside them; op at ALPHA_SKIP and one ulp either side; det <= 0,
  NaN and dead (zero) rows. "Taken" is tiled.exact_step's rule on the
  plain step's alpha (tiled._chunk_falloff).
- The warp map: each shape covers its tile one-to-one, in compact blocks.
- gsjax's synthetic scene (tests/scene_utils) at 16x16 and 8x8 tiles: the
  plain forward and backward walked through the masks equal composite_tiles
  and composite_backward_tiles, and the masks drop most (row, warp) pairs.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from gsjax_torch.config import RasterConfig
from gsjax_torch.render import tiled
from gsjax_torch.render.common import (
    ALPHA_SKIP, ROW_CA, ROW_CB, ROW_CC, ROW_MX, ROW_MY, ROW_OP, ROW_R, ROWS,
)
from gsjax_torch.tools.common import instance_stream
from tests.scene_utils import look_at_origin_camera, random_scene
from tests.torch_parity import t, to_torch_camera, to_torch_params

torch.set_num_threads(1)
F32_SKIP = float(np.float32(ALPHA_SKIP))
SETTINGS = dict(max_examples=60, deadline=None, derandomize=True)


def _row(mx, my, ca, cb, cc, op):
    row = torch.zeros(ROWS, dtype=torch.float32)
    for col, v in ((ROW_MX, mx), (ROW_MY, my), (ROW_CA, ca), (ROW_CB, cb),
                   (ROW_CC, cc), (ROW_OP, op)):
        row[col] = v
    row[ROW_R:ROW_R + 3] = 0.5
    return row


def _taken(row, px, py):
    """Which pixels (px, py (M,) f32) the exact step takes row at, from
    T = 1: the plain step's skip rule, then exact_step's."""
    f = row[None, None, :]  # one tile, one row
    mask = torch.ones((1, 1), dtype=torch.bool)
    *_, alpha = tiled._chunk_falloff(f, px[None, :, None], py[None, :, None], mask)
    t_cur = torch.ones((1, px.shape[0], 1))
    _, skip, _, _ = tiled.exact_step(t_cur, t_cur < 0, alpha)
    return ~skip[0, :, 0] & (alpha[0, :, 0] > 0)


def _outside(row, px, py):
    """The kernels' test, pixel by pixel: outside the row's box."""
    hx, hy = tiled.footprint_box(row)
    mx, my = row[ROW_MX], row[ROW_MY]
    return (px - mx > hx) | (mx - px > hx) | (py - my > hy) | (my - py > hy)


def _probe_pixels(row):
    """A grid about the mean out to 1.5x the box (or 40 pixels), and the
    box's edges with their neighbours one ulp either side, as f32."""
    hx, hy = (float(h) for h in tiled.footprint_box(row))
    mx, my = float(row[ROW_MX]), float(row[ROW_MY])
    ex = 1.5 * hx if math.isfinite(hx) and hx > 0 else 40.0
    ey = 1.5 * hy if math.isfinite(hy) and hy > 0 else 40.0
    gx = np.linspace(mx - ex, mx + ex, 41, dtype=np.float32)
    gy = np.linspace(my - ey, my + ey, 41, dtype=np.float32)
    xs, ys = [gx, np.round(gx)], [gy, np.round(gy)]
    for m, h, out in ((mx, hx, xs), (my, hy, ys)):
        if math.isfinite(h) and h >= 0:
            for e in (np.float32(m + h), np.float32(m - h)):
                out.append(np.array([e, np.nextafter(e, np.float32(np.inf)),
                                     np.nextafter(e, np.float32(-np.inf)),
                                     np.floor(e), np.ceil(e)], np.float32))
    px, py = np.meshgrid(np.concatenate(xs), np.concatenate(ys))
    return t(px.ravel()), t(py.ravel())


def _check_row(row):
    px, py = _probe_pixels(row)
    taken = _taken(row, px, py)
    bad = taken & _outside(row, px, py)
    assert not bool(bad.any()), (row[:9].tolist(), px[bad][:3], py[bad][:3])
    return taken


@st.composite
def gaussians(draw):
    """A projected Gaussian: mean, covariance (scales, angle) plus the 0.3
    pixel blur, inverted to the conic as preprocess does, and an opacity
    from the skip threshold up."""
    mx = draw(st.floats(-50.0, 2000.0, width=32))
    my = draw(st.floats(-50.0, 1200.0, width=32))
    sx = draw(st.floats(0.05, 60.0))
    sy = draw(st.floats(0.05, 60.0))
    th = draw(st.floats(0.0, math.pi))
    c, s = math.cos(th), math.sin(th)
    a = c * c * sx * sx + s * s * sy * sy + 0.3
    b = c * s * (sx * sx - sy * sy)
    d = s * s * sx * sx + c * c * sy * sy + 0.3
    det = a * d - b * b
    op = draw(st.one_of(st.floats(F32_SKIP, 1.0, width=32),
                        st.floats(float(np.float32(1e-3)), 1.0, width=32)))
    return mx, my, d / det, -b / det, a / det, op


@settings(**SETTINGS)
@given(gaussians())
def test_box_holds_every_taken_pair_of_a_gaussian(g):
    row = _row(*g)
    taken = _check_row(row)
    hx, hy = (float(h) for h in tiled.footprint_box(row))
    mx, my, ca, cb, cc, op = g
    det = np.float32(ca) * np.float32(cc) - np.float32(cb) ** 2
    if math.isfinite(hx) and op >= F32_SKIP and det > 1e-2 * ca * cc:
        # Conservative, not loose: within 1 % + 0.01 px of the ellipse's
        # with its radius grown by 2^-9 of itself plus 2^-9.
        r = 2.0 * math.log(op / F32_SKIP)
        r_grown = r * (1 + 2.0 ** -9) + 2.0 ** -9
        assert hx <= math.sqrt(r_grown * cc / det) * 1.01 + 0.01
        assert hy <= math.sqrt(r_grown * ca / det) * 1.01 + 0.01
        assert bool(taken.any()) or r < 1e-2


@settings(**SETTINGS)
@given(st.floats(-100.0, 100.0, width=32), st.floats(-100.0, 100.0, width=32),
       st.floats(-4.0, 4.0, width=32), st.floats(-4.0, 4.0, width=32),
       st.floats(-4.0, 4.0, width=32), st.floats(float(np.float32(-0.1)), 2.0, width=32))
def test_box_holds_every_taken_pair_of_any_conic(mx, my, ca, cb, cc, op):
    """Raw conics of any sign (det <= 0 among them) and opacities
    outside [0, 1]."""
    _check_row(_row(mx, my, ca, cb, cc, op))


@pytest.mark.parametrize("ulps", [-1, 0, 1])
@pytest.mark.parametrize("offset", [0.0, 0.5, 0.25])
def test_box_at_the_skip_threshold(ulps, offset):
    """op = ALPHA_SKIP and one ulp either side, the mean on a pixel and off
    it: at ALPHA_SKIP or above, the pixel at the mean is taken and inside
    the box; below, nothing is."""
    op = np.float32(F32_SKIP)
    for _ in range(abs(ulps)):
        op = np.nextafter(op, np.float32(np.inf if ulps > 0 else -np.inf))
    row = _row(100.0 + offset, 60.0, 0.5, 0.1, 0.3, float(op))
    taken = _check_row(row)
    at_mean = _taken(row, t(np.float32([100.0])), t(np.float32([60.0])))
    assert bool(at_mean[0]) == (ulps >= 0 and offset == 0.0)
    if ulps < 0:
        assert not bool(taken.any())


@pytest.mark.parametrize("case", ["det_zero", "det_negative", "nan_mean",
                                  "nan_conic", "inf_conic", "far_mean", "dead"])
def test_box_of_degenerate_rows(case):
    """det <= 0, NaN and out-of-bounds rows are never culled; a dead slot's
    zero row (opacity 0) is culled everywhere, and no pixel takes it."""
    rows = {
        "det_zero": _row(10.0, 10.0, 1.0, 1.0, 1.0, 0.9),
        "det_negative": _row(10.0, 10.0, 0.5, 1.0, 0.5, 0.9),
        "nan_mean": _row(float("nan"), 10.0, 1.0, 0.0, 1.0, 0.9),
        "nan_conic": _row(10.0, 10.0, 1.0, float("nan"), 1.0, 0.9),
        "inf_conic": _row(10.0, 10.0, float("inf"), 0.0, 1.0, 0.9),
        "far_mean": _row(3e7, 10.0, 1.0, 0.0, 1.0, 0.9),
        "dead": torch.zeros(ROWS),
    }
    row = rows[case]
    px, py = (t(v.ravel()) for v in np.meshgrid(np.arange(-5, 26, dtype=np.float32),
                                               np.arange(-5, 26, dtype=np.float32)))
    outside = _outside(row, px, py)
    if case == "dead":
        assert bool(outside.all()) and not bool(_taken(row, px, py).any())
    else:
        assert not bool(outside.any())
    _check_row(row)


@pytest.mark.parametrize("tile", [(8, 8), (16, 16), (32, 32), (64, 32), (32, 16),
                                  (12, 12), (20, 8)])
@pytest.mark.parametrize("warp_w", [8, 16, 32])
def test_warp_map_covers_the_tile_in_blocks(tile, warp_w):
    tw, th = tile
    wp = tiled.warp_pixels(tw, th, warp_w)
    pix = tw * th
    assert wp.shape == (-(-pix // 32), 32)
    got = wp[wp >= 0]
    assert torch.equal(torch.sort(got).values, torch.arange(pix))
    w = tiled.warp_map(tw, th, warp_w)
    if w:  # each warp a w x (32 / w) block
        x, y = wp % tw, wp // tw
        assert bool(((x.amax(1) - x.amin(1)) == w - 1).all())
        assert bool(((y.amax(1) - y.amin(1)) == 32 // w - 1).all())
    else:
        assert torch.equal(got, torch.arange(pix))


@pytest.fixture(scope="module")
def scene():
    params, aux = random_scene(200, seed=0)
    return (to_torch_params(params), to_torch_camera(look_at_origin_camera(64, 48)),
            t(np.array(aux.alive)))


@pytest.mark.parametrize("tile", [16, 8])
def test_culled_plain_walks_equal_the_walks(scene, tile):
    params, cam, alive = scene
    cfg = RasterConfig(tile_size=tile, max_instances=1 << 14, max_rows=1 << 13)
    stream = instance_stream(params, cam, cfg, alive)
    inst, ts, geo = stream.inst, stream.tile_start, stream.geometry
    color, trans = tiled.composite_tiles(inst, ts, **geo)
    c_color, c_trans = tiled.composite_tiles(inst, ts, **geo, cull_warp_w=tiled.WARP_W)
    assert torch.equal(c_color, color) and torch.equal(c_trans, trans)
    # Bitwise, not just equal in value.
    assert torch.equal(c_color.view(torch.int32), color.view(torch.int32))
    assert torch.equal(c_trans.view(torch.int32), trans.view(torch.int32))

    rng = np.random.default_rng(tile)
    cot = t(rng.standard_normal((geo["n_tiles"], tile * tile, 4)).astype(np.float32))
    grads = tiled.composite_backward_tiles(inst, ts, cot, **geo)
    c_grads = tiled.composite_backward_tiles(inst, ts, cot, **geo,
                                             cull_warp_w=tiled.WARP_W)
    assert torch.equal(c_grads, grads) and bool((grads != 0).any())

    # The masks drop (row, warp) pairs: most of them at 16x16 (8 warps a
    # tile), some at 8x8 (2 warps, which most footprints cover).
    wp = tiled.warp_pixels(geo["tile_w"], geo["tile_h"])
    kept = total = 0
    for t0, t1, px, py, chunks in tiled._tile_batches(inst, ts, **geo, chunk=128):
        rects = tiled.warp_rects(px[..., 0], py[..., 0], wp)
        for _, mask, f in chunks:
            keep = tiled.warp_keep(f, rects) & mask[:, None, :]
            kept += int(keep.sum())
            total += int(mask.sum()) * wp.shape[0]
    assert total > 0 and kept < (0.5 if tile == 16 else 0.9) * total, (kept, total)
