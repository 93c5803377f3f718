"""The work model's counts at a shape checked by hand."""

from __future__ import annotations

import pytest

from gsbench import workmodel as wm


def test_constants_add_up():
    assert wm.PREPROCESS_FLOP_PER_GAUSSIAN == 412
    assert wm.PREPROCESS_BWD_FLOP_PER_GAUSSIAN == 824
    assert wm.LOSS_FLOP_PER_CHANNEL_PIXEL == 407
    assert wm.PARAM_FLOATS_PER_GAUSSIAN == 59


def test_composite_counts_at_a_small_shape():
    # 10 pairs read, 100 live pairs, 4 pixels, 3 visible Gaussians.
    assert wm.composite_forward(10, 100, 4) == (1300, 10 * 36 + 4 * 16)
    assert wm.composite_backward(10, 100, 4, 3) == (4300, 10 * 36 + 4 * 16 + 3 * 36)


def test_roofline_takes_the_larger_bound():
    assert wm.roofline_s(67e12, 0) == pytest.approx(1.0)
    assert wm.roofline_s(0, 3.35e12) == pytest.approx(1.0)
    assert wm.roofline_s(67e12, 6.7e12) == pytest.approx(2.0)


def test_step_and_view_flops():
    g, live, pix = 2, 100, 4
    view = 412 * 2 + 13 * 100
    assert wm.view_flops(g, live, pix) == view
    assert wm.step_flops(g, live, pix) == (view + 3 * 4 * 407 + 43 * 100 + 824 * 2
                                           + 14 * 59 * 2)
