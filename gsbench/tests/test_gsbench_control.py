"""On the card: the output check's control, the plain reference in TF32
put in the program's place, comes out not correct, while the program on
the same seeds comes out correct, in each cell's path at a size a test
run holds (200k Gaussians at 640x416). The control's readings at the
cells' own sizes are gsbench/calibrate.py's (PERF.md)."""

from __future__ import annotations

import time

import pytest
import torch

from gsbench import harness, spec

CELLS = ["m360_garden.train_late", "tandt_truck.train_late", "m360_garden.view_orbit"]


def override(config: str) -> dict:
    cfg = spec.config(config)
    scale = 640 / cfg["width"]
    return {"gaussians": 200_000, "images": 24, "width": 640,
            "height": int(cfg["height"] * scale) // 16 * 16,
            "assumed": dict(cfg["assumed"], focal_px=cfg["assumed"]["focal_px"] * scale)}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_where_the_program_is(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = override(spec.cell(cell)["config"])
    for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
        kw = dict(device="cuda", config_override=cfg,
                  traffic_override={"check_frames": 3, "warmup_seconds": 1.0})
        prog = harness.run(cell, seed, 2.0, False, t_start=time.perf_counter(), **kw)
        ctl = harness.run(cell, seed, 2.0, False, t_start=time.perf_counter(), control=True, **kw)
        assert prog["correct"], (seed, prog["check"])
        assert not ctl["correct"], (seed, ctl["check"])
