"""A whole run of each cell, with the harness's look for a chip skipped,
at a size the CPU holds (tiny.py): a sound run comes out correct, and each
fault the cell can have, planted under the timed path, comes out not
correct. Training: a step that returns its state unchanged; half of the
batch (of the view's pixels) left out, the mean taken over the rest.
Serving: an answer altered where it is produced (the previous request's
frame served). One chip only, so no exchange between chips to leave out."""

from __future__ import annotations

import math
import time

import pytest
import torch

from gsbench import harness, spec
from gsbench.drivers import common
from gsbench.tests import tiny

torch.set_num_threads(2)
SEED = 2**31 + 12345


@pytest.fixture(autouse=True)
def small_budgets(monkeypatch):
    from gsjax_torch.config import RasterConfig

    monkeypatch.setattr(common, "raster_config",
                        lambda cfg: RasterConfig(tile_size=cfg["tile_size"], **tiny.BUDGETS))


def run(cell: str, trace: bool = False, fault: str | None = None) -> dict:
    return harness.run(cell, SEED, 1.0, trace, device="cpu", t_start=time.perf_counter(),
                       config_override=tiny.config(spec.cell(cell)["config"]),
                       traffic_override=tiny.TRAFFIC, fault=fault)


def _keys(line: dict) -> None:
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "check"
    assert line["attempted"] > 0 and line["failed"] == 0
    for c in line["check"].values():
        assert math.isfinite(c["value"]) and c["limit"] > 0


@pytest.mark.parametrize("cell", ["m360_garden.train_late", "m360_garden.view_orbit"])
def test_a_sound_run_is_correct(cell):
    line = run(cell)
    _keys(line)
    assert line["correct"], line["check"]
    assert set(line["metrics"]) == {m["name"] for m in spec.end_to_end(cell)}


@pytest.mark.parametrize("cell,fault", [
    ("m360_garden.train_late", "unchanged"),
    ("m360_garden.train_late", "half_batch"),
    ("m360_garden.view_orbit", "stale"),
])
def test_a_fault_under_the_timed_path_is_caught(cell, fault):
    line = run(cell, fault=fault)
    assert not line["correct"], line["check"]


@pytest.mark.parametrize("cell", ["m360_garden.train_late", "m360_garden.view_orbit"])
def test_a_traced_run_reports_only_per_layer_metrics(cell):
    line = run(cell, trace=True)
    assert line["correct"]
    names = {m["name"] for m in spec.per_layer(cell)}
    assert set(line["metrics"]) <= names
    assert {"busy_s", "window_s"} <= set(line["device"])


def test_a_fault_that_plants_nothing_stops_the_run(monkeypatch):
    from gsbench.drivers import train

    monkeypatch.setattr(train._HalfLoss, "half", lambda self, fn: fn)
    with pytest.raises(RuntimeError, match="planted nothing"):
        run("m360_garden.train_late", fault="half_batch")
