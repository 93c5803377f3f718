"""The 3DGS-MCMC cell's whole run at a size the CPU holds (tiny.py, the
cap at the seeded Gaussians and the sky shell above it, as in the cell, so
growth adds none; a relocation every 4 steps): a sound run comes out
correct and reports the cell's metrics; each fault the check is there for,
planted under the timed path, comes out not correct: noise replayed from
the first draw, the relocation skipped (its draws reported all the same),
the regularizers left out of the loss. A fault that plants nothing stops
the run."""

from __future__ import annotations

import time

import pytest
import torch

from gsbench import harness, spec
from gsbench.drivers import common, train_mcmc
from gsbench.tests import tiny

torch.set_num_threads(2)
SEED = 2**31 + 777
CELL = "m360_garden_mcmc.train_relocate"


@pytest.fixture(autouse=True)
def small_budgets(monkeypatch):
    from gsjax_torch.config import RasterConfig

    monkeypatch.setattr(common, "raster_config",
                        lambda cfg: RasterConfig(tile_size=cfg["tile_size"], **tiny.BUDGETS))


def config() -> dict:
    full = spec.config("m360_garden_mcmc")
    cfg = tiny.config("m360_garden_mcmc")
    return dict(cfg, mcmc=dict(full["mcmc"], cap_max=cfg["gaussians"]))


def traffic() -> dict:
    opt = dict(spec.traffic("train_relocate")["optimizer"], densification_interval=4)
    return dict(tiny.TRAFFIC, start_iteration=15000, check_start=15002, warmup_windows_max=8,
                optimizer=opt)


def run(trace: bool = False, fault: str | None = None) -> dict:
    return harness.run(CELL, SEED, 1.0, trace, device="cpu", t_start=time.perf_counter(),
                       config_override=config(), traffic_override=traffic(), fault=fault)


def test_a_sound_run_is_correct_and_reports_the_cells_metrics():
    line = run(trace=True)
    assert line["correct"], line["check"]
    assert line["attempted"] > 0 and line["failed"] == 0
    names = {m["name"] for m in spec.per_layer(CELL)}
    assert {"relocate_ms.mcmc", "dead_share.mcmc"} <= set(line["metrics"]) <= names
    assert line["metrics"]["relocate_ms.mcmc"]["value"] > 0
    line = run()
    assert line["correct"], line["check"]
    assert set(line["metrics"]) == {m["name"] for m in spec.end_to_end(CELL)}


@pytest.mark.parametrize("fault", train_mcmc.FAULTS)
def test_a_fault_under_the_timed_path_is_caught(fault):
    line = run(fault=fault)
    assert not line["correct"], (fault, line["check"])


def test_a_fault_that_plants_nothing_stops_the_run(monkeypatch):
    monkeypatch.setattr(train_mcmc.Faults, "stale_noise",
                        lambda self, *a, **k: self.noise(*a, **k))
    with pytest.raises(RuntimeError, match="planted nothing"):
        run(fault="stale_noise")
