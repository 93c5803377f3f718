"""BENCHMARK.json and the files it names, found by name.

Layout under gsbench/:
  configs/<config>.json   the configuration as it is run
  traffic/<mix>.json      the traffic mix's parameters; its "driver" names
                          the generator in drivers/<driver>.py that reads it
  metrics/<metric>.py     the reader of one per-layer metric: read(record)
                          returns the metric, or None where the run holds
                          nothing for it to read
  limits/<cell>.json      the limits of the cell's output check
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell(name: str, bench: dict | None = None) -> dict:
    bench = bench or benchmark()
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def _data(kind: str, name: str) -> dict:
    return json.loads((HERE / kind / f"{name}.json").read_text())


def config(name: str) -> dict:
    return _data("configs", name)


def traffic(name: str) -> dict:
    return _data("traffic", name)


def limits(cell_name: str) -> dict:
    return _data("limits", cell_name)


def driver(name: str):
    return importlib.import_module(f"gsbench.drivers.{name}")


def applies(metric: dict, cell_name: str, bench: dict) -> bool:
    """Whether a metric is reported in a cell: it lists the cell, or it
    lists none and the end-to-end metric it moves is reported there."""
    if "workloads" in metric:
        return cell_name in metric["workloads"]
    if "moves" in metric:
        moved = next(m for m in bench["end_to_end"] if m["name"] == metric["moves"])
        return applies(moved, cell_name, bench)
    return True


def end_to_end(cell_name: str, bench: dict | None = None) -> list[dict]:
    bench = bench or benchmark()
    return [m for m in bench["end_to_end"] if applies(m, cell_name, bench)]


def per_layer(cell_name: str, bench: dict | None = None) -> list[dict]:
    bench = bench or benchmark()
    return [m for m in bench["per_layer"] if applies(m, cell_name, bench)]


def reader(metric_name: str):
    """The read(record) function of a per-layer metric."""
    path = HERE / "metrics" / f"{metric_name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        "gsbench.metrics." + metric_name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read
