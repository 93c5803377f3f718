"""BENCHMARK.json keeps to the benchmark's contract, and every part a
cell names is found by name."""

from __future__ import annotations

import json
import re

import pytest

from gsbench import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def _text(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16 and all(PATH.match(p) for p in BENCH["paths"])
    assert 1 <= len(BENCH["command"]) <= 32 and all(_text(w) for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


def test_every_name_unit_and_text_keeps_to_the_allowed_characters():
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    names += [w["traffic"] for w in BENCH["workloads"]] + [w["config"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    assert len(set(CELLS)) == len(CELLS)
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    texts = ([c["source"] for c in BENCH["configs"]] + [c["why"] for c in BENCH["configs"]]
             + [w["why"] for w in BENCH["workloads"]] + [m["layer"] for m in BENCH["per_layer"]])
    assert all(_text(t) for t in texts)


def test_metric_entries_and_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        for w in m.get("workloads", []):
            assert spec.applies(e2e[m["moves"]], w, BENCH), (m["name"], w)


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_finds_its_parts_by_name(cell):
    w = spec.cell(cell)
    assert w["chips"] in (1, 4)
    cfg = spec.config(w["config"])
    entry = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    assert entry["file"] == f"gsbench/configs/{w['config']}.json"
    assert cfg["reduced"] == entry["reduced"]
    traffic = spec.traffic(w["traffic"])
    assert callable(spec.driver(traffic["driver"]).run)
    assert spec.limits(cell)["numbers"]
    e2e = [m["name"] for m in spec.end_to_end(cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    layers = spec.per_layer(cell)
    assert layers
    for m in layers:
        assert callable(spec.reader(m["name"]))
        assert m["moves"] in e2e


def test_configs_are_each_used_and_lie_under_paths():
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert used == {c["name"] for c in BENCH["configs"]}
    assert len(set(files)) == len(files)
    assert all(any(f.startswith(p + "/") for p in BENCH["paths"]) for f in files)
    for c in BENCH["configs"]:
        json.loads((spec.ROOT / c["file"]).read_text())


def test_readers_return_nothing_without_a_trace():
    empty = {"gaussians": 10}
    for m in BENCH["per_layer"]:
        assert spec.reader(m["name"])(empty) is None, m["name"]
