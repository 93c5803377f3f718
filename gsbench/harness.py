"""One run of one cell: the driver's set-up, window and check, the
per-layer readers, the limits, and the result line."""

from __future__ import annotations

import gc
import math
import sys

from gsbench import spec

FORBIDDEN = ("jax", "jaxlib", "flax", "gsjax")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's, flax's
    or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def judge(numbers: dict[str, float], limits: dict[str, dict]) -> tuple[bool, dict]:
    """Each compared number beside its limit; correct when every number
    is finite and at most its limit."""
    out, ok = {}, True
    for name, lim in limits.items():
        v = numbers.get(name)
        good = v is not None and math.isfinite(v) and v <= lim["limit"]
        ok = ok and good
        out[name] = {"value": v, "limit": lim["limit"]}
    return ok, out


def run(workload: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
        t_start: float, config_override: dict | None = None,
        traffic_override: dict | None = None, fault: str | None = None,
        control: bool = False) -> dict:
    """The result line of one run (without printing it). config_override
    updates the configuration (tests run the cell's path at a small
    size, with traffic_override); fault breaks the timed path underneath (the check's test);
    control runs the lower-precision reference in the program's place
    where the driver offers it."""
    bench = spec.benchmark()
    cell = spec.cell(workload, bench)
    cfg = spec.config(cell["config"])
    if config_override:
        cfg = {**cfg, **config_override}
    traffic = {**spec.traffic(cell["traffic"]), **(traffic_override or {})}
    drv = spec.driver(traffic["driver"])
    res = drv.run(cfg, traffic, seed=seed, seconds=seconds, trace=trace, device=device,
                  t_start=t_start, fault=fault, control=control)
    gc.collect()

    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    metrics = {}
    if trace:
        for m in spec.per_layer(workload, bench):
            v = spec.reader(m["name"])(res["record"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": units[m["name"]]}
    else:
        for m in spec.end_to_end(workload, bench):
            metrics[m["name"]] = {"value": res["e2e"][m["name"]], "unit": units[m["name"]]}
    correct, check = judge(res["numbers"], spec.limits(workload)["numbers"])
    line = {
        "correct": correct and res["failed"] == 0,
        "attempted": res["attempted"],
        "failed": res["failed"],
        "metrics": metrics,
        "device": res["device"],
    }
    if trace and res.get("breakdown"):
        line["breakdown"] = res["breakdown"]
    line["check"] = check
    return line
