"""The readings the output check's limits are set from, on the card.

    python3 gsbench/calibrate.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--seconds 2]

Prints one JSON line per seed and kind: "program" (what the timed path
produced against the plain reference), "control" (the reference in TF32
in the program's place) and, for training cells, "fault_half_batch" (the
reference with half of each view's pixels left out of the loss). Training
cells read their checked steps without a measured window, in one process;
serving cells run a short window of `--seconds` at the cell's own load.
"""

from __future__ import annotations

import argparse
import gc
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def train_readings(cell: dict, seeds: list[int], control_seeds: set[int]) -> None:
    import torch

    from gsbench import spec
    from gsbench.drivers import train as drv
    from gsjax_torch.train.step import drop_step_graphs

    cfg, traffic = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    dev = torch.device("cuda")
    for seed in seeds:
        r = drv.Run(cfg, traffic, seed, dev, None)
        try:
            r.warm_up()
            r.restore_seed_state()
            prog = r.checked_steps()
        finally:
            r.close()
        del r
        drop_step_graphs()
        gc.collect()
        torch.cuda.empty_cache()
        ref = drv.reference_readings(cfg, traffic, seed, prog["views"], dev)
        emit(cell, seed, "program", *drv.numbers(prog, ref))
        if seed in control_seeds:
            ctl = drv.reference_readings(cfg, traffic, seed, prog["views"], dev, tf32=True)
            emit(cell, seed, "control", *drv.numbers(ctl, ref))
            half = drv.reference_readings(cfg, traffic, seed, prog["views"], dev, half=True)
            emit(cell, seed, "fault_half_batch", *drv.numbers(half, ref))
        del ref
        gc.collect()
        torch.cuda.empty_cache()


def view_readings(cell: dict, seeds: list[int], control_seeds: set[int], seconds: float) -> None:
    from gsbench import spec
    from gsbench.drivers import view as drv

    cfg, traffic = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    for seed in seeds:
        for kind, control in (("program", False), ("control", True)):
            if control and seed not in control_seeds:
                continue
            res = drv.run(cfg, traffic, seed=seed, seconds=seconds, trace=False,
                          device="cuda", t_start=time.perf_counter(), control=control)
            emit(cell, seed, kind, res["numbers"], {"attempted": res["attempted"],
                                                    "failed": res["failed"]})


def emit(cell: dict, seed: int, kind: str, numbers: dict, info: dict) -> None:
    print(json.dumps({"workload": cell["name"], "seed": seed, "kind": kind,
                      "numbers": numbers, "info": info}, default=str), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from gsbench import spec

    cell = spec.cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    if spec.traffic(cell["traffic"])["driver"] == "train":
        train_readings(cell, seeds, control)
    else:
        view_readings(cell, seeds, control, args.seconds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
