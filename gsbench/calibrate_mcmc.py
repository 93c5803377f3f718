"""The readings m360_garden_mcmc.train_relocate's limits are set from, on
the card.

    python3 gsbench/calibrate_mcmc.py --seeds 1,2,... [--program-faults]

Prints one JSON line per seed and kind: "program" (the timed path's
checked steps against the plain reference), "control" (the reference in
TF32 in the program's place) and, for each of the cell's faults, the
reference with that fault in the program's place ("stale_noise": every
step draws the first step's noise; "no_relocation": the relocation left
out; "no_regularizers": the loss without its opacity and scale terms).
With --program-faults, each fault planted under the program's timed path
as well ("planted_<fault>", a run of 2 s), as the harness would run it.
"""

from __future__ import annotations

import argparse
import gc
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
CELL = "m360_garden_mcmc.train_relocate"


def emit(seed: int, kind: str, numbers: dict) -> None:
    print(json.dumps({"workload": CELL, "seed": seed, "kind": kind, "numbers": numbers}),
          flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seeds", required=True)
    p.add_argument("--program-faults", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import torch

    from gsbench import spec
    from gsbench.drivers import train_mcmc as drv
    from gsjax_torch.train.step import drop_step_graphs

    cell = spec.cell(CELL)
    cfg, traffic = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    dev = torch.device(args.device)
    for seed in (int(s) for s in args.seeds.split(",")):
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
        ref = drv.reference_readings(cfg, traffic, seed, prog, dev)
        emit(seed, "program", drv.numbers(prog, ref)[0])
        for kind in ("control",) + drv.FAULTS:
            alt = drv.reference_readings(cfg, traffic, seed, prog, dev, tf32=kind == "control",
                                         fault=None if kind == "control" else kind)
            emit(seed, kind, drv.numbers(alt, ref)[0])
            del alt
        del ref
        gc.collect()
        torch.cuda.empty_cache()
        if args.program_faults:
            for fault in drv.FAULTS:
                res = drv.run(cfg, traffic, seed=seed, seconds=2.0, trace=False, device=args.device,
                              t_start=time.perf_counter(), fault=fault)
                emit(seed, f"planted_{fault}", res["numbers"])
                del res
                gc.collect()
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
