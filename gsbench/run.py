"""Run one cell of BENCHMARK.json once and print its result line.

    python3 gsbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads, warms up, measures for --seconds, checks what the timed path
produced against the plain reference, and prints as its last line of
standard output one JSON object (correct, attempted, failed, metrics,
device, with --trace 1 breakdown, then check: each compared number beside
its limit). Progress goes to standard error. Exits 2, printing no result,
without enough CUDA devices; 3 if JAX, flax or gsjax was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    os.chdir(ROOT)

    from gsbench import harness, spec

    cell = spec.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    line = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                       t_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded in the measuring process: {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in line["check"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(f"correct = {line['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
