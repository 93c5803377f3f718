"""A short quality run on the synthetic scene, through the training CLI.

Writes the ray-traced scene of `gsjax_torch.tools.synthetic_scene` (400 px,
96 train + 8 test views) under `build/`, unless it is there, and trains it
with `python -m gsjax_torch.cli.train`'s defaults plus --eval, evaluating
the test views at each of --test_iterations; then renders the test views
(`cli.render --skip_train`) and scores them (`cli.metrics`). Prints one
JSON line: the card, the evaluations, densify and budget events, the wall
time of training, the points alive at the end and results.json.

    python -m gsjax_torch.tools.quality_run [--iterations 2000] \
        [--test_iterations 1000 2000]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    import torch

    from gsjax_torch.cli import metrics as metrics_cli
    from gsjax_torch.cli import render as render_cli
    from gsjax_torch.cli import train as train_cli
    from gsjax_torch.tools.common import require_card
    from gsjax_torch.tools.synthetic_scene import generate

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--iterations", type=int, default=2000)
    parser.add_argument("--test_iterations", type=int, nargs="+", default=[1000, 2000])
    parser.add_argument("--out", default=os.path.join(ROOT, "build", "quality"))
    args = parser.parse_args(argv)
    require_card("quality_run")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    scene = os.path.join(args.out, "scene")
    t0 = time.perf_counter()
    if not os.path.exists(os.path.join(scene, "points3d.ply")):
        generate(scene)
    scene_s = time.perf_counter() - t0
    model = os.path.join(args.out, "model")
    stdout = sys.stdout
    t0 = time.perf_counter()
    try:
        trainer = train_cli.main([
            "-s", scene, "-m", model, "--eval", "--quiet",
            "--iterations", str(args.iterations),
            "--test_iterations", *map(str, args.test_iterations),
            "--save_iterations", str(args.iterations),
        ])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        render_cli.main(["-m", model, "--iteration", str(args.iterations),
                         "--skip_train", "--quiet"])
        metrics_cli.main(["-m", model])
    finally:
        sys.stdout = stdout
    with open(os.path.join(model, "results.json")) as f:
        results = json.load(f)[f"ours_{args.iterations}"]
    line = {
        "tool": "quality_run", "card": smi, "device": torch.cuda.get_device_name(0),
        "iterations": args.iterations, "scene_seconds": scene_s,
        "train_wall_s": train_s,
        "evals": [e for e in trainer.events if "eval" in e],
        "densify": [e for e in trainer.events if "densify" in e],
        "budget_events": [e for e in trainer.events if "budgets" in e],
        "points": trainer.n_alive(), "capacity": trainer.state.params.capacity,
        "step_ms_total": sum(e["ms"] for e in trainer.events if "window" in e),
        "results": results,
    }
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
