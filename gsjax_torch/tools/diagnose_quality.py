"""The train/test-gap diagnosis of a quality run's artifact: the
counterpart of the repository's tools/diagnose_quality.py, which it
follows line for line.

Reads a quality_run artifact (gsjax_torch.tools.quality_run's, default
build/quality/quality_run.json, or the JAX package's
artifacts/quality_run_v3.json, unchanged) and prints:
  - the eval curves (train against test PSNR, the gap per evaluation, the
    slope over the last evaluations),
  - per-test-view PSNR against camera elevation (the synthetic scene's
    test views sit on three jittered elevation rings,
    gsjax_torch/tools/synthetic_scene.py),
  - floater indicators from the final-state diagnostics (radius
    percentiles, the share of opaque splats outside the scene extent, the
    opacity distribution),
  - the points curve against capacity.

Pure numpy over the JSON; needs no card.

    python -m gsjax_torch.tools.diagnose_quality [artifact.json]
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_ARTIFACT = os.path.join(ROOT, "build", "quality", "quality_run.json")


def elev_of_test_view(i: int, n: int = 8) -> float:
    """The elevation (radians) of test view i of n: three interleaved
    rings plus jitter, as synthetic_scene places them."""
    return (0.15, 0.4, 0.65)[i % 3] + 0.08 * (
        ((i * 7919) % n) / max(n - 1, 1) - 0.5
    )


def main(path: str = DEFAULT_ARTIFACT) -> None:
    with open(path) as f:
        d = json.load(f)
    test = d["test_psnr_curve"]
    train = d["train_evals"]

    print(f"== {path} ({d['iterations']} target iters, "
          f"wall {d.get('wall_clock_s')} s, crashed={d.get('crashed')}) ==")
    print("\niter    train-PSNR  test-PSNR   gap")
    by_iter = {e["iteration"]: e for e in train}
    for e in test:
        tr = by_iter.get(e["iteration"])
        gap = (tr["psnr"] - e["psnr"]) if tr else float("nan")
        print(f"{e['iteration']:>6}  {tr['psnr'] if tr else float('nan'):>9.2f}"
              f"  {e['psnr']:>9.2f}  {gap:>5.2f}")

    # Plateau: dB per 1k iterations over the trailing third of the test curve.
    its = np.array([e["iteration"] for e in test], dtype=float)
    ps = np.array([e["psnr"] for e in test], dtype=float)
    if len(its) >= 4:
        k = max(3, len(its) // 3)
        slope = np.polyfit(its[-k:], ps[-k:], 1)[0] * 1000
        print(f"\ntrailing test-curve slope: {slope:+.3f} dB / 1k iters "
              f"over the last {k} evals "
              f"({'plateaued' if abs(slope) < 0.15 else 'still moving'})")

    pv = d.get("final_per_view") or []
    if pv:
        print("\nview   elev(rad)  PSNR   SSIM")
        elevs, psnrs = [], []
        n = len(pv)
        for v in pv:
            i = int(v["view"].split("_")[-1])
            el = elev_of_test_view(i, n)
            elevs.append(el)
            psnrs.append(v["psnr"])
            print(f"{v['view']:>5}  {el:>8.3f}  {v['psnr']:>6.2f}  "
                  f"{v['ssim']:>5.3f}")
        if len(set(elevs)) > 2:
            r = np.corrcoef(elevs, psnrs)[0, 1]
            print(f"corr(elevation, PSNR) = {r:+.2f} "
                  f"({'grazing views are the weak ones' if r > 0.3 else 'no strong elevation trend'})")

    fs = d.get("final_state_diagnostics") or {}
    if fs:
        print("\nfloater indicators:")
        for k in ("n_alive", "opacity_mean", "opacity_frac_below_0.1",
                  "radius_p50", "radius_p99", "frac_outside_extent",
                  "frac_outside_extent_opaque", "cameras_extent"):
            if k in fs:
                print(f"  {k:>28}: {fs[k]}")

    pc = d.get("points_curve") or []
    if pc:
        cap = d.get("capacity")
        print(f"\npoints curve (capacity {cap}):")
        print("  " + "  ".join(f"{e['iteration']}:{e['points']}" for e in pc))


if __name__ == "__main__":
    main(*sys.argv[1:])
