"""The bench step dispatched one at a time against W steps per dispatch:
the counterpart of the repository's tools/bench_scan.py, where the second
form is a lax.scan and here replays of one captured CUDA graph of the step.

The step is gsjax_torch.bench's (BenchStep: the bench scene, 500k
Gaussians, SH degree 3, 1920x1080 in 32x32 tiles, budgets 1,179,648 /
524,288; render, L1 against a zero image, the gradients of every raw
parameter and of mean2d_offset, p <- p - 0 * g in place). Dispatched, each
step is the eager path's ~1800 launches from the host; as a graph a step
is one replay, so what is left is the card's own time. The gap is the
share of the dispatched step that is host dispatch.

    python -m gsjax_torch.tools.bench_scan [--window 10] [--outer 3]

One JSON line: for each form ms per step (host clock around WINDOW *
OUTER steps ending in a synchronize, as there, and by CUDA events), pixels
per second, and the device-busy ms per step and idle share of one traced
window (tools/trace.py); the capture's warm-up and capture ms.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from gsjax_torch.bench import BenchStep

WINDOW = 10
OUTER = 3
WARMUP = 2


class ScanStep:
    """`window` runs of a step, captured once as a CUDA graph of one run
    and replayed: the port's lax.scan. Each replay writes the step's loss
    into row `cursor` of `losses` and adds one to the cursor on the
    device."""

    def __init__(self, step, window: int):
        dev = step.params.device
        self.step, self.window = step, window
        self.losses = torch.zeros(window, device=dev)
        self.cursor = torch.zeros((), dtype=torch.int64, device=dev)
        t0 = time.perf_counter()
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(WARMUP):
                self._body()
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        self.warmup_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self._body()
        torch.cuda.synchronize(dev)
        self.capture_ms = (time.perf_counter() - t0) * 1e3

    def _body(self) -> None:
        loss = self.step()
        self.losses.index_copy_(0, self.cursor.view(1), loss.reshape(1))
        self.cursor.add_(1)

    def __call__(self) -> torch.Tensor:
        self.cursor.zero_()
        for _ in range(self.window):
            self.graph.replay()
        return self.losses


def timed(fn, calls: int, steps: int) -> dict:
    """ms per step of `calls` calls of fn (each `steps` steps): host clock
    to a synchronize, and CUDA events."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    for _ in range(calls):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) * 1e3 / (calls * steps)
    if not bool(torch.isfinite(out).all()):
        raise AssertionError(f"bench_scan: non-finite loss {out}")
    return {"ms_per_step": host, "event_ms_per_step": start.elapsed_time(end) / (calls * steps)}


def busy(fn, steps: int) -> dict:
    """Device busy ms per step and the idle share of one traced call."""
    from gsjax_torch.tools import trace
    from gsjax_torch.tools.trace_step import trace_ops

    ops = trace_ops(fn, 1, marks=())
    gaps = trace.idle_gaps([(op.start_us, op.end_us) for op in ops])
    return {"device_busy_ms_per_step": gaps["busy"] / 1e3 / steps,
            "idle_share": gaps["idle_share"], "device_ops_per_step": len(ops) / steps}


def run(params, aux, camera, cfg, window: int = WINDOW, outer: int = OUTER) -> dict:
    """Both forms on one scene, one after the other on the same state."""
    step = BenchStep(params, aux, camera, cfg)
    px = camera.width * camera.height

    def single():
        return step()

    for _ in range(WARMUP):
        single()
    out = {"tool": "bench_scan", "window": window, "outer": outer,
           "width": camera.width, "height": camera.height}
    out["dispatched"] = timed(single, window * outer, 1)

    def dispatched_window():
        for _ in range(window):
            loss = single()
        return loss

    out["dispatched"].update(busy(dispatched_window, window))
    scan = ScanStep(step, window)
    scan()
    out["scanned"] = timed(scan, outer, window)
    out["scanned"].update(busy(scan, window))
    out["capture"] = {"warmup_ms": scan.warmup_ms, "capture_ms": scan.capture_ms}
    for form in ("dispatched", "scanned"):
        out[form]["pixels_per_s"] = px / (out[form]["ms_per_step"] / 1e3)
    out["dispatch_share"] = 1.0 - (out["scanned"]["ms_per_step"]
                                   / out["dispatched"]["ms_per_step"])
    del scan
    return out


def main(argv=None) -> None:
    from gsjax_torch.render import kernels
    from gsjax_torch.tools.common import bench_scene, require_card

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--window", type=int, default=WINDOW)
    ap.add_argument("--outer", type=int, default=OUTER)
    args = ap.parse_args(argv)
    require_card("bench_scan")
    kernels.build()
    params, aux, camera, cfg = bench_scene()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      **run(params, aux, camera, cfg, args.window, args.outer)}), flush=True)


if __name__ == "__main__":
    main()
