"""Headline benchmark of the port: the rasterizer's forward+backward
throughput at 1080p on the card.

The counterpart of the repository's bench.py, on the same work: the bench
scene (500k Gaussians, SH degree 3, tools/common.bench_scene), its
budgets and 32x32 tiles, L1 against a zero image, gradients with respect
to every raw parameter and mean2d_offset, and a zero-magnitude SGD update
(p - 0 * g) that chains each step to the one before, as training does.

`value` times the step as bench.py does, compiled: bench.py times a
jitted step, and the port's counterpart is a window of ITERS replays of
one captured CUDA graph of the step (ScanStep), timed by CUDA events
after WARMUP dispatched steps and one warm window. The same ITERS steps
dispatched one at a time from the host (~1800 launches each), timed the
same way, stand beside it under `ms_per_step_dispatched`: the figure
this line reported before, and what a loop of eager calls pays.

    python -m gsjax_torch.bench

Prints ONE JSON line:
  {"metric": "pixels_per_s_fwd_bwd_1080p", "value": N, "unit": "pixel/s",
   "vs_baseline": N / 31.1e6, "ms_per_step": ..., "ms_per_step_dispatched":
   ..., "pixels_per_s_dispatched": ..., "device": ...}
The baseline is bench.py's: the reference CUDA rasterizer's ~15
fwd+bwd iterations/s at 1080p on an RTX/A6000-class GPU (BASELINE.md).
Without a card it prints that line with value 0 and an "error", and exits
1: it never runs on the CPU.
"""

from __future__ import annotations

import json

import torch

from gsjax_torch.model import PARAM_NAMES
from gsjax_torch.render.api import render
from gsjax_torch.render.graph import capture_graph, count_replays
from gsjax_torch.tools.common import SH_DEGREE, bench_scene, cuda_ms
from gsjax_torch.train.loss import l1_loss

METRIC = "pixels_per_s_fwd_bwd_1080p"
BASELINE_PIXELS_PER_S = 31.1e6
WARMUP = 3
ITERS = 20


def _emit_error_and_exit(msg: str) -> None:
    print(json.dumps({"metric": METRIC, "value": 0.0, "unit": "pixel/s",
                      "vs_baseline": 0.0, "error": msg[:500]}))
    raise SystemExit(1)


class BenchStep:
    """One bench step: render, L1 against a zero image, the gradients of
    every raw parameter and of mean2d_offset, and p <- p - 0 * g. Returns
    the loss; the gradients are kept in `grads`."""

    def __init__(self, params, aux, camera, cfg, sh_degree: int = SH_DEGREE):
        dev = params.device
        self.params, self.aux, self.camera, self.cfg = params, aux, camera, cfg
        self.sh_degree = sh_degree
        self.bg = torch.zeros(3, device=dev)
        self.gt = torch.zeros((3, camera.height, camera.width), device=dev)
        self.offset = torch.zeros((params.capacity, 2), device=dev,
                                  requires_grad=True)
        self.grads = None

    def __call__(self) -> torch.Tensor:
        out = render(self.params, self.camera, active_sh_degree=self.sh_degree,
                     bg_color=self.bg, cfg=self.cfg, alive=self.aux.alive,
                     mean2d_offset=self.offset)
        loss = l1_loss(out.image, self.gt)
        leaves = [getattr(self.params, k) for k in PARAM_NAMES]
        self.grads = torch.autograd.grad(loss, leaves + [self.offset])
        with torch.no_grad():
            for leaf, g in zip(leaves, self.grads):
                leaf.sub_(0.0 * g)
        return loss.detach()


class ScanStep:
    """`window` runs of `step` (a callable returning a 0-d loss on
    `device`), captured once as a CUDA graph of one run
    (render/graph.capture_graph) and replayed: the port's lax.scan of a
    jitted step. Each replay writes the step's loss into row `cursor` of
    `losses` and adds one to the cursor on the device."""

    def __init__(self, step, window: int, device: torch.device):
        self.step, self.window = step, window
        self.losses = torch.zeros(window, device=device)
        self.cursor = torch.zeros((), dtype=torch.int64, device=device)
        self.graph, self.launches = capture_graph(
            self._body, device, {"graph": "scan", "window": window})

    def _body(self) -> None:
        loss = self.step()
        self.losses.index_copy_(0, self.cursor.view(1), loss.reshape(1))
        self.cursor.add_(1)

    def __call__(self) -> torch.Tensor:
        """The window's losses, [window] on the device (the buffer the next
        call overwrites)."""
        self.cursor.zero_()
        for _ in range(self.window):
            self.graph.replay()
        count_replays(self.launches, self.window)
        return self.losses


def run(params, aux, camera, cfg, warmup: int = WARMUP, iters: int = ITERS) -> dict:
    """The bench line for this scene, timed on the card: `iters` replayed
    steps (value) and `iters` dispatched ones."""
    step = BenchStep(params, aux, camera, cfg)
    dispatched_ms = cuda_ms(step, reps=iters, warmup=warmup)
    scan = ScanStep(step, iters, params.device)
    ms = cuda_ms(scan, reps=1, warmup=1) / iters
    if not bool(torch.isfinite(scan.losses).all()):
        raise AssertionError(f"bench: non-finite loss {scan.losses.tolist()}")
    px = camera.width * camera.height
    pixels_per_s = px / (ms / 1e3)
    return {"metric": METRIC, "value": round(pixels_per_s, 1), "unit": "pixel/s",
            "vs_baseline": round(pixels_per_s / BASELINE_PIXELS_PER_S, 4),
            "ms_per_step": ms, "ms_per_step_dispatched": dispatched_ms,
            "pixels_per_s_dispatched": round(px / (dispatched_ms / 1e3), 1),
            "device": torch.cuda.get_device_name(0)}


def main() -> None:
    if not torch.cuda.is_available():
        _emit_error_and_exit("no CUDA device: the bench measures the card")
    params, aux, camera, cfg = bench_scene()
    print(json.dumps(run(params, aux, camera, cfg)), flush=True)


if __name__ == "__main__":
    main()
