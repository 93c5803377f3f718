"""Headline benchmark of the port: the rasterizer's forward+backward
throughput at 1080p on the card.

The counterpart of the repository's bench.py, on the same work: the bench
scene (500k Gaussians, SH degree 3, tools/common.bench_scene), its
budgets and 32x32 tiles, L1 against a zero image, gradients with respect
to every raw parameter and mean2d_offset, and a zero-magnitude SGD update
(p - 0 * g) that chains each step to the one before, as training does.
3 warm-up steps, then 20 timed by CUDA events and synchronised.

    python -m gsjax_torch.bench

Prints ONE JSON line:
  {"metric": "pixels_per_s_fwd_bwd_1080p", "value": N, "unit": "pixel/s",
   "vs_baseline": N / 31.1e6, "ms_per_step": ..., "device": ...}
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
from gsjax_torch.tools.common import SH_DEGREE, bench_scene
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


def run(params, aux, camera, cfg, warmup: int = WARMUP, iters: int = ITERS) -> dict:
    """The bench line for this scene, timed on the card."""
    step = BenchStep(params, aux, camera, cfg)
    for _ in range(warmup):
        step()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        loss = step()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / iters
    if not bool(torch.isfinite(loss)):
        raise AssertionError(f"bench: non-finite loss {float(loss)}")
    pixels_per_s = camera.width * camera.height / (ms / 1e3)
    return {"metric": METRIC, "value": round(pixels_per_s, 1), "unit": "pixel/s",
            "vs_baseline": round(pixels_per_s / BASELINE_PIXELS_PER_S, 4),
            "ms_per_step": ms, "device": torch.cuda.get_device_name(0)}


def main() -> None:
    if not torch.cuda.is_available():
        _emit_error_and_exit("no CUDA device: the bench measures the card")
    params, aux, camera, cfg = bench_scene()
    print(json.dumps(run(params, aux, camera, cfg)), flush=True)


if __name__ == "__main__":
    main()
