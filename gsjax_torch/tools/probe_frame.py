"""Whether a viewer frame between two windows of replayed training steps
changes the training state, and whether the step itself reproduces.

    python -m gsjax_torch.tools.probe_frame [--runs 30]

The scene of tests/test_torch_render_graph.py's card tests: 5,000
Gaussians (SH degree 1, seed 3) at 320x240 in 16x16 tiles, trained toward
eager renders of another scene (seed 4) from four views. A run is two
windows of four replayed steps (train_steps) from one start state. Each
round runs a reference without a frame, then:

  none        a second run without a frame;
  fresh       a run whose frame (a replayed fast render of the state from
              view 2, as the viewer serves one) is captured between the
              windows (drop_render_graphs first);
  registered  a run whose frame replays the render graph already captured.

Each run's state tensors and metrics against the reference's, bit for
bit; where one differs, its largest difference. With the frame, whether
the captured step's registry stayed as it was. One JSON line per case and
one with the operations of an eager step that torch calls
nondeterministic (torch.use_deterministic_algorithms with warn_only).
Needs the card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import warnings

import numpy as np
import torch

from gsjax_torch.config import OptimizationConfig, RasterConfig
from gsjax_torch.model import PARAM_NAMES
from gsjax_torch.render import graph as graph_mod
from gsjax_torch.render.api import render
from gsjax_torch.scene import CameraBank
from gsjax_torch.synthetic import look_at_origin_camera, orbit_camera, random_scene
from gsjax_torch.tools.common import require_card
from gsjax_torch.train import step as steps_mod
from gsjax_torch.train.optimizer import adam_init

SH = 1
WIDTH, HEIGHT = 320, 240
CFG = RasterConfig(tile_size=16, max_instances=1 << 17, max_rows=1 << 16)
ANGLES = (0.15, -0.2, 0.3)
WINDOW = (0, 1, 2, 3)
CASES = ("none", "fresh", "registered")
STATE_NAMES = ([f"params.{k}" for k in PARAM_NAMES] + [f"mu.{k}" for k in PARAM_NAMES]
               + [f"nu.{k}" for k in PARAM_NAMES]
               + [f"aux.{k}" for k in steps_mod.AUX_NAMES] + ["opt.count", "step"])


class Windows:
    """The scene, its bank, a start state and the state the captured step
    is bound to."""

    def __init__(self, device):
        params, aux = random_scene(5000, sh_degree=SH, seed=3, spread=1.5, device=device)
        self.cams = [look_at_origin_camera(WIDTH, HEIGHT, device=device)] + [
            orbit_camera(a, width=WIDTH, height=HEIGHT, device=device) for a in ANGLES]
        target, target_aux = random_scene(5000, sh_degree=SH, seed=4, spread=1.5,
                                          device=device)
        with torch.no_grad():
            gts = [render(target, c, active_sh_degree=SH,
                          bg_color=torch.zeros(3, device=device), cfg=CFG,
                          alive=target_aux.alive).image for c in self.cams]
        self.bank = CameraBank.from_cameras(
            self.cams,
            [(g.clamp(0, 1) * 255).round().to(torch.uint8).cpu().numpy() for g in gts],
            [np.full((1, HEIGHT, WIDTH), 255, np.uint8) for _ in self.cams])
        self.state = steps_mod.TrainState(
            params=params, opt=adam_init(params), aux=aux,
            step=torch.ones((), dtype=torch.int32, device=device))
        self.start = steps_mod.clone_state(self.state)
        self.kw = dict(active_sh_degree=SH, opt_cfg=OptimizationConfig(), raster_cfg=CFG,
                       spatial_lr_scale=1.0)

    def frame(self):
        """A viewer frame of the state: a replayed fast render from view 2."""
        return graph_mod.render_replayed(
            self.state.params, self.cams[2], active_sh_degree=SH,
            bg_color=torch.zeros(3, device=self.cams[2].device),
            cfg=dataclasses.replace(CFG, fast_fwd=True), alive=self.state.aux.alive)

    def run(self, case: str) -> tuple[list[torch.Tensor], bool]:
        """Two windows from the start state, with case's frame between
        them: (the state's tensors and the second window's metrics on the
        CPU, whether the step registry stayed as it was)."""
        steps_mod.copy_state_(self.state, self.start)
        cams = torch.tensor(WINDOW, dtype=torch.int32)
        bgs = torch.zeros((len(WINDOW), 3))
        kept = True
        for w in range(2):
            _, m = steps_mod.train_steps(self.state, self.bank, cams, bgs, **self.kw)
            if w == 0 and case != "none":
                registry = dict(steps_mod._GRAPHS)
                if case == "fresh":
                    graph_mod.drop_render_graphs()
                self.frame()
                kept = steps_mod._GRAPHS == registry
        out = [t.detach().cpu() for t in steps_mod.state_tensors(self.state)]
        return out + [getattr(m, k).cpu() for k in steps_mod.METRIC_DTYPES], kept


def differences(got: list[torch.Tensor], want: list[torch.Tensor]) -> dict[str, float]:
    """{tensor name: largest |got - want|} of the tensors that differ bit
    for bit (NaN where the two are not both finite)."""
    names = STATE_NAMES + [f"metrics.{k}" for k in steps_mod.METRIC_DTYPES]
    out = {}
    for name, a, b in zip(names, got, want, strict=True):
        if a.numpy().tobytes() != b.numpy().tobytes():
            d = (a.double() - b.double()).abs()
            out[name] = float(d[torch.isfinite(d)].max()) if bool(torch.isfinite(d).any()) \
                else float("nan")
    return out


def frame_rounds(device, runs: int, cases=CASES) -> dict[str, list[dict]]:
    """`runs` rounds: per case a record per round, the differing tensors'
    largest differences against that round's reference (empty: bit for
    bit) and whether the step registry stayed as it was."""
    windows = Windows(device)
    steps_mod.drop_step_graphs()
    windows.run("none")  # the step's capture
    windows.frame()      # the registered frame's capture
    out = {c: [] for c in cases}
    for _ in range(runs):
        ref, _ = windows.run("none")
        for case in cases:
            got, kept = windows.run(case)
            out[case].append({"differ": differences(got, ref), "registry_kept": kept})
    steps_mod.drop_step_graphs()
    return out


def nondeterministic_ops(device) -> list[str]:
    """The messages torch gives for the nondeterministic operations of one
    eager training step (forward, backward, Adam) on the probe's scene."""
    windows = Windows(device)
    cams = torch.tensor(WINDOW[:1], dtype=torch.int32)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            state, _ = steps_mod.scan_steps(windows.state, windows.bank, cams,
                                            torch.zeros((1, 3)), **windows.kw)
            state.params.xyz.cpu()
        finally:
            torch.use_deterministic_algorithms(False)
    return sorted({str(w.message).split("\n")[0][:200] for w in caught})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=30)
    args = ap.parse_args(argv)
    require_card("probe_frame")
    device = torch.device("cuda")
    rounds = frame_rounds(device, args.runs)
    for case, records in rounds.items():
        worst = {}
        for r in records:
            for name, d in r["differ"].items():
                worst[name] = max(worst.get(name, 0.0), d)
        print(json.dumps({"case": case, "runs": len(records),
                          "differ": sum(bool(r["differ"]) for r in records),
                          "registry_changed": sum(not r["registry_kept"] for r in records),
                          "largest_difference": worst,
                          "card": torch.cuda.get_device_name(0)}), flush=True)
    print(json.dumps({"nondeterministic_ops": nondeterministic_ops(device)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
