#!/usr/bin/env python3
"""Drive the gsjax_torch render and training paths on one CUDA card and
check them.

Run from the repository root, with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, one JSON line each (any failure exits non-zero):
  device   the card's name and power limit (nvidia-smi)
  build    the CUDA kernels compiled from gsjax_torch/csrc
  kernels  each kernel against its plain PyTorch version on the card, on
           the arguments a mid-size render and its backward give it
           (20k Gaussians at 320x240; integers exact, composite forward
           within 2e-3, composite backward within 5e-3 of each gradient
           column's largest value, segment sums within 1e-5 of each run's
           sum of magnitudes, the row gather exactly, at int32 and int64
           indices); row_engine and rank_prefix bit for bit on
           the inputs that break load-balanced designs (case
           expand_adversarial, gsjax_torch/tools/expand_cases.py at card
           scale); and binning's rank form (600k Gaussians at 1920x1080 in
           16x16 tiles) against its gather path, with its rank_prefix's
           device ms and bound
  oracle   render() and its gradients against the O(N * pixels) oracle
           and its autograd on the card; dead slots' gradients exactly 0
  main     the bench scene (500k Gaussians, SH degree 3, 1920x1080, 32x32
           tiles) rendered from four views, exact and fast_fwd, through
           render(); the forward kernels' launch counts over that run
  profile  device time by kernel over one render (torch.profiler)
  views    per-view render time (CUDA events and host clock), exact and
           fast_fwd, dispatched and as replays of the captured render
           (render/graph.py; one capture for the four views), each replay
           equal to the main phase's eager render bit for bit; then
           cli.render's render_set from budgets the bench view outgrows:
           the outgrown capture is dropped, one of the grown budgets taken,
           and the frames equal eager renders at them bit for bit
  tiles    the composite kernels at 64x32 and 64x64 tiles (up to four
           pixels per thread) against their plain versions on the mid
           scene (also in the oracle phase, at 64x32); in every mid-scene
           case the culled composite kernels equal their twins without the
           cull bit for bit (the backward up to the sign of a zero)
  train    train_step() on the bench scene against the exact render of
           that scene, from a perturbed copy: 3 warm-up and 10 timed steps
           (loss per step, ms per step, pixels/s, host ms); all six
           kernels' launch counts over those steps; a profile of one step
  graph    the same 10 steps on the bench scene, views cycling through a
           CameraBank of the four main-phase views, eagerly (twice) and as
           one window of replays of the captured step (train_steps on the
           card): bitwise against the eager steps where two eager windows
           agree bit for bit (else the largest difference per parameter in
           lr units); ms per step, device busy ms and idle share of each;
           the capture's warm-up and capture ms and its pool's bytes; the
           kernels' launches (capture count times replays) cross-checked
           by torch.profiler; two replayed windows with a replayed viewer
           frame between them against the same two without it: the step's
           registry untouched, the states equal bit for bit
  densify  on the train phase's state (500k Gaussians at capacity 500k):
           densify_and_prune at full capacity (candidates dropped),
           grow_capacity to 2^20 (the trainer grows when a densify drops),
           densify of the grown state (clones and splits, nothing
           dropped), reset_opacity and a train step on the result with
           budgets sized by pow2_budget; each densify against the same
           call on the CPU with the card generator's draws (counts, mask
           and copied rows exact, split xyz and scaling within 1e-6,
           moments moved or zero); densify and grow ms on the card
  scene    a COLMAP binary model of the bench scene (8 PINHOLE views at
           1920x1080 on orbit poses, its 500k centres and DC colours, its
           exact renders as PNG) read into a Scene on the card, and once
           with a 100k sky shell; extent, centre and banks against numpy;
           create_from_pcd with the native 3-NN, and the torch 3-NN on the
           card against the native one (rtol 1e-4, atol 1e-6); 3 train
           steps picking views from the bank on the device, a densify, a
           PLY saved and reloaded through load_iteration, an npz
           checkpoint saved and reloaded (every tensor equal); seconds of
           every part
  viewer   the viewer's serving path: a Trainer on the scene phase's
           Scene serving a NetworkGUI on a free port; a client thread sends
           20 requests at 1920x1080 from the four main-phase views, a
           zero-resolution keep-alive and a last request to train, which
           ends Trainer._poll_gui; the frames are replays of one captured
           render, each within one uint8 level of a direct replay of the
           original camera, which equals its eager render bit for bit; the
           state untouched; frame ms (send to last byte; median, p90,
           the first with the capture), fps, the render's share, bytes per
           frame, the capture, the forward kernels' launches per frame
  lpips    a seeded random-weights LPIPS npz passes check_lpips_weights;
           lpips on the card equals lpips on the CPU within rtol 1e-4
           (128x128 pair); ms per 1080p pair against its bound
  tools    also queue item 7's profilers through their run functions on
           the bench scene: trace_step (the train step's device time by op
           and by op family, idle gaps), trace_binning, profile_kernels
           (16x16 tiles); after every profiled measurement bench_fps and
           bench_sweep (32x32, 16x16), replayed and dispatched; after the
           trainer phase, bench_trained on its PLY
  mesh     the device mesh (gsjax_torch.parallel) on this card: a
           world-size-1 NCCL group and a 1x1 ("data", "tile") DeviceMesh on
           the bench scene; render_sharded and composite_slab at 2 and 4
           slabs (stitched) against render() within 2e-5, the slabs' pair
           and row counts against the view's; the six kernels on the slab
           against their plain versions; sharded_grads against the eager
           step's gradients (loss rtol 1e-5, gradients 5e-3 of each
           column's largest) and one sharded step after Adam against
           train_step; launches per sharded step; ms per step of the eager
           sharded step and of train_step in turns; the group's start-up
           seconds; the mesh window (case mesh_graph): 10 sharded steps
           on the four main views twice as the eager loop and once as
           replays of the captured sharded step, bitwise against the eager
           loop where two eager windows agree bit for bit (else within 4x
           their spread in lr units), ms per step, device busy ms and idle
           share of each, launches (the capture's count times the
           replays, checked by torch.profiler); a Trainer on the mesh for
           64 iterations (two windows of 32, the first with the capture)
           on the scene phase's Scene. After the profiled
           phases, before the trainer
  tools_rest the remaining tools, one line each: after the kernels
           line's measurements bench_scan (the bench step dispatched and
           as replays of its captured graph), probe_gradreduce and
           scaling_projection (these read the profiler); after the mesh
           phase probe_saturation, probe_tilesize (32x32 counts equal to
           the origin view's), ckpt_to_ply (a bench-state checkpoint read
           back), export_lpips_weights (random state dicts), bench_scaling
           (one NCCL rank), sky_run and a quality run (cut iteration
           counts, under "reduced") and diagnose_quality on its artifact
  trainer  `python -m gsjax_torch.cli.train` (through main) on a COLMAP
           dataset of the bench scene (as the scene phase writes it) with
           --eval, 300 iterations, the viewer listening on a free port:
           densify from 100 every 100, an opacity reset at 200, checkpoints
           at 200 and 300, a test at 300; then cli.render of the test view
           and cli.metrics with the lpips phase's weights (results.json:
           SSIM, PSNR, a finite LPIPS); ms per window, captures, densify
           and budget events, evaluations, host work; the main kernels'
           launches over the run; then a run resumed from the checkpoint at
           200 (without TensorBoard), whose checkpoint at 300 must equal
           the straight run's bit for bit where the graph phase found the
           eager step reproducible; the straight run's evaluation of all
           eight views through its captured evaluation and eagerly, ms per
           view, bit for bit; the straight run's --profile_dir trace of
           steps 100-110 holds each main kernel exactly as often as the
           trainer launched it in the windows it covered
  after_trainer  one window of 10 replays of the bench step, captured
           after the trainer phase in the same process, in one profiler
           session: each main kernel's events exactly the capture's
           launches times the replays
  cull     at the bench origin view: for each warp shape (32x1, 16x2, 8x4)
           the (instance, warp) pairs the exact walk visits, those the
           cull keeps and those with a live pixel; the culled composite
           kernels against their twins without the cull, bit for bit, on
           the view's render and training step; each timed against its
           twin in turns (twin, main, main, twin), profiler device time
  tools    the profiling tools' kernels (gsjax_torch/tools/kernels.py:
           the three composite probes and the two twins) against their
           plain versions on the mid scene; then the tools' own path,
           gsjax_torch.tools.{ablate_kernels, probe_outpath, probe_prims},
           on the bench origin view (one line per measurement), with the
           tools kernels' launch counts over it;
           then each kernel against its plain version at that view's own
           arguments;
           on both streams the ablation probes against the kernels they
           launch as: blockout = composite_forward and replay_fwd,
           fwd_nocond = its red at pixel 0, bit for bit; bwd_nowrite = the
           chunk-head sums of composite_backward's d_mx within 1e-6
  bench    gsjax_torch.bench's JSON line on the bench scene (value: the
           replayed step; the dispatched one beside it), after every
           profiled measurement
  stages   gsjax_torch.profile_stages' table on the bench scene
Then the `kernels` line: for the forward kernels at the origin view's
render, for the backward kernels at one training step, for the tools'
kernels at the origin view's instance stream (the twins at the main
kernels' arguments, their times from the cull phase), each kernel's
launches (over the training run; the tools' over their own path, with "path": "tools"
and 0 launches per step and per view), its error against its plain
version on those very arguments (max_abs_err; the kernels and tools
phases' errors in mid_scene_max_abs_err), device time from the profiler
(ms_source: sessions held whole, gsjax_torch/tools/common.whole_session),
time by CUDA events with the host's launch work included, plain time,
bound, the time of one PyTorch call computing the same function where
there is one, and the kernel's CUDA launches and the other device
operations of one wrapper call (torch.profiler). Every number in the line
is measured in the run, the bound computed from its inputs. Then the card
line and the result line.
Imports no JAX.
"""

from __future__ import annotations

import contextlib
import json
import math
import re
import subprocess
import sys
import time
import warnings

# Names of each wrapper's CUDA kernels, as the profiler reports them.
from gsjax_torch.tools.common import DEVICE_KERNELS

# The card's published peaks (H100 SXM data sheet, dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# f32 operations per evaluated (instance, pixel) pair of the composite
# kernels: dx, dy, the quadratic form (9), exp, opacity * G.
COMPOSITE_FLOP_PER_PAIR = 13
# f32 operations the backward adds per live pair: w (1), s (5), the suffix
# (2), d_alpha (4), q and d_power (2), the five mean/conic terms (17), the
# three color terms (3) and the nine sums across the tile's pixels (9).
BACKWARD_FLOP_PER_LIVE_PAIR = 43
SCENE_NOISE_SIGMA = 0.1
TRAIN_WARMUP, TRAIN_STEPS = 3, 10
# The window the graph phase runs eagerly and as replays of the captured step.
GRAPH_STEPS = 10
# Where two eager windows differ, the graph's difference from one of them,
# per parameter in lr units, may be at most this multiple of theirs.
GRAPH_LR_MULTIPLE = 4
# Steps of the trainer phase's run through the training CLI.
TRAINER_ITERATIONS = 300
SPATIAL_LR_SCALE = 1.0

BENCH_N = 500_000
BENCH_W, BENCH_H = 1920, 1080
BENCH_BUDGETS = dict(max_instances=1_179_648, max_rows=524_288)
# gsjax's bench.py counts 1,155,281 pairs at the origin view.
BENCH_REFERENCE_INSTANCES = 1_155_281
ORBIT_ANGLES = (0.15, -0.2, 0.3)
PLAIN_SOURCE = {
    "composite_forward": "gsjax_torch/render/tiled.py",
    "row_engine": "gsjax_torch/render/kernels.py",
    "rank_prefix": "gsjax_torch/render/kernels.py",
    "composite_backward": "gsjax_torch/render/tiled.py",
    "segment_sum": "gsjax_torch/render/kernels.py",
    "row_gather": "gsjax_torch/render/kernels.py",
    "outpath": "gsjax_torch/tools/kernels.py",
    "blockout": "gsjax_torch/tools/kernels.py",
    "variant": "gsjax_torch/tools/kernels.py",
    "composite_forward_nocull": "gsjax_torch/render/tiled.py",
    "composite_backward_nocull": "gsjax_torch/render/tiled.py",
}
REPLACES = {
    "composite_forward": "gsjax/render/pallas_kernels.py:220",
    "row_engine": "gsjax/render/pallas_kernels.py:846",
    "rank_prefix": "gsjax/render/pallas_kernels.py:524",
    "composite_backward": "gsjax/render/pallas_kernels.py:1153",
    "segment_sum": "gsjax/render/pallas_kernels.py:331",
    "row_gather": "tools/probe_prims.py:81",
    "outpath": "tools/probe_outpath.py:91",
    "blockout": "tools/ablate_kernels.py:121",
    "variant": "tools/ablate_kernels.py:257",
    # The twins replace the same TPU kernels as the main kernels they mirror.
    "composite_forward_nocull": "gsjax/render/pallas_kernels.py:220",
    "composite_backward_nocull": "gsjax/render/pallas_kernels.py:1153",
}
SOURCES = {
    "composite_forward": "gsjax_torch/csrc/composite_forward.cu",
    "row_engine": "gsjax_torch/csrc/row_engine.cu",
    "rank_prefix": "gsjax_torch/csrc/rank_prefix.cu",
    "composite_backward": "gsjax_torch/csrc/composite_backward.cu",
    "segment_sum": "gsjax_torch/csrc/segment_sum.cu",
    "row_gather": "gsjax_torch/csrc/row_gather.cu",
    "outpath": "gsjax_torch/csrc/composite_probes.cu",
    "blockout": "gsjax_torch/csrc/composite_probes.cu",
    "variant": "gsjax_torch/csrc/composite_probes.cu",
    "composite_forward_nocull": "gsjax_torch/csrc/composite_probes.cu",
    "composite_backward_nocull": "gsjax_torch/csrc/composite_probes.cu",
}
# The warp shapes the cull phase counts, by warp width (32x1, 16x2, 8x4).
WARP_WIDTHS = (32, 16, 8)
BACKWARD_KERNELS = ("composite_backward", "segment_sum")
# The row gather's last call of a render is the (P, 16) instance gather,
# of a training step the permute's backward: the forward's arguments stand
# for it.
FORWARD_KERNELS = ("composite_forward", "row_engine", "rank_prefix", "row_gather")


def emit(obj) -> None:
    """Print one JSON line; where profiler sessions were refused and taken
    again since the last line, their errors go into it
    (`profiler_sessions_refused`, tools/common.with_refused)."""
    from gsjax_torch.tools.common import with_refused

    print(json.dumps(with_refused(obj)), flush=True)


class Recorder:
    """Records the arguments of the last call of each kernel wrapper."""

    def __init__(self, kernels):
        self.kernels = kernels
        self.calls = {}
        self.real = {k: getattr(kernels, k) for k in kernels.KERNEL_NAMES}

    def __enter__(self):
        for name, real in self.real.items():
            def recorder(*args, _name=name, _real=real, **kwargs):
                self.calls[_name] = (args, kwargs)
                return _real(*args, **kwargs)
            setattr(self.kernels, name, recorder)
        return self

    def __exit__(self, *exc):
        for name, real in self.real.items():
            setattr(self.kernels, name, real)


def check_backward_kernels(kernels, calls, errs, where):
    """composite_backward and segment_sum against their plain versions on
    recorded arguments. The composite backward is held per gradient column
    to 5e-3 of that column's largest value (the plain walk forms T and the
    suffix by log-space cumsums); the segment sums to 1e-5 of each run's sum
    of magnitudes (the same terms summed in another order), with empty runs
    exactly 0. Folds the largest absolute errors into `errs`; returns
    {kernel: (max abs error, error in the tolerance's measure)}."""
    args, kw = calls["composite_backward"]
    got = kernels.composite_backward(*args, **kw)
    want = kernels.composite_backward_plain(*args, **kw)
    diff = (got - want).abs()
    e_back = float((diff / want.abs().amax(dim=0).clamp(min=1e-8)).max())
    vals, gm_start = calls["segment_sum"][0]
    got = kernels.segment_sum(vals, gm_start)
    want = kernels.segment_sum_plain(vals, gm_start)
    scale = kernels.segment_sum_plain(vals.abs(), gm_start)
    sdiff = (got - want).abs()
    if bool((sdiff[scale == 0] != 0).any()):
        raise AssertionError(f"{where}: segment_sum: an empty run's sum is not 0")
    e_sum = float((sdiff / scale.clamp(min=1e-30)).max())
    if not e_back <= 5e-3:
        raise AssertionError(f"{where}: composite_backward error {e_back} > 5e-3")
    if not e_sum <= 1e-5:
        raise AssertionError(f"{where}: segment_sum error {e_sum} > 1e-5")
    out = {"composite_backward": (float(diff.max()), e_back),
           "segment_sum": (float(sdiff.max()), e_sum)}
    for name, (abs_err, _) in out.items():
        errs[name] = max(errs[name], abs_err)
    return out


def ops_per_call(fn, kernel_name) -> dict:
    """The kernel's CUDA launches and the other device operations (fills,
    memsets, PyTorch kernels around it) of one fn(), by torch.profiler."""
    from gsjax_torch.tools.common import device_ops

    ops = device_ops(fn, kernel_name)
    return {"cuda_launches_per_call": ops["named"],
            "other_device_ops_per_call": ops["kernels"] + ops["memsets"] - ops["named"]}


def max_err(got, want) -> float:
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"shape/dtype {g.shape}/{g.dtype} vs {w.shape}/{w.dtype}")
        err = max(err, float((g.double() - w.double()).abs().max()) if g.numel() else 0.0)
    return err


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    return smi


def kernel_label(mangled: str) -> str:
    """A kernel's short name, with its template arguments, from its mangled
    name: composite_forward_kernel<1>, row_gather_kernel<i,16>."""
    if not mangled.startswith("_ZN"):
        return mangled
    i, name = 3, mangled
    while i < len(mangled) and mangled[i].isdigit():  # <length><identifier>...
        j = i
        while mangled[j].isdigit():
            j += 1
        name, i = mangled[j:j + int(mangled[i:j])], j + int(mangled[i:j])
    if mangled[i:i + 1] == "I":
        args = re.findall(r"L[a-z](\d+)E?|([a-z])", mangled[i + 1:mangled.find("EE", i)])
        name += f"<{','.join(a or t for a, t in args)}>"
    return name


def phase_build(kernels):
    t0 = time.perf_counter()
    kernels.build()
    seconds = time.perf_counter() - t0
    found = re.findall(
        r"Function properties for (\S+)\n\s*\d+ bytes stack frame, (\d+) bytes "
        r"spill stores[^\n]*\n[^\n]*Used (\d+) registers", kernels.build_log())
    emit({"phase": "build", "seconds": seconds,
          "registers": {kernel_label(fn): int(r) for fn, _, r in found},
          "spill_store_bytes": {kernel_label(fn): int(b) for fn, b, _ in found
                                if int(b)}})


def mid_scene_checks(torch, kernels, render, RasterConfig, random_scene,
                     look_at_origin_camera, dev, errs):
    """Each kernel against its plain version on the arguments of a
    20k-Gaussian 320x240 render and its backward (16x16, 32x32 and an
    overflowing budget); at 64x32 and 64x64 tiles (the tiles phase), where
    the composite kernels give each thread two and four pixels. In each
    case the composite kernels equal their twins without the cull."""
    from gsjax_torch.tools import kernels as tool_kernels

    params, aux = random_scene(20_000, seed=1, spread=1.5, device=dev)
    cam = look_at_origin_camera(320, 240, device=dev)
    cases = {
        "16x16": RasterConfig(tile_size=16, max_instances=1 << 18, max_rows=1 << 16),
        "32x32": RasterConfig(tile_size=32, max_instances=1 << 18, max_rows=1 << 16),
        "overflow": RasterConfig(tile_size=16, max_instances=1 << 14, max_rows=1 << 12),
        "64x32": RasterConfig(tile_w=64, tile_h=32, max_instances=1 << 18, max_rows=1 << 16),
        "64x64": RasterConfig(tile_w=64, tile_h=64, max_instances=1 << 18, max_rows=1 << 16),
    }
    for case, cfg in cases.items():
        kernels.reset_launch_counts()
        with Recorder(kernels) as rec:
            out = render(params, cam, active_sh_degree=3,
                         bg_color=torch.zeros(3, device=dev), cfg=cfg, alive=aux.alive)
            torch.mean(out.image ** 2).backward()
        n_inst, n_rows = int(out.num_instances), int(out.num_rows)
        overflow = n_inst > cfg.max_instances or n_rows > cfg.max_rows
        if overflow != (case == "overflow"):
            raise AssertionError(f"{case}: overflow={overflow} ({n_inst}, {n_rows})")
        line = {"phase": "tiles" if case.startswith("64") else "kernels",
                "case": case, "num_instances": n_inst, "num_rows": n_rows}
        for name in ("row_engine", "rank_prefix"):
            args, kw = rec.calls[name]
            e = max_err(getattr(kernels, name)(*args, **kw),
                        getattr(kernels, f"{name}_plain")(*args, **kw))
            if e != 0:
                raise AssertionError(f"{case}: {name} differs from plain by {e}")
            errs[name] = max(errs[name], e)
            line[name] = e
        src, idx = rec.calls["row_gather"][0]  # the permute's backward
        for ix in (idx, idx.long()):
            if not torch.equal(kernels.row_gather(src, ix), kernels.row_gather_plain(src, ix)):
                raise AssertionError(f"{case}: row_gather differs from plain")
        line["row_gather"] = 0.0
        args, kw = rec.calls["composite_forward"]
        e = max_err(kernels.composite_forward(*args, **kw),
                    kernels.composite_forward_plain(*args, **kw))
        if not e <= 2e-3:
            raise AssertionError(f"{case}: composite error {e} > 2e-3")
        errs["composite_forward"] = max(errs["composite_forward"], e)
        line["composite_forward"] = e
        for name, (_, e) in check_backward_kernels(kernels, rec.calls, errs, case).items():
            line[name] = e
        line["twins"] = check_twins(torch, kernels, tool_kernels,
                                    rec.calls["composite_forward"],
                                    rec.calls["composite_backward"], case)
        line["launches"] = dict(kernels.launch_counts)  # render + comparisons
        emit(line)

    # rank_prefix wraparound: deltas near 2^32.
    gen = torch.Generator(device="cpu").manual_seed(5)
    counts = torch.randint(0, 4, (50_000,), generator=gen)
    start = (torch.cumsum(counts, 0) - counts).to(torch.int32).to(dev)
    delta = (2**32 - torch.randint(1, 64, (50_000,), generator=gen))
    delta = kernels._as_i32(delta).to(dev)
    for kw in (dict(plus_iota=True), dict(init=-1), dict(init=12345)):
        e = max_err(kernels.rank_prefix(start, delta, budget=120_000, **kw),
                    kernels.rank_prefix_plain(start, delta, budget=120_000, **kw))
        if e != 0:
            raise AssertionError(f"rank_prefix wraparound {kw}: error {e}")
    emit({"phase": "kernels", "case": "rank_prefix_wraparound", "rank_prefix": 0.0})
    expand_adversarial(torch, kernels, dev, errs)


def expand_adversarial(torch, kernels, dev, errs):
    """Both expansion kernels against their plain versions, bit for bit, on
    the inputs that break load-balanced designs
    (gsjax_torch/tools/expand_cases.py at card scale: a 5,000-Gaussian
    stretch without rows among 3.8e5 runs, a Gaussian taller than a block,
    more rows than the budget, budgets of 1 and a block + 1, no rows,
    degenerate and clamped conics, 24x16 tiles; a run of 10^5 slots, a
    first start above 0, every start past the budget, one run, equal
    starts)."""
    from gsjax_torch.tools import expand_cases

    line = {"phase": "kernels", "case": "expand_adversarial"}
    for name, cases in (("row_engine", expand_cases.row_engine_cases("card")),
                        ("rank_prefix", expand_cases.rank_prefix_cases("card"))):
        line[name] = {}
        for case, c in cases.items():
            c = dict(c)
            if name == "row_engine":
                args = (torch.from_numpy(c.pop("table")).to(dev),
                        torch.from_numpy(c.pop("total_rows")).to(dev))
            else:
                args = (torch.from_numpy(c.pop("start")).to(dev),
                        torch.from_numpy(c.pop("delta")).to(dev))
            e = max_err(getattr(kernels, name)(*args, **c),
                        getattr(kernels, f"{name}_plain")(*args, **c))
            if e != 0:
                raise AssertionError(f"expand_adversarial {case}: {name} differs "
                                     f"from plain by {e}")
            line[name][case] = e
    emit(line)


def rank_form_check(torch, kernels, render, RasterConfig, random_scene,
                    look_at_origin_camera, dev, errs):
    """The rank form of binning level 1, which replaces the row engine when
    owner and tile bits overflow one 32-bit word: 600k Gaussians (20 bits)
    at 1920x1080 in 16x16 tiles (13 bits). Binning integers equal the
    gather path's, rank_prefix equals its plain version, and the render is
    finite with no overflow."""
    from gsjax_torch.render.binning import bin_gaussians
    from gsjax_torch.render.preprocess import preprocess

    params, aux = random_scene(600_000, seed=3, spread=2.5,
                               scale_range=(0.004, 0.03), device=dev)
    cam = look_at_origin_camera(BENCH_W, BENCH_H, device=dev)
    cfg = RasterConfig(tile_size=16, max_instances=1 << 23, max_rows=1 << 21)
    bg = torch.zeros(3, device=dev)
    kernels.reset_launch_counts()
    with Recorder(kernels) as rec, torch.no_grad():
        out = render(params, cam, active_sh_degree=3, bg_color=bg, cfg=cfg,
                     alive=aux.alive)
    launched = dict(kernels.launch_counts)
    if launched["row_engine"] or not launched["rank_prefix"]:
        raise AssertionError(f"rank form not taken: launches {launched}")
    n_inst, n_rows = int(out.num_instances), int(out.num_rows)
    if n_inst > cfg.max_instances or n_rows > cfg.max_rows:
        raise AssertionError(f"rank form: budget overflow ({n_inst}, {n_rows})")
    if not bool(torch.isfinite(out.image).all()):
        raise AssertionError("rank form: non-finite image")
    args, kw = rec.calls["rank_prefix"]
    e = max_err(kernels.rank_prefix(*args, **kw), kernels.rank_prefix_plain(*args, **kw))
    if e != 0:
        raise AssertionError(f"rank form: rank_prefix differs from plain by {e}")
    errs["rank_prefix"] = max(errs["rank_prefix"], e)

    with torch.no_grad():
        proj = preprocess(
            xyz=params.xyz, sh=params.get_features(), opacity=params.get_opacity(),
            scaling=params.get_scaling(), rotation=params.rotation, camera=cam,
            active_sh_degree=3, alive=aux.alive,
        )
        bins = [bin_gaussians(proj.mean_pix, proj.depth, proj.ext, proj.conic,
                              proj.qmax, BENCH_H, BENCH_W, cfg, packed_paths=pp)
                for pp in (None, False)]
    for name in ("perm", "sorted_owner", "sorted_slot", "tile_start", "gm_start",
                 "num_instances", "num_rows"):
        if not torch.equal(getattr(bins[0], name), getattr(bins[1], name)):
            raise AssertionError(f"rank form: {name} differs from the gather path")
    from gsjax_torch.tools.common import device_ms

    start, _ = args[:2]
    nbytes = start.numel() * 4 * 2 + kw["budget"] * 4
    with torch.no_grad():
        ms = device_ms(lambda: kernels.rank_prefix(*args, **kw),
                       DEVICE_KERNELS["rank_prefix"])
    emit({"phase": "kernels", "case": "rank_form_1080p_16x16", "gaussians": 600_000,
          "num_instances": n_inst, "num_rows": n_rows, "rank_prefix": e,
          "binning_equals_gather_path": True, "launches": launched,
          "rank_prefix_ms": ms, "rank_prefix_bound_ms": max(
              nbytes / HBM_BYTES_PER_S, kw["budget"] * 4 / F32_FLOP_PER_S) * 1e3,
          "rank_prefix_slots": kw["budget"], "rank_prefix_runs": start.numel()})


def phase_oracle(torch, render, render_oracle, RasterConfig, random_scene,
                 look_at_origin_camera, dev):
    """render() and its gradients against the oracle and the oracle's
    autograd (2k Gaussians at 128x96), in 16x16 and 64x32 tiles: images
    within 2e-3 (fast_fwd 4e-3); the six raw-parameter and the
    mean2d_offset gradients within 5e-3 of each one's largest; with half
    the slots dead (16x16), their gradients exactly 0."""
    from gsjax_torch.model import PARAM_NAMES

    params, aux = random_scene(2_000, seed=2, device=dev)
    cam = look_at_origin_camera(128, 96, device=dev)
    bg = torch.tensor([0.2, 0.3, 0.4], device=dev)
    leaves = [getattr(params, k) for k in PARAM_NAMES]
    with torch.no_grad():
        want = render_oracle(params, cam, active_sh_degree=3, bg_color=bg, alive=aux.alive)

    def grads(fn, alive):
        off = torch.zeros((params.capacity, 2), device=dev, requires_grad=True)
        img = fn(alive, off)
        return torch.autograd.grad(torch.mean(img ** 2), leaves + [off])

    def oracle(alive, off):
        return render_oracle(params, cam, active_sh_degree=3, bg_color=bg,
                             alive=alive, mean2d_offset=off)

    ref = grads(oracle, aux.alive)
    for tw, th in ((16, 16), (64, 32)):
        line = {"phase": "oracle", "gaussians": 2000, "width": 128, "height": 96,
                "tile": f"{tw}x{th}"}
        with torch.no_grad():
            for fast, tol in ((False, 2e-3), (True, 4e-3)):
                cfg = RasterConfig(tile_w=tw, tile_h=th, max_instances=1 << 16,
                                   max_rows=1 << 14, fast_fwd=fast)
                img = render(params, cam, active_sh_degree=3, bg_color=bg, cfg=cfg,
                             alive=aux.alive).image
                e = float((img - want).abs().max())
                if not e <= tol:
                    raise AssertionError(f"{tw}x{th} render fast={fast} vs oracle: "
                                         f"{e} > {tol}")
                line["fast_err" if fast else "exact_err"] = e

        cfg = RasterConfig(tile_w=tw, tile_h=th, max_instances=1 << 16, max_rows=1 << 14)

        def tiled(alive, off):
            return render(params, cam, active_sh_degree=3, bg_color=bg, cfg=cfg,
                          alive=alive, mean2d_offset=off).image

        got = grads(tiled, aux.alive)
        names = (*PARAM_NAMES, "mean2d_offset")
        grad_err = {}
        for name, g, r in zip(names, got, ref):
            grad_err[name] = float((g - r).abs().max() / r.abs().max().clamp(min=1e-8))
            if not grad_err[name] <= 5e-3:
                raise AssertionError(f"{tw}x{th} render grad {name} vs oracle: "
                                     f"{grad_err[name]} > 5e-3")
        line["grad_err"] = grad_err
        if tw == 16:
            half = aux.alive & (torch.arange(params.capacity, device=dev) < 1_000)
            dead = grads(tiled, half)
            if any(bool((g[1_000:] != 0).any()) for g in dead) or not bool(
                    (dead[0][:1_000] != 0).any()):
                raise AssertionError("dead slots' gradients are not exactly 0")
            line["dead_slot_grads_zero"] = True
        emit(line)


def composite_pairs(torch, inst, tile_start, *, n_tiles, tiles_x, tile_w, tile_h,
                    warp_widths=()):
    """(instance, pixel) pairs the exact composite must evaluate: per pixel,
    its tile's instances up to and including the one that terminates it;
    and the live pairs among them, those that contribute (and so carry
    gradient terms in the backward). The termination rule is the plain
    walk's (tiled.exact_step). For each warp width w of `warp_widths`, the
    (instance, warp) pairs of the warp map of w x (32 / w) blocks: those
    the walk visits (a pixel of the warp evaluates the instance), those of
    them the cull keeps (tiled.warp_keep) and those with a live pixel;
    raises if the cull drops a live pair. Returns (evaluated, live,
    {"WxH": {"visited", "kept", "live"}})."""
    from gsjax_torch.render import tiled
    from gsjax_torch.render.common import tile_pixel_coords

    dev, chunk, pix = inst.device, 128, tile_w * tile_h
    i0, i1 = tile_start[:-1].long(), tile_start[1:].long()
    lanes = torch.arange(chunk, device=dev)
    total = live_total = 0
    maps = {w: tiled.warp_pixels(tile_w, tile_h, w, device=dev) for w in warp_widths}
    warps = {w: dict(visited=0, kept=0, live=0) for w in warp_widths}
    batch = max(1, (1 << 25) // (pix * chunk))
    for t0 in range(0, n_tiles, batch):
        t1 = min(n_tiles, t0 + batch)
        px, py = tile_pixel_coords(torch.arange(t0, t1, device=dev), tiles_x, tile_w, tile_h)
        rects = {w: tiled.warp_rects(px, py, wp) for w, wp in maps.items()}
        px, py = px[..., None], py[..., None]
        t_cur = torch.ones((t1 - t0, pix, 1), device=dev)
        done = torch.zeros((t1 - t0, pix, 1), dtype=torch.bool, device=dev)
        steps = int(((i1[t0:t1] - i0[t0:t1] + chunk - 1) // chunk).max())
        for j in range(steps):
            idx = i0[t0:t1, None] + j * chunk + lanes
            mask = idx < i1[t0:t1, None]
            f = inst[idx.clamp(max=inst.shape[0] - 1)]
            *_, alpha = tiled._chunk_falloff(f, px, py, mask)
            _, skip, _, t_cur_next = tiled.exact_step(t_cur, done, alpha)
            before = torch.cat([done, skip[..., :-1]], dim=-1)  # done before lane
            evaluated = mask[:, None, :] & ~before
            live = ~skip & (alpha > 0)
            total += int(evaluated.sum())
            live_total += int(live.sum())
            for w, wp in maps.items():
                # (tb, W, 32, K) by the warp map, lanes without a pixel false.
                lane_px = torch.where(wp >= 0, wp, pix)

                def by_warp(x):
                    pad = torch.zeros_like(x[:, :1])
                    return torch.cat([x, pad], dim=1)[:, lane_px].any(dim=2)

                visited, live_w = by_warp(evaluated), by_warp(live)
                keep = tiled.warp_keep(f, rects[w])
                if bool((live_w & ~keep).any()):
                    raise AssertionError(f"cull: a live pair is culled ({w}-wide warps)")
                warps[w]["visited"] += int(visited.sum())
                warps[w]["kept"] += int((visited & keep).sum())
                warps[w]["live"] += int(live_w.sum())
            t_cur, done = t_cur_next, skip[..., -1:]
    shapes = {f"{w}x{32 // w}": counts for w, counts in warps.items()}
    return total, live_total, shapes


def check_twins(torch, kernels, tool_kernels, fwd_call, bwd_call, where):
    """The culled composite kernels against their twins without the cull
    on recorded arguments: the forward's outputs bit for bit, the
    backward's gradients equal in value (bit for bit but the sign of a
    zero). Raises otherwise."""
    def differs(name, got, want):
        bad = got.view(torch.int32) != want.view(torch.int32)
        first = bad.nonzero()[:4].tolist()
        raise AssertionError(
            f"{where}: {name} differs from its twin at {int(bad.sum())} elements "
            f"(first {first}), by up to {float((got - want).abs().max())}")

    args, kw = fwd_call
    with torch.no_grad():
        got = kernels.composite_forward(*args, **kw)
        want = tool_kernels.composite_forward_nocull(*args, **kw)
    for g, w in zip(got, want):
        if not torch.equal(g.view(torch.int32), w.view(torch.int32)):
            differs("composite_forward", g, w)
    args, kw = bwd_call
    got = kernels.composite_backward(*args, **kw)
    want = tool_kernels.composite_backward_nocull(*args, **kw)
    if not torch.equal(got, want):
        differs("composite_backward", got, want)
    return {"forward_bitwise": True, "backward_equal": True,
            "backward_bitwise": torch.equal(got.view(torch.int32), want.view(torch.int32))}


def check_tool_kernels(torch, tool_kernels, stream, where):
    """The profiling tools' kernels against their plain versions on one
    instance stream (tools/common.InstanceStream): outpath and blockout
    (both variants, both semantics) within the forward's 2e-3, the notrans
    block sum within rtol 1e-5 of its 4 PIX summed values (the rest of the
    block exactly 0); each ablation variant as tests/test_torch_tools.py
    holds it (dma_only rtol 1e-6, the walks
    2e-3 per chunk summed, the backward variants 5e-3 of the largest |d_mx|
    of their cotangent); the twins without the cull as the main kernels
    (2e-3; 5e-3 of each gradient column's largest, on the backward
    variants' cotangent). Returns {kernel: max abs error} and the variants'
    errors."""
    from gsjax_torch.render import kernels

    inst, ts, geo = stream.inst, stream.tile_start, stream.geometry
    pix = geo["tile_w"] * geo["tile_h"]
    errs, variant_errs = {}, {}
    with torch.no_grad():
        ship = tool_kernels.outpath(inst, ts, "ship", **geo)
        e = max_err(ship, tool_kernels.outpath_plain(inst, ts, "ship", **geo))
        got = tool_kernels.outpath(inst, ts, "notrans", **geo)
        want = tool_kernels.outpath_plain(inst, ts, "notrans", **geo)
        rel = float(((got[:, 0, 0] - want[:, 0, 0]).abs()
                     / want[:, 0, 0].abs().clamp(min=1e-30)).max())
        got[:, 0, 0] = 0
        if not e <= 2e-3 or not rel <= 1e-5 or bool((got != 0).any()):
            raise AssertionError(f"{where}: outpath ship {e}, notrans rtol {rel}")
        errs["outpath"] = e

        e = 0.0
        for sem in tool_kernels.SEMANTICS:
            e = max(e, max_err(tool_kernels.blockout(inst, ts, sem, **geo),
                               tool_kernels.blockout_plain(inst, ts, sem, **geo)))
        if not e <= 2e-3:
            raise AssertionError(f"{where}: blockout error {e} > 2e-3")
        errs["blockout"] = e

        _, mask = tool_kernels._chunk_heads(ts, geo["n_tiles"])
        max_chunks = int(mask.sum(1).max())
        cot = tool_kernels.bwd_nowrite_cot(geo["n_tiles"], pix, inst.device)
        d_mx = {v: float(kernels.composite_backward(inst, ts, c, **geo)[:, 0].abs().max())
                for v, c in (("bwd_nowrite", cot), ("bwd_noshfl", tool_kernels.lane0_cot(
                    geo["n_tiles"], geo["tile_w"], geo["tile_h"], inst.device)))}
        for name in tool_kernels.VARIANTS:
            got = tool_kernels.variant(inst, ts, name, **geo)
            want = tool_kernels.variant_plain(inst, ts, name, **geo)
            e = max_err(got, want)
            if name == "dma_only":
                ok = bool(((got - want).abs() <= 1e-6 * want.abs()).all())
            elif name in d_mx:
                ok = e <= 5e-3 * d_mx[name]
            else:
                ok = e <= 2e-3 * (max_chunks if name == "fwd_nodep" else 1)
            if not ok:
                raise AssertionError(f"{where}: variant {name} error {e}")
            variant_errs[name] = e
        errs["variant"] = max(variant_errs.values())

        e = max_err(tool_kernels.composite_forward_nocull(inst, ts, **geo),
                    tool_kernels.composite_forward_nocull_plain(inst, ts, **geo))
        if not e <= 2e-3:
            raise AssertionError(f"{where}: composite_forward_nocull error {e} > 2e-3")
        errs["composite_forward_nocull"] = e
    got = tool_kernels.composite_backward_nocull(inst, ts, cot, **geo)
    want = tool_kernels.composite_backward_nocull_plain(inst, ts, cot, **geo)
    rel = float(((got - want).abs() / want.abs().amax(dim=0).clamp(min=1e-8)).max())
    if not rel <= 5e-3:
        raise AssertionError(f"{where}: composite_backward_nocull error {rel} > 5e-3")
    errs["composite_backward_nocull"] = float((got - want).abs().max())
    return errs, variant_errs


def probes_against_main(torch, tool_kernels, stream, where) -> dict:
    """The probes against the kernels they take apart, which they launch as
    (tools/kernels.py), on one instance stream: blockout equals
    composite_forward bit for bit, outpath "ship" holds its colour and T
    bit for bit in rows 0-3 and zeros in rows 4-7, outpath "notrans"
    repeats bit for bit, replay_fwd and fwd_nocond give the forward's red
    at pixel 0 bit for bit, and bwd_nowrite the chunk-head sums of
    composite_backward's d_mx on the same cotangent within 1e-6 of each
    sum's magnitudes (the kernel adds them in another order). Raises
    otherwise."""
    from gsjax_torch.render import kernels

    inst, ts, geo = stream.inst, stream.tile_start, stream.geometry
    with torch.no_grad():
        color, trans = kernels.composite_forward(inst, ts, **geo)
        b_color, b_trans = tool_kernels.blockout(inst, ts, **geo)
        out = {"blockout_bitwise": torch.equal(b_color.view(torch.int32),
                                               color.view(torch.int32))
               and torch.equal(b_trans[..., 0].view(torch.int32), trans.view(torch.int32))}
        ship = tool_kernels.outpath(inst, ts, "ship", **geo)
        out["outpath_ship_bitwise"] = (
            torch.equal(ship[:, 0:3].transpose(1, 2).contiguous().view(torch.int32),
                        color.view(torch.int32))
            and torch.equal(ship[:, 3].contiguous().view(torch.int32),
                            trans.view(torch.int32))
            and not bool(ship[:, 4:].any()))
        notrans = [tool_kernels.outpath(inst, ts, "notrans", **geo).view(torch.int32)
                   for _ in range(2)]
        out["outpath_notrans_repeats_bitwise"] = torch.equal(*notrans)
        red = color[:, 0, 0].view(torch.int32)
        for name in ("replay_fwd", "fwd_nocond"):
            got = tool_kernels.variant(inst, ts, name, **geo).reshape(-1)
            out[f"{name}_bitwise"] = torch.equal(got.view(torch.int32), red)
        cot = tool_kernels.bwd_nowrite_cot(geo["n_tiles"], geo["tile_w"] * geo["tile_h"],
                                           inst.device)
        grads = kernels.composite_backward(inst, ts, cot, **geo)
        want = tool_kernels._chunk_head_sums(grads, ts, geo["n_tiles"])
        mag = tool_kernels._chunk_head_sums(grads.abs(), ts, geo["n_tiles"])
        got = tool_kernels.variant(inst, ts, "bwd_nowrite", **geo).reshape(-1)
        out["bwd_nowrite_rel_err"] = float(((got - want).abs() / mag.clamp(min=1e-30)).max())
    if not all(v for k, v in out.items() if k.endswith("_bitwise")) or not (
            out["bwd_nowrite_rel_err"] <= 1e-6):
        raise AssertionError(f"{where}: the probes differ from the main kernels: {out}")
    return out


def phase_tools(torch, tool_kernels, stream_mid, stream_bench):
    """The tools' kernels against their plain versions on the mid scene;
    then the tools' own path on the bench origin view with the tools
    kernels' launch counts set to 0 just before and read just after; then
    the kernels against their plain versions at that view's arguments.
    Returns the tools' measurement rows, the launches and both errors."""
    from gsjax_torch.tools import ablate_kernels, probe_outpath, probe_prims

    mid_errs, mid_variants = check_tool_kernels(torch, tool_kernels, stream_mid,
                                                "mid scene")
    emit({"phase": "tools", "case": "mid_scene", "max_abs_err": mid_errs,
          "variants": mid_variants,
          "probes_vs_main": probes_against_main(torch, tool_kernels, stream_mid,
                                                "mid scene")})
    torch.cuda.synchronize()
    tool_kernels.reset_launch_counts()
    rows = ablate_kernels.ablate(
        stream_bench, (*tool_kernels.VARIANTS, "blockout", "blockout_parallel"))
    rows += probe_outpath.outpaths(stream_bench)
    rows += probe_prims.probe()
    torch.cuda.synchronize()
    launches = dict(tool_kernels.launch_counts)
    for row in rows:
        emit(dict(phase="tools", **row))
    missing = [k for k in tool_kernels.KERNEL_NAMES if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the tools' path: {missing}")
    emit({"phase": "tools", "launches": launches})
    errs, variant_errs = check_tool_kernels(torch, tool_kernels, stream_bench,
                                            "bench view")
    probes = probes_against_main(torch, tool_kernels, stream_bench, "bench view")
    emit({"phase": "tools", "case": "bench_view", "max_abs_err": errs,
          "variants": variant_errs, "probes_vs_main": probes})
    return rows, launches, mid_errs, errs, variant_errs, probes


def phase_cull(torch, kernels, tool_kernels, origin_calls, train_calls):
    """At the bench origin view: the (instance, warp) pair counts of each
    warp shape on the view's render (composite_pairs); the culled composite
    kernels against their twins on the view's render (forward) and
    training step (backward); each kernel timed against its twin in turns
    (twin, main, main, twin) by profiler device time. Returns the twins'
    mean ms by kernel name."""
    from gsjax_torch.tools.common import device_ms

    args, kw = origin_calls["composite_forward"]
    geo = {k: kw[k] for k in ("n_tiles", "tiles_x", "tile_w", "tile_h")}
    t0 = time.perf_counter()
    pairs, live, shapes = composite_pairs(torch, args[0], args[1], **geo,
                                          warp_widths=WARP_WIDTHS)
    for shape, c in shapes.items():
        emit({"phase": "cull", "view": "origin", "warp": shape, **c,
              "kept_share": c["kept"] / c["visited"],
              "live_share": c["live"] / c["visited"]})
    emit({"phase": "cull", "pairs_evaluated": pairs, "pairs_live": live,
          "count_seconds": time.perf_counter() - t0,
          "twins": check_twins(torch, kernels, tool_kernels,
                               origin_calls["composite_forward"],
                               train_calls["composite_backward"], "bench view")})
    twin_ms = {}
    for name, calls in (("composite_forward", origin_calls),
                        ("composite_backward", train_calls)):
        args, kw = calls[name]
        main = getattr(kernels, name)
        twin = getattr(tool_kernels, f"{name}_nocull")
        with torch.no_grad():
            def timed(fn, key):
                return device_ms(lambda: fn(*args, **kw), DEVICE_KERNELS[key])

            turns = [timed(twin, f"{name}_nocull"), timed(main, name),
                     timed(main, name), timed(twin, f"{name}_nocull")]
        twin_ms[f"{name}_nocull"] = (turns[0] + turns[3]) / 2
        emit({"phase": "cull", "kernel": name, "turns": "twin, main, main, twin",
              "ms": turns, "twin_over_main": (turns[0] + turns[3]) / (turns[1] + turns[2])})
    return twin_ms


def tool_entries(torch, tool_kernels, stream, rows, launches, mid_errs, errs,
                 variant_errs, probes, fwd_entry, main_launches):
    """The `kernels` line's entries of the tools' three probe kernels at the
    bench origin view: device and event ms from the tools' own run (`rows`),
    the plain versions timed here, bounds from this view's data (the
    composite's pairs are the forward entry's, counted on the same
    stream), and the probes against the main kernels (`probes`)."""
    from gsjax_torch.tools.common import cuda_ms, with_refused

    inst, ts, geo = stream.inst, stream.tile_start, stream.geometry
    pix = geo["tile_w"] * geo["tile_h"]
    n_live, n_tiles = int(ts[-1]), geo["n_tiles"]
    pairs, live = fwd_entry["pairs_evaluated"], fwd_entry["pairs_live"]
    timed = {r["variant"]: r for r in rows if "variant" in r}
    out = []

    def entry(name, ms, event_ms, plain, nbytes, flops, library_ms=None, call=None,
              **extra):
        with torch.no_grad():
            plain_ms = cuda_ms(plain, reps=2)
        extra.update(ops_per_call(call, DEVICE_KERNELS[name]))
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / F32_FLOP_PER_S * 1e3
        out.append(with_refused(dict(
            name=name, route="cuda", source=SOURCES[name], replaces=REPLACES[name],
            launches=launches[name], path="tools",
            step_launches=main_launches["step"][name],
            view_run_launches=main_launches["views"][name],
            max_abs_err=errs[name], mid_scene_max_abs_err=mid_errs[name], ms=ms,
            plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=library_ms, plain_source=PLAIN_SOURCE[name],
            event_ms=event_ms, bytes=nbytes, flops=flops, **extra)))

    outpath = {r["variant"]: r for r in rows if r["tool"] == "probe_outpath"}
    entry("outpath", outpath["ship"]["ms"], outpath["ship"]["event_ms"],
          lambda: tool_kernels.outpath_plain(inst, ts, "ship", **geo),
          n_live * 9 * 4 + ts.numel() * 4 + n_tiles * 8 * pix * 4,
          pairs * COMPOSITE_FLOP_PER_PAIR, variant="ship",
          call=lambda: tool_kernels.outpath(inst, ts, "ship", **geo),
          notrans_ms=outpath["notrans"]["ms"],
          ship_equals_composite_forward_bitwise=probes["outpath_ship_bitwise"],
          notrans_repeats_bitwise=probes["outpath_notrans_repeats_bitwise"])
    entry("blockout", timed["blockout"]["ms"], timed["blockout"]["event_ms"],
          lambda: tool_kernels.blockout_plain(inst, ts, **geo),
          n_live * 9 * 4 + ts.numel() * 4 + n_tiles * pix * 16,
          pairs * COMPOSITE_FLOP_PER_PAIR, semantics="arbitrary",
          call=lambda: tool_kernels.blockout(inst, ts, **geo),
          parallel_ms=timed["blockout_parallel"]["ms"],
          equals_composite_forward_bitwise=probes["blockout_bitwise"])
    entry("variant", timed["bwd_nowrite"]["ms"], timed["bwd_nowrite"]["event_ms"],
          lambda: tool_kernels.variant_plain(inst, ts, "bwd_nowrite", **geo),
          n_live * 64 + n_tiles * pix * 16 + ts.numel() * 4 + n_tiles * 4,
          pairs * COMPOSITE_FLOP_PER_PAIR + live * BACKWARD_FLOP_PER_LIVE_PAIR,
          variant="bwd_nowrite",
          call=lambda: tool_kernels.variant(inst, ts, "bwd_nowrite", **geo),
          variants={v: dict(ms=timed[v]["ms"], event_ms=timed[v]["event_ms"],
                            max_abs_err=variant_errs[v]) for v in tool_kernels.VARIANTS},
          composite_forward_ms=timed["composite_forward"]["ms"],
          composite_backward_ms=timed["composite_backward"]["ms"],
          probes_vs_main={k: v for k, v in probes.items()
                          if not k.startswith(("blockout", "outpath"))})
    return out


def twin_entries(torch, tool_kernels, entries, origin_calls, train_calls,
                 launches, mid_errs, twin_ms, main_launches):
    """The `kernels` line's entries of the two twins without the cull, at
    the main kernels' own arguments (the forward's at the origin view's
    render, the backward's at one training step): device ms from the cull
    phase's turns, their errors against the plain versions, and the main
    kernels' bounds (the same work)."""
    from gsjax_torch.tools.common import cuda_ms, with_refused

    out = []
    for name, calls in (("composite_forward", origin_calls),
                        ("composite_backward", train_calls)):
        main = next(e for e in entries if e["name"] == name)
        main["nocull_ms"] = twin_ms[f"{name}_nocull"]
        twin_name = f"{name}_nocull"
        twin = getattr(tool_kernels, twin_name)
        plain = getattr(tool_kernels, f"{twin_name}_plain")
        args, kw = calls[name]
        with torch.no_grad():
            got, want = twin(*args, **kw), plain(*args, **kw)
            if name == "composite_forward":
                err = max_err(got, want)
                ok = err <= 2e-3
            else:
                diff = (got - want).abs()
                err = float(diff.max())
                ok = float((diff / want.abs().amax(dim=0).clamp(min=1e-8)).max()) <= 5e-3
            if not ok:
                raise AssertionError(f"main path: {twin_name} differs from plain by {err}")
            event_ms = cuda_ms(lambda: twin(*args, **kw), reps=20, warmup=2)
            plain_ms = cuda_ms(lambda: plain(*args, **kw), reps=2)
        out.append(with_refused(dict(
            name=twin_name, route="cuda", source=SOURCES[twin_name],
            replaces=REPLACES[twin_name], launches=launches[twin_name], path="tools",
            step_launches=main_launches["step"][twin_name],
            view_run_launches=main_launches["views"][twin_name], max_abs_err=err,
            mid_scene_max_abs_err=mid_errs[twin_name], ms=twin_ms[twin_name],
            plain_ms=plain_ms, bound_ms=main["bound_ms"], bound_by=main["bound_by"],
            library_ms=None, plain_source=PLAIN_SOURCE[twin_name], event_ms=event_ms,
            bytes=main["bytes"], flops=main["flops"], main_ms=main["ms"],
            **ops_per_call(lambda: twin(*args, **kw), DEVICE_KERNELS[twin_name]))))
    return out


def views_line(torch, draw, draw_replayed, eager_outputs, views, fast):
    """The views phase for one mode: per view the ms of a render dispatched
    (render()) and of a replay of the captured render (render_replayed),
    by CUDA events over 5 renders each after a warm-up (the first replay
    captures), and by the host clock over one render of each view; every
    replay equal to the main phase's eager render of its view bit for bit;
    the replays' launches (one graph for the four views)."""
    from gsjax_torch.render import graph
    from gsjax_torch.tools.common import cuda_ms

    graph.drop_render_graphs()
    graph.reset_graph_counts()
    dispatched, replayed, bitwise = [], [], {}
    for view in views:
        dispatched.append(cuda_ms(lambda: draw(view, fast), reps=5))
        replayed.append(cuda_ms(lambda: draw_replayed(view, fast), reps=5))
        got, want = draw_replayed(view, fast), eager_outputs[(view, fast)]
        bitwise[view] = (torch.equal(got.image.view(torch.int32), want.image.view(torch.int32))
                         and int(got.num_instances) == int(want.num_instances))
    if not all(bitwise.values()):
        raise AssertionError(f"views: replays differ from eager renders: {bitwise}")
    host = {}
    for form, fn in (("dispatched", draw), ("replayed", draw_replayed)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for view in views:
            fn(view, fast)
        torch.cuda.synchronize()
        host[form] = (time.perf_counter() - t0) * 1e3 / len(views)
    per_replay = graph.captures[-1]["launches"]
    want = {"composite_forward": 1, "rank_prefix": 1, "row_gather": 2}
    if len(graph.captures) != 1 or any(per_replay[k] != n for k, n in want.items()):
        raise AssertionError(f"views: captures {graph.captures}")
    mean = sum(replayed) / len(replayed)
    mean_dispatched = sum(dispatched) / len(dispatched)
    return {"phase": "views", "fast_fwd": fast, "ms_per_view": replayed,
            "mean_ms": mean, "ms_per_view_dispatched": dispatched,
            "mean_ms_dispatched": mean_dispatched, "host_ms_per_view": host["replayed"],
            "host_ms_per_view_dispatched": host["dispatched"],
            "mpx_per_s": BENCH_W * BENCH_H / mean / 1e3,
            "mpx_per_s_dispatched": BENCH_W * BENCH_H / mean_dispatched / 1e3,
            "replays_equal_eager_bitwise": bitwise, "capture": graph.captures[-1],
            "replayed_launches": dict(graph.replayed_launch_counts)}


def render_set_growth(torch, render, params, aux, views):
    """cli.render's render_set on a bank of the four views from budgets of
    2^19 / 2^18, under the bench view's 1.16M pairs: the first frame
    overflows, the captured render of the outgrown budgets is dropped and
    one of the grown budgets captured; every frame equal to an eager
    render at the grown budgets bit for bit. The saved frames are
    collected in place of the PNGs."""
    import io
    import os
    import tempfile

    import numpy as np

    from gsjax_torch.cli import render as render_cli
    from gsjax_torch.config import RasterConfig
    from gsjax_torch.render import graph
    from gsjax_torch.scene import CameraBank

    t0 = time.perf_counter()
    shape = (BENCH_H, BENCH_W)
    bank = CameraBank.from_cameras(list(views.values()),
                                   [np.zeros((3, *shape), np.uint8)] * len(views),
                                   [np.full((1, *shape), 255, np.uint8)] * len(views))
    frames = {}
    save_png = render_cli.save_png
    render_cli.save_png = lambda path, image: frames.__setitem__(path, image)
    graph.drop_render_graphs()
    graph.reset_graph_counts()
    small = RasterConfig(tile_w=32, tile_h=32, max_instances=1 << 19, max_rows=1 << 18)
    bg = torch.zeros(3, device=params.device)
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    try:
        with tempfile.TemporaryDirectory(dir=build) as model, \
                contextlib.redirect_stdout(io.StringIO()):
            cfg = render_cli.render_set(model, "test", 0, [bank], params, aux.alive, 3,
                                        bg, small)
    finally:
        render_cli.save_png = save_png
    budgets = [c["budgets"] for c in graph.captures]
    renders = [frames[p] for p in sorted(frames) if "/renders/" in p]
    with torch.no_grad():
        bitwise = [torch.equal(got.view(torch.int32), render(
            params, cam, active_sh_degree=3, bg_color=bg, cfg=cfg,
            alive=aux.alive).image.view(torch.int32))
            for got, cam in zip(renders, views.values())]
    if (len(renders) != len(views) or not all(bitwise) or budgets[0] != [1 << 19, 1 << 18]
            or budgets[-1] != [cfg.max_instances, cfg.max_rows] or len(budgets) < 2):
        raise AssertionError(f"render_set: budgets {budgets}, frames equal {bitwise}")
    graph.drop_render_graphs()
    return {"phase": "views", "case": "render_set_growth", "captured_budgets": budgets,
            "final_budgets": [cfg.max_instances, cfg.max_rows],
            "frames_equal_eager_bitwise": bitwise, "seconds": time.perf_counter() - t0}


def phase_train(torch, kernels, random_scene, camera, gt, dev):
    """train_step() on the bench scene at full width: the ground truth is
    the exact render of the scene from `camera`; training starts from the
    same scene with features_dc and the opacity logits perturbed by
    numpy-seeded noise (seed 1, sigma 0.1). L1 + SSIM (lambda_dssim 0.2),
    the default OptimizationConfig. 3 warm-up steps, then 10 timed ones;
    every kernel's launch count over those 13 steps. Then one more step
    records each kernel's arguments, and one is profiled. Returns (the
    recorded calls, the launch counts, the state after the steps)."""
    import numpy as np

    from gsjax_torch.config import OptimizationConfig, RasterConfig
    from gsjax_torch.model import PARAM_NAMES
    from gsjax_torch.train.optimizer import adam_init
    from gsjax_torch.train.step import TrainState, train_step
    from gsjax_torch.tools.common import profile_table

    params, aux = random_scene(
        BENCH_N, capacity=BENCH_N, sh_degree=3, seed=0, spread=2.5,
        scale_range=(0.004, 0.03), device=dev,
    )
    rng = np.random.default_rng(1)
    with torch.no_grad():
        for name in ("features_dc", "opacity"):
            leaf = getattr(params, name)
            noise = rng.normal(0.0, SCENE_NOISE_SIGMA, tuple(leaf.shape))
            leaf.add_(torch.as_tensor(noise.astype(np.float32), device=dev))
    before = {k: getattr(params, k).detach().clone() for k in PARAM_NAMES}
    state = TrainState(params=params, opt=adam_init(params), aux=aux,
                       step=torch.ones((), dtype=torch.int32, device=dev))
    cfg = RasterConfig(tile_w=32, tile_h=32, **BENCH_BUDGETS)
    bg = torch.zeros(3, device=dev)

    def step(st):
        return train_step(st, camera, gt, bg, active_sh_degree=3,
                          opt_cfg=OptimizationConfig(), raster_cfg=cfg,
                          spatial_lr_scale=SPATIAL_LR_SCALE)

    metrics = []
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    for _ in range(TRAIN_WARMUP):
        state, m = step(state)
        metrics.append(m)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(TRAIN_STEPS):
        state, m = step(state)
        metrics.append(m)
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
    ms = start.elapsed_time(end) / TRAIN_STEPS
    launches = dict(kernels.launch_counts)
    missing = [k for k in kernels.KERNEL_NAMES if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the training path: {missing}")

    losses = [float(m.loss) for m in metrics]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    for m in metrics:
        n_inst, n_rows = int(m.num_instances), int(m.num_rows)
        if n_inst > BENCH_BUDGETS["max_instances"] or n_rows > BENCH_BUDGETS["max_rows"]:
            raise AssertionError(f"training: budget overflow ({n_inst}, {n_rows})")
    unchanged = [k for k in PARAM_NAMES
                 if torch.equal(getattr(state.params, k).detach(), before[k])]
    if unchanged:
        raise AssertionError(f"parameter groups unchanged by training: {unchanged}")
    if not all(bool(torch.isfinite(getattr(state.aux, k)).all())
               for k in ("max_radii2d", "xyz_grad_accum", "denom")):
        raise AssertionError("non-finite densification statistics")
    emit({"phase": "train", "gaussians": BENCH_N, "width": BENCH_W, "height": BENCH_H,
          "tile": "32x32", "losses": losses, "l1": [float(m.l1) for m in metrics],
          "num_instances": int(metrics[-1].num_instances),
          "num_rows": int(metrics[-1].num_rows), "ms_per_step": ms,
          "mpx_per_s": BENCH_W * BENCH_H / ms / 1e3, "host_ms_per_step": host_ms,
          "launches": launches, "step": int(state.step),
          "visible_in_stats": int((state.aux.denom > 0).sum())})

    with Recorder(kernels) as rec:
        state, _ = step(state)
    calls = dict(rec.calls)
    holder = [state]

    def one_step():
        holder[0], _ = step(holder[0])

    emit(dict(phase="profile", path="train_step", **profile_table(one_step, ms)))
    return calls, launches, holder[0]


def view_bank(torch, views, images):
    """A CameraBank of the views whose ground truths are the images
    (rounded to uint8, opaque)."""
    import numpy as np

    from gsjax_torch.scene import CameraBank

    rgbs = [(img.clamp(0, 1) * 255).round().to(torch.uint8).cpu().numpy()
            for img in images]
    alphas = [np.full((1, *rgb.shape[1:]), 255, np.uint8) for rgb in rgbs]
    return CameraBank.from_cameras(list(views), rgbs, alphas)


def states_equal(torch, steps, a, b, ma=None, mb=None) -> bool:
    """Every tensor of two train states (and of their metrics) bit for bit."""
    pairs = list(zip(steps.state_tensors(a), steps.state_tensors(b)))
    if ma is not None:
        pairs += [(getattr(ma, k), getattr(mb, k)) for k in steps.METRIC_DTYPES]
    return all(torch.equal(x, y) for x, y in pairs)


def lr_units(steps, a, b, opt_cfg, spatial_lr_scale) -> dict:
    """The largest |a - b| of each parameter group, in units of the
    group's learning rate at a's step."""
    from gsjax_torch.model import PARAM_NAMES
    from gsjax_torch.train.optimizer import make_lr_tree

    lr = make_lr_tree(opt_cfg, spatial_lr_scale, a.step)
    return {k: float((getattr(a.params, k) - getattr(b.params, k)).abs().max() / lr[k])
            for k in PARAM_NAMES}


def replays_against_eager(torch, steps, eager_a, eager_b, graphed, opt_cfg,
                          where: str) -> dict:
    """Two eager windows' (state, metrics) and the replayed window's: where
    the eager windows agree bit for bit, the replays must equal them bit
    for bit; where they do not, the largest difference per parameter in lr
    units, the replays' at most GRAPH_LR_MULTIPLE times the eager pair's."""
    eager_bitwise = states_equal(torch, steps, eager_a[0], eager_b[0], eager_a[1], eager_b[1])
    graph_bitwise = states_equal(torch, steps, eager_a[0], graphed[0], eager_a[1], graphed[1])
    out = {"eager_bitwise_reproducible": eager_bitwise,
           "graph_equals_eager_bitwise": graph_bitwise}
    if eager_bitwise and not graph_bitwise:
        raise AssertionError(f"{where}: replays differ from the eager steps, which "
                             "reproduce bit for bit")
    if not eager_bitwise:
        out["eager_vs_eager_lr_units"] = lr_units(steps, eager_a[0], eager_b[0], opt_cfg,
                                                  SPATIAL_LR_SCALE)
        out["graph_vs_eager_lr_units"] = lr_units(steps, eager_a[0], graphed[0], opt_cfg,
                                                  SPATIAL_LR_SCALE)
        over = {k: v for k, v in out["graph_vs_eager_lr_units"].items()
                if not v <= GRAPH_LR_MULTIPLE * out["eager_vs_eager_lr_units"][k]}
        if over:
            raise AssertionError(f"{where}: replays differ from eager by more than "
                                 f"{GRAPH_LR_MULTIPLE}x eager's own spread: {over}")
    return out


def window_timings(torch, forms, n_steps: int) -> dict:
    """For each (name, window function, state) form: ms per step of one
    window by CUDA events and by the host clock, and its device busy ms,
    idle share and device ops per step (torch.profiler)."""
    from gsjax_torch.tools.common import profile_table

    out = {}
    timer = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
    for name, fn, st in forms:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        timer[0].record()
        fn(st)
        timer[1].record()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / n_steps
        ms = timer[0].elapsed_time(timer[1]) / n_steps
        prof = profile_table(lambda: fn(st), ms * n_steps)
        out[name] = {"ms_per_step": ms, "host_ms_per_step": host_ms,
                     "device_busy_ms_per_step": prof["device_busy_ms"] / n_steps,
                     "idle_share": prof["idle_share"],
                     "device_ops_per_step": prof["device_kernels"] / n_steps,
                     "mpx_per_s": BENCH_W * BENCH_H / ms / 1e3}
    return out


def replay_launches_seen(torch, kernels, steps, window, n_steps: int, where: str) -> dict:
    """The main kernels' events in one whole torch.profiler session over
    one window of n_steps replays (tools/common.whole_profile: each
    kernel's events equal the launches the port counted);
    each must be exactly the last capture's count times n_steps. Returns
    the events of the window."""
    from gsjax_torch.tools.common import device_event_names, kernel_events, whole_profile

    seen = kernel_events(device_event_names(whole_profile(window)))
    seen = {k: seen[k] for k in kernels.KERNEL_NAMES}
    want = {k: n * n_steps for k, n in steps.captures[-1]["launches"].items()}
    if seen != want:
        raise AssertionError(f"{where}: the profiler recorded {seen} launches over "
                             f"{n_steps} replays, the capture {want}")
    return seen


def phase_graph(torch, kernels, state, bank, cfg):
    """The same GRAPH_STEPS steps on the bench scene eagerly (scan_steps, a
    Python loop of _step_core) and as one window of replays of the
    captured step (train_steps), from copies of one state, views cycling
    through `bank`. Twice eagerly first: where two eager windows agree
    bit for bit, the graph's window must equal them bit for bit; where
    they do not, the largest difference per parameter in lr units is
    reported, and the graph's may be at most GRAPH_LR_MULTIPLE times the
    eager pair's for each parameter. Then each timed (CUDA events, host
    clock), profiled (device busy ms, idle share) and the graph's capture
    ms and pool bytes; the main kernels' launches in the graph's window
    from the capture's count times the replays (the capture's two eager
    warm-up steps apart), cross-checked by torch.profiler."""
    from gsjax_torch.config import OptimizationConfig
    from gsjax_torch.train import step as steps

    kw = dict(active_sh_degree=3, opt_cfg=OptimizationConfig(), raster_cfg=cfg,
              spatial_lr_scale=SPATIAL_LR_SCALE)
    cams = [i % bank.count for i in range(GRAPH_STEPS)]
    bgs = torch.zeros((GRAPH_STEPS, 3))

    def eager(st):
        return steps.scan_steps(st, bank, cams, bgs, **kw)

    def graphed(st):
        return steps.train_steps(st, bank, cams, bgs, **kw)

    start = steps.clone_state(state)
    ea, ma = eager(steps.clone_state(start))
    eb, mb = eager(steps.clone_state(start))
    steps.drop_step_graphs()
    steps.reset_graph_counts()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    gs, mg = graphed(steps.clone_state(start))
    torch.cuda.synchronize()
    launches = dict(steps.replayed_launch_counts)
    warmup = {k: n - launches[k] for k, n in steps.executed_launches().items()}
    missing = [k for k in kernels.KERNEL_NAMES if launches[k] == 0]
    if missing:
        raise AssertionError(f"graph: kernels not launched by the replays: {missing}")
    losses = [float(v) for v in mg.loss]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"graph: non-finite loss {losses}")
    if int(mg.num_instances.max()) > cfg.max_instances or int(mg.num_rows.max()) > cfg.max_rows:
        raise AssertionError("graph: budget overflow")
    line = {"phase": "graph", "steps": GRAPH_STEPS, "views": bank.count,
            **replays_against_eager(torch, steps, (ea, ma), (eb, mb), (gs, mg),
                                    kw["opt_cfg"], "graph"),
            "losses": losses, "capture": steps.captures[-1],
            "launches_per_window": launches, "warmup_launches": warmup}

    # The host syncs of one eager window (torch's sync debug mode warns at
    # each synchronizing call): a sync per step would keep the host from
    # running ahead of the card.
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            eager(steps.clone_state(start))
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [f"{w.filename.rsplit('/', 1)[-1]}:{w.lineno}" for w in caught
             if "synchroniz" in str(w.message)]
    line["eager_window_syncs"] = {at: syncs.count(at) for at in sorted(set(syncs))}

    line.update(window_timings(torch, (("eager", eager, ea), ("graph", graphed, gs)),
                               GRAPH_STEPS))
    line["profiler_launches_per_window"] = replay_launches_seen(
        torch, kernels, steps, lambda: graphed(gs), GRAPH_STEPS, "graph")
    line["frame_between_windows"] = frame_between_windows(torch, steps, graphed, gs, start,
                                                          bank, cfg)
    steps.drop_step_graphs()
    emit(line)
    return line


def frame_between_windows(torch, steps, graphed, state, start, bank, cfg) -> dict:
    """Two replayed windows from `start` on `state` (the tensors the
    captured step is bound to), once as they are and once with a viewer
    frame between them (a replayed fast render of the state, its own
    capture): the frame leaves the captured step's registry as it is,
    and the two runs end in the same state bit for bit. Raises
    otherwise."""
    import dataclasses

    from gsjax_torch.render.graph import render_replayed

    def two_windows(frame: bool):
        steps.copy_state_(state, start)
        graphed(state)
        registry = dict(steps._GRAPHS)
        if frame:
            cam, _ = bank.pick(bank.count - 1)
            render_replayed(state.params, cam, active_sh_degree=3,
                            bg_color=torch.zeros(3, device=cam.device),
                            cfg=dataclasses.replace(cfg, fast_fwd=True),
                            alive=state.aux.alive)
        kept = steps._GRAPHS == registry
        out = graphed(state)
        return steps.clone_state(out[0]), out[1], kept

    a, ma, _ = two_windows(False)
    b, mb, kept = two_windows(True)
    equal = states_equal(torch, steps, a, b, ma, mb)
    if not (kept and equal):
        raise AssertionError(f"graph: a frame between windows changed the step registry "
                             f"({not kept}) or the next window ({not equal})")
    return {"step_registry_unchanged": kept, "next_window_equal_bitwise": equal}


# --- densification and the scene path ------------------------------------------

DENSIFY_EXTENT = 2.0  # percent_dense * extent = 0.02 splits the larger half
DENSIFY_SEED = 7
GROWN_CAPACITY = 1 << 20
SCENE_ANGLES = (-0.35, -0.25, -0.15, -0.05, 0.05, 0.15, 0.25, 0.35)
SCENE_STEPS = 3
SKY_GAUSSIANS = 100_000
SPLIT_ATOL = 1e-6
PROBE_ROWS = 1 << 23


def timed(torch, fn):
    """(fn(), seconds) with the card synchronized on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def stats_dict(stats) -> dict:
    return {k: int(getattr(stats, k)) for k in
            ("n_alive", "n_cloned", "n_split", "n_pruned", "n_dropped")}


def check_densify_on_cpu(torch, before, out, noise, kw, where):
    """densify_and_prune on the CPU from the same arrays and noise as the
    card's call `out`: counts, alive mask and every copied row exact; the
    split children's xyz and scaling within SPLIT_ATOL; kept rows' moments
    exact, new rows' zero. Returns the largest split differences."""
    from gsjax_torch.interop import train_state_from_numpy, train_state_to_numpy
    from gsjax_torch.model import PARAM_NAMES
    from gsjax_torch.train.densify import densify_and_prune

    host = train_state_from_numpy(train_state_to_numpy(before), "cpu")
    want = densify_and_prune(host.params, host.aux, host.opt, noise=noise.cpu(), **kw)
    got_stats, want_stats = stats_dict(out[3]), stats_dict(want[3])
    if got_stats != want_stats:
        raise AssertionError(f"{where}: card {got_stats} != cpu {want_stats}")
    if not torch.equal(out[1].alive.cpu(), want[1].alive):
        raise AssertionError(f"{where}: alive masks differ")
    s = want_stats
    n_keep = s["n_alive"] + s["n_pruned"] + s["n_dropped"] - s["n_cloned"] - 2 * s["n_split"]
    lo = n_keep + s["n_cloned"]
    hi = lo + 2 * s["n_split"]
    split_err = {}
    for k in PARAM_NAMES:
        got, ref = getattr(out[0], k).detach().cpu(), getattr(want[0], k).detach()
        if k in ("xyz", "scaling"):
            split_err[k] = float((got[lo:hi] - ref[lo:hi]).abs().max()) if hi > lo else 0.0
            if not split_err[k] <= SPLIT_ATOL:
                raise AssertionError(f"{where}: split {k} differs by {split_err[k]}")
            got, ref = torch.cat([got[:lo], got[hi:]]), torch.cat([ref[:lo], ref[hi:]])
        if not torch.equal(got, ref):
            raise AssertionError(f"{where}: copied rows of {k} differ")
        for moments, ref_moments in ((out[2].mu, want[2].mu), (out[2].nu, want[2].nu)):
            m = moments[k].cpu()
            if not torch.equal(m, ref_moments[k]) or bool(m[n_keep:].any()):
                raise AssertionError(f"{where}: moments of {k} differ or new rows not 0")
    return split_err


def sized_config(torch, render, params, aux, cams, sh):
    """32x32 tiles with budgets pow2_budget of the largest pair and row
    counts over `cams`, measured by renders with PROBE_ROWS rows (the pair
    count is exact whenever the rows fit, whatever the pair budget)."""
    from gsjax_torch.config import MIN_RASTER_BUDGET, RasterConfig, pow2_budget

    probe = RasterConfig(tile_w=32, tile_h=32, max_instances=MIN_RASTER_BUDGET,
                         max_rows=PROBE_ROWS)
    peaks = [0, 0]
    with torch.no_grad():
        for cam in cams:
            out = render(params, cam, active_sh_degree=sh,
                         bg_color=torch.zeros(3, device=params.device), cfg=probe,
                         alive=aux.alive)
            peaks = [max(peaks[0], int(out.num_instances)), max(peaks[1], int(out.num_rows))]
    if peaks[1] > PROBE_ROWS:
        raise AssertionError(f"probe: rows overflow ({peaks})")
    return RasterConfig(tile_w=32, tile_h=32, max_instances=pow2_budget(peaks[0]),
                        max_rows=pow2_budget(peaks[1])), peaks


def checked_steps(torch, kernels, state, views, cfg, where, spatial_lr_scale):
    """train_step() once per (camera, gt) in `views`, launch counts set to
    0 just before and read just after: every main-path kernel launched,
    losses finite, no budget overflow. Returns (state, losses, launches)."""
    from gsjax_torch.config import OptimizationConfig
    from gsjax_torch.train.step import train_step

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    losses, counts = [], []
    for cam, gt in views:
        state, m = train_step(state, cam, gt, torch.zeros(3, device=gt.device),
                              active_sh_degree=3, opt_cfg=OptimizationConfig(),
                              raster_cfg=cfg, spatial_lr_scale=spatial_lr_scale)
        losses.append(m.loss)
        counts.append((m.num_instances, m.num_rows))
    torch.cuda.synchronize()
    launches = dict(kernels.launch_counts)
    missing = [k for k in kernels.KERNEL_NAMES if launches[k] == 0]
    if missing:
        raise AssertionError(f"{where}: kernels not launched: {missing}")
    losses = [float(v) for v in losses]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{where}: non-finite loss {losses}")
    for n_inst, n_rows in counts:
        if int(n_inst) > cfg.max_instances or int(n_rows) > cfg.max_rows:
            raise AssertionError(f"{where}: budget overflow ({int(n_inst)}, {int(n_rows)})")
    return state, losses, launches


def phase_densify(torch, kernels, render, state, camera, gt):
    """Densification on the bench scene's state after the train phase
    (500k Gaussians at capacity 500k, the accumulated statistics): one
    densify at full capacity (candidates dropped), growth to 2^20 by the
    trainer's rule (it grows when a densify drops; gsjax/train/trainer.py:
    679-686), a densify of the grown state (nothing dropped), an opacity
    reset and a training step on the result. Each densify is held to the
    same call on the CPU with the card's generator's draws injected."""
    from gsjax_torch.config import OptimizationConfig
    from gsjax_torch.tools.common import cuda_ms
    from gsjax_torch.train.densify import densify_and_prune, reset_opacity, split_noise
    from gsjax_torch.train.step import TrainState
    from gsjax_torch.train.trainer import grow_capacity

    t_phase = time.perf_counter()
    dev = camera.device
    opt_cfg = OptimizationConfig()
    kw = dict(grad_threshold=opt_cfg.densify_grad_threshold, min_opacity=0.005,
              extent=DENSIFY_EXTENT, max_screen_size=20,
              percent_dense=opt_cfg.percent_dense)

    def generator(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    def densify(st, seed):
        return densify_and_prune(st.params, st.aux, st.opt, generator(seed), **kw)

    line = {"phase": "densify", "gaussians": int(state.aux.n_alive()),
            "capacity": state.params.capacity, "extent": DENSIFY_EXTENT,
            "generator_seed": DENSIFY_SEED, **kw,
            "hot": int(((state.aux.xyz_grad_accum / state.aux.denom.clamp(min=1.0))
                        >= kw["grad_threshold"]).logical_and(state.aux.alive).sum())}
    full, line["densify_s"] = timed(torch, lambda: densify(state, DENSIFY_SEED))
    line["full_capacity"] = stats_dict(full[3])
    if line["full_capacity"]["n_dropped"] <= 0:
        raise AssertionError(f"densify at full capacity dropped nothing: {line}")
    grown, line["grow_s"] = timed(torch, lambda: grow_capacity(state, GROWN_CAPACITY))
    line["grown_capacity"] = GROWN_CAPACITY
    regrown, _ = timed(torch, lambda: densify(grown, DENSIFY_SEED + 1))
    line["after_growth"] = s = stats_dict(regrown[3])
    if s["n_dropped"] != 0 or s["n_cloned"] <= 0 or s["n_split"] <= 0:
        raise AssertionError(f"densify after growth: {s}")
    line["cpu_split_max_abs_err"] = {
        where: check_densify_on_cpu(
            torch, before, out,
            split_noise(before.params.capacity, dev, generator(seed)), kw, where)
        for where, before, out, seed in (
            ("full_capacity", state, full, DENSIFY_SEED),
            ("after_growth", grown, regrown, DENSIFY_SEED + 1))}
    params, opt = reset_opacity(regrown[0], regrown[2])
    if not float(torch.sigmoid(params.opacity.detach()).max()) <= 0.01 + 1e-6:
        raise AssertionError("reset_opacity left an opacity above 0.01")
    dense = TrainState(params=params, opt=opt, aux=regrown[1], step=state.step)
    cfg, line["probe_peaks"] = sized_config(torch, render, params, regrown[1], [camera], 3)
    line["budgets"] = [cfg.max_instances, cfg.max_rows]
    _, line["loss"], line["launches"] = checked_steps(
        torch, kernels, dense, [(camera, gt)], cfg, "densify", SPATIAL_LR_SCALE)
    line["densify_ms"] = {
        "full_capacity": cuda_ms(lambda: densify(state, DENSIFY_SEED), reps=3),
        "after_growth": cuda_ms(lambda: densify(grown, DENSIFY_SEED + 1), reps=3)}
    line["grow_capacity_ms"] = cuda_ms(lambda: grow_capacity(state, GROWN_CAPACITY), reps=3)
    line["phase_seconds"] = time.perf_counter() - t_phase
    emit(line)


def write_colmap_scene(torch, root, params, views, render):
    """A COLMAP binary model of the bench scene: one PINHOLE camera per view
    at the views' size, the scene's centres with the colours of its DC
    term as points3D, and the exact renders of the scene from the views as
    PNG images. Returns each view's (qvec, tvec)."""
    import os

    import numpy as np
    from PIL import Image

    from gsjax_torch.config import RasterConfig
    from gsjax_torch.core.cameras import fov2focal
    from gsjax_torch.core.sh import SH2RGB
    from gsjax_torch.data import colmap

    sparse = os.path.join(root, "sparse", "0")
    os.makedirs(sparse)
    os.makedirs(os.path.join(root, "images"))
    cfg = RasterConfig(tile_w=32, tile_h=32, **BENCH_BUDGETS)
    cams, images, poses = {}, {}, []
    for i, cam in enumerate(views, start=1):
        fov_x = 2.0 * math.atan(float(cam.tan_fovx))
        fov_y = 2.0 * math.atan(float(cam.tan_fovy))
        cams[i] = colmap.ColmapCamera(i, "PINHOLE", cam.width, cam.height, np.array(
            [fov2focal(fov_x, cam.width), fov2focal(fov_y, cam.height),
             cam.width / 2.0, cam.height / 2.0]))
        view = cam.view.cpu().numpy().astype(np.float64)
        qvec, tvec = colmap.rotmat2qvec(view[:3, :3]), view[:3, 3]
        poses.append((qvec, tvec))
        images[i] = colmap.ColmapImage(i, qvec, tvec, i, f"view_{i:02d}.png")
        with torch.no_grad():
            img = render(params, cam, active_sh_degree=3,
                         bg_color=torch.zeros(3, device=cam.device), cfg=cfg).image
        u8 = (img.clamp(0, 1) * 255).round().to(torch.uint8).permute(1, 2, 0).cpu().numpy()
        Image.fromarray(u8).save(os.path.join(root, "images", f"view_{i:02d}.png"),
                                 compress_level=1)
    colmap.write_cameras_binary(cams, os.path.join(sparse, "cameras.bin"))
    colmap.write_images_binary(images, os.path.join(sparse, "images.bin"))
    n = BENCH_N
    xyz = params.xyz.detach()[:n].cpu().numpy().astype(np.float64)
    rgb = np.clip(SH2RGB(params.features_dc.detach()[:n, 0].cpu().numpy()), 0, 1) * 255
    colmap.write_points3d_binary(xyz, np.round(rgb), np.zeros(n),
                                 os.path.join(sparse, "points3D.bin"))
    return poses


def phase_scene(torch, kernels, render, params):
    """The scene path from a dataset on disk: a COLMAP model of the bench
    scene (write_colmap_scene) read into a Scene on the card (native 3-NN
    init), once more with the sky shell; the extent, centre and banks held
    to a numpy recomputation; the native 3-NN against the torch 3-NN on the
    card; three train steps that pick their views from the bank on the
    device, a densify, a PLY save reloaded through load_iteration, and an
    npz checkpoint saved and reloaded. Returns the Scene (its dataset's
    files are gone) and its ModelConfig."""
    import os
    import tempfile

    import numpy as np

    from gsjax_torch import native
    from gsjax_torch.config import ModelConfig, OptimizationConfig
    from gsjax_torch.data import colmap
    from gsjax_torch.knn import mean_knn_dist2
    from gsjax_torch.model import PARAM_NAMES, create_from_pcd
    from gsjax_torch.scene import Scene
    from gsjax_torch.synthetic import orbit_camera
    from gsjax_torch.train.checkpoint import load_checkpoint, save_checkpoint
    from gsjax_torch.train.densify import densify_and_prune
    from gsjax_torch.train.optimizer import adam_init
    from gsjax_torch.train.step import TrainState

    t_phase = time.perf_counter()
    dev = params.device
    seconds = {}
    line = {"phase": "scene", "gaussians": BENCH_N, "views": len(SCENE_ANGLES),
            "width": BENCH_W, "height": BENCH_H, "images": "png"}
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as root:
        views = [orbit_camera(a, width=BENCH_W, height=BENCH_H, device=dev)
                 for a in SCENE_ANGLES]
        poses, seconds["write_dataset"] = timed(
            torch, lambda: write_colmap_scene(torch, root, params, views, render))
        cfg = ModelConfig(source_path=root, model_path=os.path.join(root, "model"),
                          sh_degree=3, resolution=1)
        scene, seconds["scene"] = timed(torch, lambda: Scene(cfg, device=dev))
        line["native_3nn"] = native.load_native() is not None
        if not line["native_3nn"]:
            line["native_unavailable"] = native.unavailable_reason

        centers = np.stack([-colmap.qvec2rotmat(q).T @ t for q, t in poses])
        radius = 1.1 * float(np.linalg.norm(centers - centers.mean(0), axis=1).max())
        bank = scene.get_train_banks()[0]
        shapes = {k: list(getattr(bank, k).shape) for k in
                  ("views", "full_projs", "centers", "gt_rgb", "alpha")}
        want = {"views": [8, 4, 4], "full_projs": [8, 4, 4], "centers": [8, 3],
                "gt_rgb": [8, 3, BENCH_H, BENCH_W], "alpha": [8, 1, BENCH_H, BENCH_W]}
        if (len(scene.get_train_banks()) != 1 or shapes != want
                or not math.isclose(scene.cameras_extent, radius, rel_tol=1e-5)
                or not np.allclose(scene.scene_center, centers.mean(0), rtol=0, atol=1e-5)):
            raise AssertionError(f"scene: extent {scene.cameras_extent} vs {radius}, "
                                 f"centre {scene.scene_center} vs {centers.mean(0)}, "
                                 f"banks {shapes}")
        line.update(cameras_extent=scene.cameras_extent, numpy_extent=radius,
                    scene_center=scene.scene_center.tolist(), bank_shapes=shapes,
                    capacity=scene.params.capacity, alive=int(scene.aux.n_alive()))

        pcd = scene.info.point_cloud
        _, seconds["create_from_pcd"] = timed(
            torch, lambda: create_from_pcd(pcd.points, pcd.colors, 3, device=dev))
        pts = np.asarray(pcd.points, np.float32)
        ref, seconds["native_3nn"] = timed(torch, lambda: native.mean_knn_dist2_native(pts))
        ours, seconds["torch_3nn_card"] = timed(
            torch, lambda: mean_knn_dist2(torch.as_tensor(pts, device=dev)))
        if ref is not None:
            ours = ours.cpu().numpy()
            line["knn_max_rel_err"] = float((np.abs(ours - ref) / np.maximum(ref, 1e-30)).max())
            if not np.allclose(ours, ref, rtol=1e-4, atol=1e-6):
                raise AssertionError(f"torch 3-NN vs native: {line['knn_max_rel_err']}")

        sky_cfg = ModelConfig(source_path=root, model_path=os.path.join(root, "sky"),
                              sh_degree=3, resolution=1, sky_gaussians=SKY_GAUSSIANS)
        sky, seconds["scene_sky"] = timed(torch, lambda: Scene(sky_cfg, device=dev))
        line["sky"] = {"gaussians": SKY_GAUSSIANS, "capacity": sky.params.capacity,
                       "alive": int(sky.aux.n_alive())}
        if line["sky"]["alive"] != BENCH_N + SKY_GAUSSIANS:
            raise AssertionError(f"sky shell: {line['sky']}")
        del sky

        state = TrainState(params=scene.params, opt=adam_init(scene.params), aux=scene.aux,
                           step=torch.ones((), dtype=torch.int32, device=dev))
        picks = [bank.pick(torch.tensor(i % bank.count, device=dev))
                 for i in range(SCENE_STEPS)]
        rcfg, line["probe_peaks"] = sized_config(
            torch, render, state.params, state.aux, [cam for cam, _ in picks], 3)
        line["budgets"] = [rcfg.max_instances, rcfg.max_rows]
        (state, line["losses"], line["launches"]), seconds["train_steps"] = timed(
            torch, lambda: checked_steps(torch, kernels, state, picks, rcfg, "scene",
                                         scene.cameras_extent))
        opt_cfg = OptimizationConfig()
        out, seconds["densify"] = timed(torch, lambda: densify_and_prune(
            state.params, state.aux, state.opt, torch.Generator(device=dev).manual_seed(0),
            grad_threshold=opt_cfg.densify_grad_threshold, min_opacity=0.005,
            extent=scene.cameras_extent, max_screen_size=0,
            percent_dense=opt_cfg.percent_dense))
        line["densify"] = stats_dict(out[3])
        state = TrainState(params=out[0], opt=out[2], aux=out[1], step=state.step)

        _, seconds["save_ply"] = timed(
            torch, lambda: scene.save(SCENE_STEPS, state.params, state.aux.alive))
        back, seconds["reload_scene"] = timed(
            torch, lambda: Scene(cfg, load_iteration=SCENE_STEPS, device=dev))
        n_alive, alive = int(state.aux.n_alive()), state.aux.alive
        if int(back.aux.n_alive()) != n_alive or not all(
                torch.equal(getattr(back.params, k)[:n_alive], getattr(state.params, k)[alive])
                for k in PARAM_NAMES):
            raise AssertionError("PLY reload differs from the saved alive rows")
        ckpt = os.path.join(root, "model", f"chkpnt{SCENE_STEPS}.npz")
        _, seconds["save_ckpt"] = timed(
            torch, lambda: save_checkpoint(ckpt, state, 3, scene.cameras_extent))
        (loaded, sh, lr), seconds["load_ckpt"] = timed(
            torch, lambda: load_checkpoint(ckpt, dev))
        pairs = [(getattr(loaded.params, k), getattr(state.params, k)) for k in PARAM_NAMES]
        pairs += [(loaded.opt.mu[k], state.opt.mu[k]) for k in PARAM_NAMES]
        pairs += [(loaded.opt.nu[k], state.opt.nu[k]) for k in PARAM_NAMES]
        pairs += [(getattr(loaded.aux, k), getattr(state.aux, k))
                  for k in ("alive", "max_radii2d", "xyz_grad_accum", "denom")]
        pairs += [(loaded.opt.count, state.opt.count), (loaded.step, state.step)]
        if (sh, lr) != (3, scene.cameras_extent) or not all(
                a.dtype == b.dtype and torch.equal(a, b) for a, b in pairs):
            raise AssertionError("checkpoint reload differs")
        line["ckpt_mb"] = os.path.getsize(ckpt) / 2**20
    line["seconds"] = seconds
    line["phase_seconds"] = time.perf_counter() - t_phase
    emit(line)
    return scene, cfg


# --- the device mesh (gsjax_torch.parallel) on one card -------------------------

MESH_STEPS = 5
# Two windows of 32: the first holds the capture, the second only replays.
MESH_TRAINER_ITERATIONS = 64
MESH_IMAGE_ATOL = 2e-5
MESH_LOSS_RTOL = 1e-5
MESH_GRAD_TOL = 5e-3
MESH_SLAB_SPLITS = (2, 4)
# The mesh window's steps, eagerly and as replays of the captured step.
MESH_GRAPH_STEPS = 10


def mesh_gradients(torch, params, aux, camera, gt, cfg):
    """The eager single-device objective of train_step and its parameter
    gradients (render, L1 + SSIM, autograd)."""
    from gsjax_torch.config import OptimizationConfig
    from gsjax_torch.model import PARAM_NAMES
    from gsjax_torch.render.api import render
    from gsjax_torch.train.loss import l1_loss, ssim

    lam = OptimizationConfig().lambda_dssim
    img = render(params, camera, active_sh_degree=3, bg_color=torch.zeros(3, device=gt.device),
                 cfg=cfg, alive=aux.alive).image
    loss = (1.0 - lam) * l1_loss(img, gt) + lam * (1.0 - ssim(img, gt))
    grads = torch.autograd.grad(loss, [getattr(params, k) for k in PARAM_NAMES])
    return float(loss.detach()), dict(zip(PARAM_NAMES, grads))


def stitched_slabs(torch, params, aux, camera, cfg, n_tile):
    """composite_slab for each of n_tile slabs in this one process, the
    slabs stitched and cropped, the background (zeros) applied; and each
    slab's [num_instances, num_rows]."""
    from gsjax_torch.parallel.render import composite_slab, slab_rows
    from gsjax_torch.render.preprocess import preprocess

    rows = slab_rows(camera.height, n_tile, cfg.th)
    with torch.no_grad():
        proj = preprocess(xyz=params.xyz, sh=params.get_features(),
                          opacity=params.get_opacity(), scaling=params.get_scaling(),
                          rotation=params.rotation, camera=camera, active_sh_degree=3,
                          alive=aux.alive)
        slabs, counts = [], []
        for i in range(n_tile):
            color, t, c = composite_slab(
                proj.mean_pix, proj.conic, proj.rgb, proj.opacity, proj.depth, proj.ext,
                proj.qmax, height=camera.height, width=camera.width, cfg=cfg,
                py0=float(i * rows * cfg.th), rows=rows)
            slabs.append(color)
            counts.append([int(v) for v in c])
        image = torch.cat(slabs, dim=1)[:, :camera.height, :camera.width]
    return image, counts, rows


def mesh_graph(torch, kernels, mesh, params, aux, bank, cfg) -> dict:
    """The mesh window on the 1x1 NCCL mesh: MESH_GRAPH_STEPS sharded steps
    on the bank's views in turn, twice as the eager loop and once as
    replays of the captured sharded step (make_sharded_train_steps), from
    copies of one state; the replays against the eager windows
    (replays_against_eager); ms per step, device busy ms and idle share of
    each; launches: the counts set to 0 just before the replayed window
    and read just after (the capture's count times the replays; its two
    eager warm-up steps apart), cross-checked by torch.profiler."""
    from gsjax_torch.config import OptimizationConfig
    from gsjax_torch.parallel.step import make_sharded_train_steps
    from gsjax_torch.train import step as steps
    from gsjax_torch.train.optimizer import adam_init

    opt_cfg = OptimizationConfig()
    window_steps = make_sharded_train_steps(
        mesh, height=BENCH_H, width=BENCH_W, active_sh_degree=3, opt_cfg=opt_cfg,
        raster_cfg=cfg, spatial_lr_scale=SPATIAL_LR_SCALE)
    picks = [bank.pick(i % bank.count) for i in range(MESH_GRAPH_STEPS)]
    window = tuple(torch.stack([get(cam, gt)[None] for cam, gt in picks]) for get in (
        lambda c, g: c.view, lambda c, g: c.full_proj, lambda c, g: c.cam_center,
        lambda c, g: c.tan_fovx, lambda c, g: c.tan_fovy, lambda c, g: g))
    bgs = torch.zeros((MESH_GRAPH_STEPS, 3))
    start = steps.TrainState(params=params, opt=adam_init(params), aux=aux,
                             step=torch.ones((), dtype=torch.int32, device=params.device))

    def eager(st):
        return window_steps.loop(st, *window, bgs)

    def graphed(st):
        return window_steps(st, *window, bgs)

    ea, ma = eager(steps.clone_state(start))
    eb, mb = eager(steps.clone_state(start))
    steps.drop_step_graphs()
    steps.reset_graph_counts()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    gs, mg = graphed(steps.clone_state(start))
    torch.cuda.synchronize()
    launches = dict(steps.replayed_launch_counts)
    warmup = {k: n - launches[k] for k, n in steps.executed_launches().items()}
    missing = [k for k in kernels.KERNEL_NAMES if launches[k] == 0]
    losses = [float(v) for v in mg.loss]
    if missing or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"mesh_graph: kernels not launched {missing}, losses {losses}")
    out = {"steps": MESH_GRAPH_STEPS, "views": bank.count,
           **replays_against_eager(torch, steps, (ea, ma), (eb, mb), (gs, mg), opt_cfg,
                                   "mesh_graph"),
           "losses": losses, "capture": steps.captures[-1],
           "launches_per_window": launches, "warmup_launches": warmup}
    out.update(window_timings(torch, (("eager", eager, ea), ("graph", graphed, gs)),
                              MESH_GRAPH_STEPS))
    out["profiler_launches_per_window"] = replay_launches_seen(
        torch, kernels, steps, lambda: graphed(gs), MESH_GRAPH_STEPS, "mesh_graph")
    steps.drop_step_graphs()
    return out


def phase_mesh(torch, kernels, render, params, aux, camera, gt_camera, bank, scene,
               scene_cfg):
    """The mesh path (gsjax_torch.parallel) on this one card: a world-size-1
    NCCL group started in this process (127.0.0.1, a free port) and a 1x1
    ("data", "tile") DeviceMesh; the bench scene at full width (500k
    Gaussians, SH degree 3, 1920x1080, 32x32 tiles, the bench budgets).
    Checks: render_sharded against render() within 2e-5; composite_slab
    for each slab at n_tile 2 and 4, stitched, against render() within
    2e-5, the slabs' pair and row counts summing to the view's exactly at
    n_tile 2 (34 tile rows split evenly) and at least to them at n_tile 4
    (the last slab overruns); the six kernels on the 1x1 slab against
    their plain versions; sharded_grads against the eager step's gradients
    (loss rtol 1e-5, gradients 5e-3 of each column's largest); one sharded
    step's parameters after Adam against train_step's (fewer than 0.5 % of
    elements beyond 5e-5 + 1e-3 |b|); a Trainer on the mesh for 64
    iterations on the scene phase's Scene (two windows of 32: the first
    captures), its loss finite. Timings: the
    group's start-up seconds (rendezvous and the first all_reduce), ms per
    step of the eager sharded step and of train_step in turns, launches of
    the six kernels per sharded step (counts set to 0 just before
    MESH_STEPS sharded steps and read just after). The group is destroyed
    at the end. Returns ({kernel: launches per sharded step}, {kernel: max
    abs error on the slab})."""
    import torch.distributed as dist

    from gsjax_torch.config import OptimizationConfig, RasterConfig
    from gsjax_torch.model import PARAM_NAMES
    from gsjax_torch.parallel import make_mesh, render_sharded
    from gsjax_torch.parallel.multihost import init_local_group
    from gsjax_torch.parallel.step import make_sharded_train_step
    from gsjax_torch.tools import bench_mesh_overhead
    from gsjax_torch.train import step as steps
    from gsjax_torch.train.optimizer import adam_init
    from gsjax_torch.train.step import TrainState, clone_state, train_step
    from gsjax_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    dev = params.device
    cfg = RasterConfig(tile_w=32, tile_h=32, **BENCH_BUDGETS)
    line = {"phase": "mesh", "mesh": [1, 1], "backend": "nccl", "gaussians": BENCH_N,
            "width": BENCH_W, "height": BENCH_H, "tile": "32x32"}
    t0 = time.perf_counter()
    port = init_local_group("cuda")
    try:
        mesh = make_mesh("cuda", data=1, tile=1)
        warm = torch.ones(1, device=dev)
        dist.all_reduce(warm)
        torch.cuda.synchronize()
        line.update(nccl_init_s=time.perf_counter() - t0, port=port,
                    warm_all_reduce=float(warm))
        if float(warm) != 1.0:
            raise AssertionError(f"mesh: a one-rank all_reduce gave {float(warm)}")
        bg = torch.zeros(3, device=dev)

        # render_sharded and the slabs against render().
        with torch.no_grad():
            full = render(params, camera, active_sh_degree=3, bg_color=bg, cfg=cfg,
                          alive=aux.alive)
            sharded = render_sharded(params, camera, mesh=mesh, active_sh_degree=3,
                                     bg_color=bg, cfg=cfg, alive=aux.alive)
        err = float((sharded - full.image).abs().max())
        line["render_sharded_max_abs_err"] = err
        if not err <= MESH_IMAGE_ATOL:
            raise AssertionError(f"mesh: render_sharded vs render {err} > {MESH_IMAGE_ATOL}")
        view_counts = [int(full.num_instances), int(full.num_rows)]
        line["view_counts"] = view_counts
        for n_tile in MESH_SLAB_SPLITS:
            image, counts, rows = stitched_slabs(torch, params, aux, camera, cfg, n_tile)
            err = float((image - full.image).abs().max())
            sums = [sum(c[0] for c in counts), sum(c[1] for c in counts)]
            line[f"slabs_{n_tile}"] = {"rows_per_slab": rows, "max_abs_err": err,
                                       "counts": counts, "sums": sums}
            if not err <= MESH_IMAGE_ATOL:
                raise AssertionError(f"mesh: {n_tile} stitched slabs vs render {err}")
            # Split evenly, the slabs partition the view's pairs and rows; a
            # last slab past the image may bin Gaussians the view does not.
            even = rows * n_tile == -(-BENCH_H // cfg.th)
            line[f"slabs_{n_tile}"]["split_evenly"] = even
            if even and sums != view_counts or not even and (
                    sums[0] < view_counts[0] or sums[1] < view_counts[1]):
                raise AssertionError(f"mesh: {n_tile} slabs count {sums} against the "
                                     f"view's {view_counts}")
        del full, sharded, image

        # The sharded step on the bench scene: gradients, Adam, the kernels.
        with torch.no_grad():
            gt = render(params, gt_camera, active_sh_degree=3, bg_color=bg, cfg=cfg,
                        alive=aux.alive).image
        opt_cfg = OptimizationConfig()
        step = make_sharded_train_step(
            mesh, height=BENCH_H, width=BENCH_W, active_sh_degree=3, opt_cfg=opt_cfg,
            raster_cfg=cfg, spatial_lr_scale=SPATIAL_LR_SCALE)
        args = (camera.view[None], camera.full_proj[None], camera.cam_center[None],
                camera.tan_fovx[None], camera.tan_fovy[None], gt[None])
        want_loss, want = mesh_gradients(torch, params, aux, camera, gt, cfg)
        with Recorder(kernels) as rec:
            g, _, _, _, loss, _, counts = step.sharded_grads(params, aux.alive, *args, bg)
        slab_calls = dict(rec.calls)
        rel = abs(float(loss) - want_loss) / abs(want_loss)
        grad_err = {}
        for k in PARAM_NAMES:
            a = g[k].reshape(BENCH_N, -1)
            b = want[k].reshape(BENCH_N, -1)
            scale = b.abs().amax(dim=0).clamp(min=1e-30)
            grad_err[k] = float(((a - b).abs() / scale).max())
        line.update(loss=float(loss), eager_loss=want_loss, loss_rel_err=rel,
                    grad_err_of_column_max=grad_err, counts=[int(v) for v in counts])
        if not rel <= MESH_LOSS_RTOL or not all(v <= MESH_GRAD_TOL for v in grad_err.values()):
            raise AssertionError(f"mesh: sharded_grads vs the eager step: loss {rel}, "
                                 f"gradients {grad_err}")
        del g, want

        # The six kernels on the slab's own arguments.
        slab_errs = check_backward_kernels(
            kernels, slab_calls, dict.fromkeys(kernels.KERNEL_NAMES, 0.0), "mesh slab")
        slab_errs = {k: v[0] for k, v in slab_errs.items()}
        for name in FORWARD_KERNELS:
            a, kw = slab_calls[name]
            with torch.no_grad():
                slab_errs[name] = max_err(getattr(kernels, name)(*a, **kw),
                                          getattr(kernels, f"{name}_plain")(*a, **kw))
            tol = 2e-3 if name == "composite_forward" else 0.0
            if not slab_errs[name] <= tol:
                raise AssertionError(f"mesh slab: {name} vs plain {slab_errs[name]} > {tol}")
        line["slab_kernel_max_abs_err"] = slab_errs
        del slab_calls

        # One sharded step after Adam against train_step from the same state.
        start = TrainState(params=params, opt=adam_init(params), aux=aux,
                           step=torch.ones((), dtype=torch.int32, device=dev))
        s1, m1 = train_step(clone_state(start), camera, gt, bg, active_sh_degree=3,
                            opt_cfg=opt_cfg, raster_cfg=cfg,
                            spatial_lr_scale=SPATIAL_LR_SCALE)
        s2, m2 = step(clone_state(start), *args, bg)
        bad = {}
        for k in PARAM_NAMES:
            a, b = getattr(s2.params, k).detach(), getattr(s1.params, k).detach()
            bad[k] = float(((a - b).abs() > 5e-5 + 1e-3 * b.abs()).float().mean())
        line.update(adam_mismatch_share=bad, step_loss=float(m2.loss),
                    train_step_loss=float(m1.loss))
        if not all(v < 0.005 for v in bad.values()):
            raise AssertionError(f"mesh: sharded step vs train_step after Adam: {bad}")
        del s1, s2, start

        # Launches per sharded step, the counts set to 0 just before.
        state = clone_state(TrainState(params=params, opt=adam_init(params), aux=aux,
                                       step=torch.ones((), dtype=torch.int32, device=dev)))
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        for _ in range(MESH_STEPS):
            state, m = step(state, *args, bg)
        torch.cuda.synchronize()
        per_step = {k: kernels.launch_counts[k] / MESH_STEPS for k in kernels.KERNEL_NAMES}
        line["launches_per_sharded_step"] = per_step
        missing = [k for k, v in per_step.items() if v == 0]
        if missing or not math.isfinite(float(m.loss)):
            raise AssertionError(f"mesh: kernels not launched {missing}, loss {float(m.loss)}")
        del state

        # ms per step: the eager sharded step and train_step, in turns.
        line["overhead"] = bench_mesh_overhead.run(params, aux, camera, cfg, mesh)

        # The window as replays of the captured sharded step (mesh_graph).
        graph_line = mesh_graph(torch, kernels, mesh, params, aux, bank, cfg)
        emit({"phase": "mesh", "case": "mesh_graph", **graph_line})

        # A Trainer on the mesh, on the scene phase's Scene.
        cams = [scene.get_train_banks()[0].pick(i)[0] for i in range(4)]
        tcfg, peaks = sized_config(torch, render, scene.params, scene.aux, cams, 3)
        trainer = Trainer(scene, scene_cfg, OptimizationConfig(
            iterations=MESH_TRAINER_ITERATIONS), raster_cfg=tcfg, quiet=True, mesh=mesh)
        trainer.active_sh_degree = 3
        steps.reset_graph_counts()
        t0 = time.perf_counter()
        trainer.train(test_iterations=(), save_iterations=(), checkpoint_iterations=())
        torch.cuda.synchronize()
        windows = [e for e in trainer.events if "window" in e]
        line["trainer"] = {"iterations": int(trainer.state.step), "windows": windows,
                           "captures": list(steps.captures),
                           "budgets": [tcfg.max_instances, tcfg.max_rows], "peaks": peaks,
                           "seconds": time.perf_counter() - t0,
                           "ms_per_step": sum(e["ms"] for e in windows)
                           / max(sum(e["steps"] for e in windows), 1)}
        if int(trainer.state.step) != MESH_TRAINER_ITERATIONS:
            raise AssertionError(f"mesh: the Trainer stopped at {int(trainer.state.step)}")
        del trainer
    finally:
        dist.destroy_process_group()
    line["phase_seconds"] = time.perf_counter() - t_phase
    emit(line)
    return per_step, slab_errs, graph_line["launches_per_window"]


# --- the viewer, LPIPS and the remaining profilers (queue item 7) -----------------

VIEWER_FRAMES = 20
# LPIPS: a seeded random-weights npz in the spec's layout (pretrained
# weights cannot be fetched), the card against the CPU on a small pair,
# the card's time on a 1080p pair.
LPIPS_SEED = 7
LPIPS_CHECK_SIZE = 128
LPIPS_RTOL = 1e-4
LPIPS_REPS = 5
# The profilers' depth, cut to keep the phase short.
TOOL_ITERS = 5
SWEEP_CONFIGS = "32x32c128s1,16x16c128s1"
# bench_trained's orbit angle: the quality scene's orbit camera facing +z,
# where the bench scene's Gaussians lie.
TRAINED_ORBIT = math.pi


def viewer_message(camera, width, height, **overrides) -> dict:
    """The wire message a SIBR client sends for `camera`: the transposed
    matrices with view columns 1, 2 and view-projection column 1 negated
    (the server negates them back)."""
    import numpy as np

    view = camera.view.double().cpu().numpy().T.copy()
    view[:, 1] = -view[:, 1]
    view[:, 2] = -view[:, 2]
    full = camera.full_proj.double().cpu().numpy().T.copy()
    full[:, 1] = -full[:, 1]
    msg = {"resolution_x": width, "resolution_y": height, "train": False,
           "fov_y": 2.0 * math.atan(float(camera.tan_fovy)),
           "fov_x": 2.0 * math.atan(float(camera.tan_fovx)),
           "z_near": 0.01, "z_far": 100.0, "shs_python": False,
           "rot_scale_python": False, "keep_alive": True, "scaling_modifier": 1.0,
           "view_matrix": view.reshape(-1).tolist(),
           "view_projection_matrix": full.reshape(-1).tolist()}
    msg.update(overrides)
    return msg


def viewer_client(sock, messages, out):
    """A SIBR client on a connected socket: sends each message, reads its
    reply (the frame, then the source path) and records (frame bytes or
    None, seconds from send to the last byte) in `out`; any error in
    out["error"]. Closes the socket."""

    def recv_exact(sock, n):
        buf = bytearray(n)
        view, got = memoryview(buf), 0
        while got < n:
            k = sock.recv_into(view[got:])
            if not k:
                raise ConnectionError("viewer closed the connection")
            got += k
        return bytes(buf)

    try:
        with sock:
            for msg in messages:
                payload = json.dumps(msg).encode("utf-8")
                t0 = time.perf_counter()
                sock.sendall(len(payload).to_bytes(4, "little") + payload)
                n = msg["resolution_x"] * msg["resolution_y"] * 3
                frame = recv_exact(sock, n) if n else None
                recv_exact(sock, int.from_bytes(recv_exact(sock, 4), "little"))
                out["replies"].append((frame, time.perf_counter() - t0))
    except Exception as e:  # reported by the phase, which fails on it
        out["error"] = f"{type(e).__name__}: {e}"


def phase_viewer(torch, kernels, render, scene, model_cfg, views):
    """The viewer's serving path: a Trainer on the scene phase's Scene with
    a NetworkGUI on port 0; a client thread sends VIEWER_FRAMES requests at
    1920x1080 from the four main-phase views (train false, keep-alive), one
    zero-resolution keep-alive and a last request with train true, which
    ends Trainer._poll_gui. Each reply equals image_to_bytes of a direct
    fast_fwd render of the original camera within one uint8 level
    (tests/test_viewer.py:158); the frames write nothing of the state. The
    frames are replays of one captured render (Trainer.render_view,
    render/graph.py): a direct replay of each view equals its eager render
    bit for bit. Frame ms from send to last byte (the first frame holds
    the capture), the render's share, bytes per frame, the capture, and
    the forward kernels' launches per frame by the replays (counts set to
    0 just before the poll and read just after)."""
    import dataclasses
    import socket
    import threading

    import numpy as np

    from gsjax_torch.config import OptimizationConfig
    from gsjax_torch.train import step as steps
    from gsjax_torch.train.trainer import Trainer
    from gsjax_torch.viewer import NetworkGUI

    t_phase = time.perf_counter()
    cams = list(views.values())
    sh = scene.params.max_sh_degree
    cfg, peaks = sized_config(torch, render, scene.params, scene.aux, cams, sh)
    gui = NetworkGUI("127.0.0.1", 0)
    port = gui.listener.getsockname()[1]
    trainer = Trainer(scene, model_cfg, OptimizationConfig(), raster_cfg=cfg, gui=gui,
                      quiet=True)
    trainer.active_sh_degree = sh
    before = steps.clone_state(trainer.state)
    order = [i % len(cams) for i in range(VIEWER_FRAMES)]
    messages = [viewer_message(cams[i], BENCH_W, BENCH_H) for i in order]
    messages.append(viewer_message(cams[0], 0, 0))
    messages.append(viewer_message(cams[0], BENCH_W, BENCH_H, train=True))
    order.append(0)

    render_ms = []
    render_view = trainer.render_view

    def timed_render(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = render_view(*args, **kwargs)
        torch.cuda.synchronize()
        render_ms.append((time.perf_counter() - t0) * 1e3)
        return img

    trainer.render_view = timed_render
    out = {"replies": []}
    # Connected before the poll, which tries once to accept.
    sock = socket.create_connection(("127.0.0.1", port), timeout=120)
    client = threading.Thread(target=viewer_client, args=(sock, messages, out), daemon=True)
    try:
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        steps.reset_graph_counts()
        client.start()
        t0 = time.perf_counter()
        trainer._poll_gui(1, trainer.opt_cfg.iterations)
        poll_s = time.perf_counter() - t0
        client.join(120)
        torch.cuda.synchronize()
        launches = dict(steps.replayed_launch_counts)
        captured = list(steps.captures)
    finally:
        gui.close()
    if client.is_alive() or "error" in out or len(out["replies"]) != len(messages):
        raise AssertionError(f"viewer: client {out.get('error')}, "
                             f"{len(out['replies'])} of {len(messages)} replies")
    served = [(i, r) for i, r in zip(order, out["replies"][:VIEWER_FRAMES])] + [
        (order[-1], out["replies"][-1])]
    if out["replies"][VIEWER_FRAMES][0] is not None:
        raise AssertionError("viewer: the keep-alive got a frame")
    trainer.render_view = render_view
    if len(captured) != 1 or captured[0]["graph"] != "render":
        raise AssertionError(f"viewer: captures {captured}")
    replays = [trainer.render_view(c, fast=True) for c in cams]
    fast_cfg = dataclasses.replace(cfg, fast_fwd=True)
    with torch.no_grad():
        replay_bitwise = [torch.equal(img.view(torch.int32), render(
            trainer.state.params, c, active_sh_degree=sh, bg_color=trainer.background,
            cfg=fast_cfg, alive=trainer.state.aux.alive).image.view(torch.int32))
            for img, c in zip(replays, cams)]
    if not all(replay_bitwise):
        raise AssertionError(f"viewer: replayed frames differ from eager: {replay_bitwise}")
    direct = [np.frombuffer(NetworkGUI.image_to_bytes(img), np.uint8).astype(np.int16)
              for img in replays]
    diffs = [int(np.abs(np.frombuffer(frame, np.uint8).astype(np.int16) - direct[i]).max())
             for i, (frame, _) in served]
    if max(diffs) > 1:
        raise AssertionError(f"viewer: served frames differ from direct renders by {diffs}")
    if not all(torch.equal(a, b) for a, b in zip(steps.state_tensors(trainer.state),
                                                 steps.state_tensors(before))):
        raise AssertionError("viewer: a frame wrote the training state")
    n_frames = len(served)
    per_frame = {k: launches[k] / n_frames for k in FORWARD_KERNELS}
    expected = {"composite_forward": 1, "rank_prefix": 1, "row_engine": (0, 1),
                "row_gather": 2}
    if any(per_frame[k] not in (v if isinstance(v, tuple) else (v,))
           for k, v in expected.items()):
        raise AssertionError(f"viewer: launches per frame {per_frame}")
    first_frame_ms = served[0][1][1] * 1e3
    frame_ms = sorted(dt * 1e3 for _, (_, dt) in served)
    median = frame_ms[len(frame_ms) // 2]
    render_sorted = sorted(render_ms)
    emit({"phase": "viewer", "frames": n_frames, "keep_alives": 1, "width": BENCH_W,
          "height": BENCH_H, "gaussians": int(scene.aux.n_alive()), "sh_degree": sh,
          "tile": f"{cfg.tw}x{cfg.th}", "budgets": [cfg.max_instances, cfg.max_rows],
          "peaks": peaks, "frame_ms_median": median,
          "frame_ms_p90": frame_ms[int(0.9 * (len(frame_ms) - 1))],
          "frame_ms_min": frame_ms[0], "fps": 1e3 / median,
          "render_ms_median": render_sorted[len(render_sorted) // 2],
          "render_share": render_sorted[len(render_sorted) // 2] / median,
          "bytes_per_frame": BENCH_W * BENCH_H * 3, "max_level_diff": max(diffs),
          "launches_per_frame": per_frame, "first_frame_ms": first_frame_ms,
          "capture": captured[0], "replays_equal_eager_bitwise": replay_bitwise,
          "poll_seconds": poll_s,
          "phase_seconds": time.perf_counter() - t_phase})
    del trainer, before


def vgg_macs(height: int, width: int) -> int:
    """Multiply-adds of the LPIPS-vgg trunk on one image: 13 conv3x3
    layers, the resolution halved (floor) after each of the first four
    blocks."""
    from gsjax_torch.image_metrics import _VGG_BLOCKS

    macs, cin = 0, 3
    for b, (cout, n_convs) in enumerate(_VGG_BLOCKS):
        for _ in range(n_convs):
            macs += height * width * cout * cin * 9
            cin = cout
        if b < len(_VGG_BLOCKS) - 1:
            height, width = height // 2, width // 2
    return macs


def lpips_random_weights(rng) -> dict:
    """Random conv and head weights in the spec's layout (the recipe of
    tests/test_lpips.py's random weights)."""
    import numpy as np

    from gsjax_torch.image_metrics import expected_lpips_members

    weights = {}
    for k, shape in expected_lpips_members().items():
        if k.startswith("conv") and k.endswith(".w"):
            weights[k] = rng.normal(0, 0.2 / np.sqrt(shape[1]), shape)
        elif k.startswith("conv"):
            weights[k] = rng.normal(0, 0.1, shape)
        else:
            weights[k] = np.abs(rng.normal(0, 0.05, shape))
    return {k: v.astype(np.float32) for k, v in weights.items()}


def phase_lpips(torch, root):
    """LPIPS-vgg: a seeded random-weights npz written under `root` passes
    check_lpips_weights; lpips on the card equals lpips on the CPU within
    LPIPS_RTOL on a LPIPS_CHECK_SIZE^2 pair; ms per 1080p pair on the card
    (CUDA events) against its bound, the trunk's f32 operations over the
    card's f32 peak. Returns the npz's path."""
    import os

    import numpy as np

    from gsjax_torch import image_metrics
    from gsjax_torch.tools.common import cuda_ms

    t_phase = time.perf_counter()
    rng = np.random.default_rng(LPIPS_SEED)
    path = os.path.join(root, "lpips_vgg.npz")
    np.savez(path, **lpips_random_weights(rng))
    digest = image_metrics.check_lpips_weights(path)
    s = LPIPS_CHECK_SIZE
    x = rng.uniform(0, 1, (2, 3, s, s)).astype(np.float32)
    y = np.clip(x + rng.normal(0, 0.08, x.shape).astype(np.float32), 0, 1)
    cpu = image_metrics.lpips(torch.from_numpy(x), torch.from_numpy(y), weights=path)
    card = image_metrics.lpips(torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda(),
                               weights=path).cpu()
    rel = float(((card - cpu).abs() / cpu.abs()).max())
    if not (bool(torch.isfinite(card).all()) and bool((cpu > 0).all()) and rel <= LPIPS_RTOL):
        raise AssertionError(f"lpips: card {card.tolist()} vs cpu {cpu.tolist()} ({rel})")
    gen = torch.Generator(device="cuda").manual_seed(LPIPS_SEED)
    a = torch.rand((1, 3, BENCH_H, BENCH_W), generator=gen, device="cuda")
    b = torch.clamp(a + 0.05 * torch.randn(a.shape, generator=gen, device="cuda"), 0, 1)
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: image_metrics.lpips(a, b, weights=path), reps=LPIPS_REPS)
    value = float(image_metrics.lpips(a, b, weights=path)[0])
    flops = 2 * 2 * vgg_macs(BENCH_H, BENCH_W)
    bound_ms = flops / F32_FLOP_PER_S * 1e3
    emit({"phase": "lpips", "sha256": digest, "check_size": s, "cpu": cpu.tolist(),
          "card": card.tolist(), "max_rel_err": rel, "rtol": LPIPS_RTOL,
          "width": BENCH_W, "height": BENCH_H, "ms_per_pair": ms, "value_1080p": value,
          "flop_per_pair": flops, "bound_ms": bound_ms, "bound_by": "operations",
          "share_of_bound": bound_ms / ms,
          "peak_gb": torch.cuda.max_memory_allocated() / 2**30, "tf32": False,
          "phase_seconds": time.perf_counter() - t_phase})
    del a, b
    return path


def timed_tool(torch, seconds: dict, name: str, fn):
    """fn()'s result; its seconds (to a synchronize) in seconds[name]."""
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    seconds[name] = time.perf_counter() - t0
    return out


def phase_profilers(torch, params, aux, camera, cfg):
    """Queue item 7's profilers that read torch.profiler
    (gsjax_torch.tools.{trace_step, trace_binning, profile_kernels})
    through their run functions on the bench scene already built, at
    TOOL_ITERS where they take a depth: one `tools` line per measurement.
    trace_step's families must hold the composite kernels, binning,
    gathers, preprocess, SSIM, L1 and Adam, and cover its device ops;
    trace_binning's calls split one by one."""
    from gsjax_torch.config import RasterConfig
    from gsjax_torch.tools import profile_kernels, trace_binning, trace_step

    t_phase = time.perf_counter()
    seconds = {}

    def tool(name, fn):
        return timed_tool(torch, seconds, name, fn)

    step = tool("trace_step", lambda: trace_step.run(params, aux, camera, cfg))
    want = {"composite kernels", "binning", "gathers", "preprocess", "SSIM", "L1", "Adam"}
    if not want <= set(step["by_family_ms"]):
        raise AssertionError(f"trace_step: families {step['by_family_ms']}")
    emit(dict(phase="tools", **step))
    binning = tool("trace_binning", lambda: trace_binning.run(params, aux, camera, cfg))
    if len(binning["per_call"]) != binning["calls"]:
        raise AssertionError(f"trace_binning: {binning['per_call']}")
    emit(dict(phase="tools", **binning))
    pk_cfg = RasterConfig(**profile_kernels.DEFAULTS)
    for row in tool("profile_kernels", lambda: profile_kernels.run(
            params, aux, camera, pk_cfg, iters=TOOL_ITERS, device_reps=TOOL_ITERS)):
        emit(dict(phase="tools", profile_kernels=True, **row))
    emit({"phase": "tools", "seconds": seconds,
          "phase_seconds": time.perf_counter() - t_phase})


def phase_replayed_timing(torch, params, aux, camera, cfg):
    """What times replays of captured graphs: gsjax_torch.bench's line (its
    value the replayed step, the dispatched step beside it), then bench_fps
    and bench_sweep (32x32, 16x16) through their run functions at
    TOOL_ITERS, each replayed and dispatched: one line per measurement."""
    from gsjax_torch import bench
    from gsjax_torch.tools import bench_fps, bench_sweep

    t_phase = time.perf_counter()
    seconds = {}
    line = timed_tool(torch, seconds, "bench", lambda: bench.run(params, aux, camera, cfg))
    emit(dict(phase="bench", **line))
    for row in timed_tool(torch, seconds, "bench_fps",
                          lambda: bench_fps.run(params, aux, iters=TOOL_ITERS)):
        emit(dict(phase="tools", **row))
    configs = bench_sweep.parse_configs(SWEEP_CONFIGS)
    for row in timed_tool(torch, seconds, "bench_sweep", lambda: bench_sweep.run(
            params, aux, camera, configs, iters=TOOL_ITERS, fwd_only=True)):
        emit(dict(phase="tools", **row))
    emit({"phase": "tools", "seconds": seconds,
          "phase_seconds": time.perf_counter() - t_phase})


def bench_trained_line(torch, model):
    """tools.bench_trained on a trained model's newest PLY (CUDA events
    only: it runs after the trainer phase)."""
    import os

    from gsjax_torch.profile_stages import ply_scene
    from gsjax_torch.tools import bench_trained

    t0 = time.perf_counter()
    ply = bench_trained.newest_ply(model)
    params, aux, camera, cfg, sh = ply_scene(ply, TRAINED_ORBIT, BENCH_W, BENCH_H)
    out = bench_trained.run(params, aux, camera, cfg, sh, iters=TOOL_ITERS)
    if not all(math.isfinite(v) and v > 0 for k, v in out.items() if k.endswith("_ms")):
        raise AssertionError(f"bench_trained: {out}")
    emit(dict(phase="tools", ply=os.path.relpath(ply, model), orbit=TRAINED_ORBIT,
              sh_degree=sh, seconds=time.perf_counter() - t0, **out))


# --- the remaining tools: one line each ----------------------------------------

# bench_scan's form: windows of SCAN_WINDOW steps, SCAN_OUTER of them timed.
SCAN_WINDOW = 10
SCAN_OUTER = 2
# sky_run and the quality run cut to keep the phase short; the tools'
# defaults are 4000 and 2000 iterations.
SKY_ITERATIONS = 600
QUALITY_ITERATIONS = 300
# bench_scaling's one-rank run: its own defaults (640x360, 50k Gaussians).
SCALING_ITERS = 5


def quietly(fn):
    """fn()'s result and what it printed."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    return out, buf.getvalue()


def phase_tools_rest_profiled(torch, params, aux, camera, cfg, stage_rows):
    """The remaining tools that read torch.profiler, on the bench scene
    before any long run of replays: bench_scan (the bench step dispatched
    and as replays of its captured graph), probe_gradreduce (the grad
    reduction's pieces on the origin view's binning; row_gather's regroup
    equal to index_select's bit for bit) and scaling_projection (the stage
    table of the stages phase, the N-rate binning and Adam measured now,
    exact slab pair counts at 2, 4 and 8 slabs). One `tools_rest` line
    each."""
    from gsjax_torch.config import RasterConfig
    from gsjax_torch.render.api import depth_sorted_bins
    from gsjax_torch.render.preprocess import preprocess
    from gsjax_torch.tools import bench_scan, probe_gradreduce, scaling_projection

    t0 = time.perf_counter()
    scan = bench_scan.run(params, aux, camera, cfg, SCAN_WINDOW, SCAN_OUTER)
    if not all(math.isfinite(scan[f]["ms_per_step"]) for f in ("dispatched", "scanned")):
        raise AssertionError(f"bench_scan: {scan}")
    emit(dict(phase="tools_rest", seconds=time.perf_counter() - t0, **scan))

    t0 = time.perf_counter()
    with torch.no_grad():
        proj = preprocess(
            xyz=params.xyz, sh=params.get_features(), opacity=params.get_opacity(),
            scaling=params.get_scaling(), rotation=params.rotation, camera=camera,
            active_sh_degree=3, alive=aux.alive)
        _, binning = depth_sorted_bins(proj, camera, cfg)
    gen = torch.Generator(device=params.device).manual_seed(0)
    rows = probe_gradreduce.run(binning, gen)
    grads = torch.randn((binning.sorted_slot.shape[0], 16), generator=gen,
                        device=params.device)
    with torch.no_grad():
        out = {k: fn() for k, fn in probe_gradreduce.pieces(
            grads, binning.sorted_slot, binning.gm_start).items()}
    regroup_equal = torch.equal(out["c. regroup (P,16) index_select"],
                                out["c. regroup (P,16) row_gather kernel"])
    if not regroup_equal or not all(math.isfinite(r["ms"]) for r in rows if "ms" in r):
        raise AssertionError(f"probe_gradreduce: regroups equal {regroup_equal}, {rows}")
    for row in rows:
        emit(dict(phase="tools_rest", **row))
    emit({"phase": "tools_rest", "tool": "probe_gradreduce",
          "regroups_equal_bitwise": regroup_equal, "seconds": time.perf_counter() - t0})
    del out, grads

    t0 = time.perf_counter()
    count_cfg = RasterConfig(tile_w=cfg.tw, tile_h=cfg.th, max_instances=128,
                             max_rows=1 << 20)
    slabs = scaling_projection.slab_pair_counts(proj, BENCH_W, BENCH_H, count_cfg)
    stage_ms = scaling_projection.measure_stages(params, aux, camera, cfg, stage_rows)
    t11, projection = scaling_projection.project(
        stage_ms, slabs, params.capacity, BENCH_W * BENCH_H,
        scaling_projection.NVLINK_GBPS_EACH_WAY)
    if sum(slabs[2]) < int(binning.num_instances):
        raise AssertionError(f"scaling_projection: slabs {slabs} against the view's "
                             f"{int(binning.num_instances)} pairs")
    emit({"phase": "tools_rest", "tool": "scaling_projection", "stage_ms": stage_ms,
          "single_card_step_ms": t11, "slab_pair_counts": slabs,
          "view_pairs": int(binning.num_instances),
          "link_gbps_each_way": scaling_projection.NVLINK_GBPS_EACH_WAY,
          "link_rate_source": "H100 SXM data sheet, not measured",
          "projection": projection, "seconds": time.perf_counter() - t0})


def phase_tools_rest(torch, params, aux, camera, view_counts):
    """The remaining tools that read no profiler, after the mesh phase:
    probe_saturation, probe_tilesize (its 32x32 pairs and rows equal to
    the origin view's binning counts), ckpt_to_ply (an npz checkpoint of
    the bench state to PLY, read back), export_lpips_weights (seeded random
    state dicts in torchvision's and LPIPS's layouts), bench_scaling (a
    world of one NCCL rank), sky_run (cut to SKY_ITERATIONS), the quality
    run on sky_run's scene (cut to QUALITY_ITERATIONS) and
    diagnose_quality on its artifact. One `tools_rest` line each."""
    import os
    import tempfile

    import numpy as np

    from gsjax_torch.image_metrics import expected_lpips_members
    from gsjax_torch.render.preprocess import preprocess
    from gsjax_torch.scene import load_ply_model
    from gsjax_torch.tools import (
        bench_scaling, ckpt_to_ply, diagnose_quality, export_lpips_weights,
        probe_saturation, probe_tilesize, quality_run, sky_run,
    )
    from gsjax_torch.train.checkpoint import save_checkpoint
    from gsjax_torch.train.optimizer import adam_init
    from gsjax_torch.train.step import TrainState

    t0 = time.perf_counter()
    t = probe_saturation.t_map(params, aux, camera).cpu().numpy()
    if t.shape != (BENCH_H, BENCH_W) or not (0.0 <= t.min() and t.max() <= 1.0):
        raise AssertionError(f"probe_saturation: T map {t.shape}, [{t.min()}, {t.max()}]")
    emit({"phase": "tools_rest", "tool": "probe_saturation",
          "tile": f"{probe_saturation.CFG.tw}x{probe_saturation.CFG.th}",
          **probe_saturation.summarize(t, probe_saturation.CFG.tw, probe_saturation.CFG.th),
          "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    with torch.no_grad():
        proj = preprocess(
            xyz=params.xyz, sh=params.get_features(), opacity=params.get_opacity(),
            scaling=params.get_scaling(), rotation=params.rotation, camera=camera,
            active_sh_degree=3, alive=aux.alive)
    rows = probe_tilesize.run(proj, BENCH_W, BENCH_H)
    del proj
    at32 = next(r for r in rows if r["tile"] == "32x32")
    if [at32["pairs"], at32["rows"]] != view_counts:
        raise AssertionError(f"probe_tilesize: 32x32 counts {at32} against the view's "
                             f"{view_counts}")
    for row in rows:
        emit(dict(phase="tools_rest", **row))
    emit({"phase": "tools_rest", "tool": "probe_tilesize", "view_counts": view_counts,
          "seconds": time.perf_counter() - t0})

    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as root:
        t0 = time.perf_counter()
        ckpt = os.path.join(root, "chkpnt1.npz")
        state = TrainState(params=params, opt=adam_init(params), aux=aux,
                           step=torch.ones((), dtype=torch.int32, device=params.device))
        save_checkpoint(ckpt, state, 3, SPATIAL_LR_SCALE)
        del state
        ply, text = quietly(lambda: ckpt_to_ply.main([ckpt, os.path.join(root, "ply")]))
        back, back_aux = load_ply_model(ply, device=params.device)
        n_ply, n_alive = int(back_aux.n_alive()), int(aux.n_alive())
        same_xyz = torch.equal(back.xyz[:n_ply], params.xyz[aux.alive])
        if n_ply != n_alive or not same_xyz:
            raise AssertionError(f"ckpt_to_ply: {n_ply} Gaussians read back of {n_alive}, "
                                 f"xyz equal {same_xyz}")
        emit({"phase": "tools_rest", "tool": "ckpt_to_ply", "gaussians": n_ply,
              "xyz_equal": same_xyz, "ply_bytes": os.path.getsize(ply),
              "printed": text.strip(), "seconds": time.perf_counter() - t0})
        del back, back_aux

        t0 = time.perf_counter()
        shapes = expected_lpips_members()
        gen = torch.Generator().manual_seed(LPIPS_SEED)
        vgg = {}
        for i, idx in enumerate(export_lpips_weights.VGG16_CONV_INDICES):
            vgg[f"features.{idx}.weight"] = torch.randn(shapes[f"conv{i}.w"], generator=gen)
            vgg[f"features.{idx}.bias"] = torch.randn(shapes[f"conv{i}.b"], generator=gen)
        lin = {f"lin{i}.model.1.weight": torch.randn(shapes[f"lin{i}.w"], generator=gen)
               for i in range(export_lpips_weights.N_LIN)}
        torch.save(vgg, os.path.join(root, "vgg16.pth"))
        torch.save(lin, os.path.join(root, "vgg.pth"))
        npz, text = quietly(lambda: export_lpips_weights.main([
            "--vgg", os.path.join(root, "vgg16.pth"), "--lin", os.path.join(root, "vgg.pth"),
            "--out", os.path.join(root, "lpips_vgg.npz")]))
        with np.load(npz) as z:
            equal = all(np.array_equal(z[f"conv{i}.w"], vgg[f"features.{idx}.weight"].numpy())
                        for i, idx in enumerate(export_lpips_weights.VGG16_CONV_INDICES))
        if not equal:
            raise AssertionError("export_lpips_weights: conv weights differ")
        emit({"phase": "tools_rest", "tool": "export_lpips_weights", "inputs": "random",
              "members": len(shapes), "printed": text.strip(),
              "seconds": time.perf_counter() - t0})
        del vgg, lin

        t0 = time.perf_counter()
        scaling, _ = quietly(lambda: bench_scaling.main([
            "--tiles", "1", "--iters", str(SCALING_ITERS)]))
        if not scaling["results"] or not scaling["results"][0]["ms_per_step"] > 0:
            raise AssertionError(f"bench_scaling: {scaling}")
        emit(dict(phase="tools_rest", seconds=time.perf_counter() - t0, **scaling))

        t0 = time.perf_counter()
        sky_root = os.path.join(root, "sky")
        with without_tensorboard():
            sky, _ = quietly(lambda: sky_run.main(["--iterations", str(SKY_ITERATIONS),
                                                   "--root", sky_root]))
        runs = {tag: {k: v for k, v in sky[tag].items() if k != "per_view_psnr"}
                for tag in ("sky_on", "sky_off")}
        if not (sky["shell_survived_prune"] and math.isfinite(sky["delta_test_psnr"])
                and runs["sky_on"]["shell_at_init"]["n_far_shell"] > 0):
            raise AssertionError(f"sky_run: {sky}")
        emit({"phase": "tools_rest", "tool": "sky_run",
              "reduced": {"iterations": [SKY_ITERATIONS, 4000]},
              "scene_seconds": sky["scene_seconds"], "delta_test_psnr": sky["delta_test_psnr"],
              "shell_survived_prune": sky["shell_survived_prune"], **runs,
              "seconds": time.perf_counter() - t0})

        t0 = time.perf_counter()
        artifact = os.path.join(root, "quality_run.json")
        with without_tensorboard():
            _, text = quietly(lambda: quality_run.main([
                "--scene_dir", os.path.join(sky_root, "scene"),
                "--model_dir", os.path.join(sky_root, "quality"), "--out", artifact,
                "--iterations", str(QUALITY_ITERATIONS),
                "--test_iterations", str(QUALITY_ITERATIONS // 2),
                str(QUALITY_ITERATIONS)]))
        with open(artifact) as f:
            art = json.load(f)
        _, diagnosis = quietly(lambda: diagnose_quality.main(artifact))
        lines = diagnosis.splitlines()
        if art["crashed"] or len(art["test_psnr_curve"]) != 2 or len(lines) < 10:
            raise AssertionError(f"quality_run / diagnose_quality: {art}, {diagnosis}")
        emit({"phase": "tools_rest", "tool": "diagnose_quality",
              "quality_run": json.loads(text.strip().splitlines()[-1]),
              "reduced": {"iterations": [QUALITY_ITERATIONS, 2000],
                          "scene": "sky_run's (300 px, 48 + 8 views)"},
              "artifact_keys": sorted(art), "diagnosis": lines,
              "seconds": time.perf_counter() - t0})


def checkpoints_equal(a: str, b: str) -> bool:
    """Every array of two npz checkpoints bit for bit (the host state's
    pickles included)."""
    import numpy as np

    with np.load(a) as za, np.load(b) as zb:
        return sorted(za.files) == sorted(zb.files) and all(
            za[k].dtype == zb[k].dtype and np.array_equal(za[k], zb[k]) for k in za.files)


@contextlib.contextmanager
def without_tensorboard():
    """torch.utils.tensorboard made unimportable, so the trainer writes no
    report; stdout restored after (the train CLI's --quiet replaces it)."""
    saved, stdout = sys.modules.get("torch.utils.tensorboard"), sys.stdout
    sys.modules["torch.utils.tensorboard"] = None
    try:
        yield
    finally:
        sys.stdout = stdout
        if saved is None:
            del sys.modules["torch.utils.tensorboard"]
        else:
            sys.modules["torch.utils.tensorboard"] = saved


def eval_timing(torch, trainer) -> dict:
    """The held-out evaluation of a trained Trainer's state on every view
    of its test and train banks: through Trainer._eval_bank as replays of
    its captured evaluation (render/graph.py EvalGraph) and eagerly (the
    same calls with graphs off), ms per view by the host clock around a
    call that ends in its one read-back, after a warm call; the two
    results bit for bit."""
    from gsjax_torch.render import graph

    banks = [b for b in (*trainer.scene.get_test_banks(), *trainer.banks) if b.count]

    def evaluate():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = [trainer._eval_bank(b, list(range(b.count))) for b in banks]
        return out, (time.perf_counter() - t0) * 1e3

    n_views = sum(b.count for b in banks)
    evaluate()
    graphed, ms = evaluate()
    uses_graphs = graph.uses_graphs
    graph.uses_graphs = lambda device: False
    try:
        evaluate()
        eager, eager_ms = evaluate()
    finally:
        graph.uses_graphs = uses_graphs
    if graphed != eager:
        raise AssertionError(f"trainer: the replayed evaluation {graphed} differs from "
                             f"the eager one {eager}")
    return {"views": n_views, "ms_per_view": ms / n_views,
            "ms_per_view_dispatched": eager_ms / n_views, "replays_equal_eager": True}


def profile_dir_trace(kernels, trainer) -> dict:
    """The trainer's --profile_dir session: the kernel events of the Chrome
    trace it exported against the launches it recorded for the windows the
    session covered, kernel by kernel (tools/common.check_whole); all six
    main kernels must be in it."""
    from gsjax_torch.tools import trace
    from gsjax_torch.tools.common import check_whole, kernel_events

    rec = next(e for e in trainer.events if "profile" in e)
    names = trace.chrome_trace_kernels(rec["trace"])
    check_whole(names, rec["launches"], "the --profile_dir trace")
    missing = [k for k in kernels.KERNEL_NAMES if rec["launches"][k] == 0]
    if missing:
        raise AssertionError(f"trainer: the --profile_dir trace holds no {missing}")
    seen = kernel_events(names)
    return {"iterations": rec["profile"], "kernel_events": len(names),
            "main_kernels": {k: seen[k] for k in kernels.KERNEL_NAMES}}


def phase_after_trainer(torch, kernels, params, aux, camera, cfg):
    """After the trainer phase, in the same process: one window of
    GRAPH_STEPS replays of the bench step, captured anew, in one whole
    profiler session; every main kernel's events must be exactly the
    capture's launches times the replays (replay_launches_seen)."""
    from gsjax_torch.tools.common import replayed_train_steps
    from gsjax_torch.train import step as steps

    window = replayed_train_steps(params, aux, camera, cfg, GRAPH_STEPS)
    window()
    torch.cuda.synchronize()
    seen = replay_launches_seen(torch, kernels, steps, window, GRAPH_STEPS, "after_trainer")
    emit({"phase": "after_trainer", "steps": GRAPH_STEPS,
          "capture_launches": steps.captures[-1]["launches"],
          "profiler_launches_per_window": seen})
    steps.drop_step_graphs()


def phase_trainer(torch, kernels, render, params, resume_bitwise, lpips_weights):
    """The port's CLIs on a dataset on disk: a COLMAP model of the bench
    scene (write_colmap_scene) trained by `python -m gsjax_torch.cli.train`
    (through its main) with --eval for TRAINER_ITERATIONS steps: densify
    from 100 every 100, an opacity reset at 200, a test evaluation at the
    end, checkpoints at 200 and at the end; then cli.render of the test
    view and cli.metrics with GSJAX_LPIPS_WEIGHTS naming `lpips_weights`
    (results.json: a finite LPIPS). Then a second run resumed from the
    checkpoint at 200, whose checkpoint at the end must equal the straight
    run's bit for bit when `resume_bitwise` (the eager step reproduces bit
    for bit on this card; the graph phase says). Both runs serve the viewer
    on a free port (--port 0), and run without TensorBoard (its
    1080p report costs seconds; tests/test_torch_cli.py drives the
    writer). Counts set to 0 just before the straight run and read after
    metrics: every main-path kernel launched; the replays' launches are
    the captures' counts times the replays. The straight run writes
    gsjax's --profile_dir trace of steps 100-110: its kernel events must
    equal, kernel by kernel, the launches the trainer recorded for the
    windows the session covered, and hold all six main kernels. Last,
    tools.bench_trained on the straight run's PLY."""
    import json
    import os
    import tempfile

    from gsjax_torch.cli import metrics as metrics_cli
    from gsjax_torch.cli import render as render_cli
    from gsjax_torch.cli import train as train_cli
    from gsjax_torch.synthetic import orbit_camera
    from gsjax_torch.train import step as steps

    t_phase = time.perf_counter()
    dev = params.device
    line = {"phase": "trainer", "gaussians": BENCH_N, "views": len(SCENE_ANGLES),
            "width": BENCH_W, "height": BENCH_H, "iterations": TRAINER_ITERATIONS}
    seconds = {}
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as root:
        data = os.path.join(root, "data")
        views = [orbit_camera(a, width=BENCH_W, height=BENCH_H, device=dev)
                 for a in SCENE_ANGLES]
        _, seconds["write_dataset"] = timed(
            torch, lambda: write_colmap_scene(torch, data, params, views, render))
        last = TRAINER_ITERATIONS
        argv = ["-s", data, "-r", "1", "--eval", "--quiet",
                "--iterations", str(last), "--densify_from_iter", "100",
                "--densification_interval", "100", "--opacity_reset_interval", "200",
                "--test_iterations", str(last), "--save_iterations", str(last),
                "--checkpoint_iterations", "200", str(last), "--port", "0"]
        straight, resumed = os.path.join(root, "straight"), os.path.join(root, "resumed")
        profile_dir = os.path.join(straight, "profile")
        steps.drop_step_graphs()
        steps.reset_graph_counts()
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        with without_tensorboard():
            trainer, seconds["train"] = timed(torch, lambda: train_cli.main(
                argv + ["-m", straight, "--profile_dir", profile_dir]))
            _, seconds["render"] = timed(torch, lambda: render_cli.main(
                ["-m", straight, "--iteration", str(last), "--skip_train", "--quiet"]))
            saved_env = os.environ.get("GSJAX_LPIPS_WEIGHTS")
            os.environ["GSJAX_LPIPS_WEIGHTS"] = lpips_weights
            try:
                _, seconds["metrics"] = timed(
                    torch, lambda: metrics_cli.main(["-m", straight]))
            finally:
                if saved_env is None:
                    del os.environ["GSJAX_LPIPS_WEIGHTS"]
                else:
                    os.environ["GSJAX_LPIPS_WEIGHTS"] = saved_env
        torch.cuda.synchronize()
        launches = steps.executed_launches()
        line["replayed_launches"] = dict(steps.replayed_launch_counts)
        line["captures"] = list(steps.captures)
        missing = [k for k in kernels.KERNEL_NAMES if launches[k] == 0]
        if missing:
            raise AssertionError(f"trainer: kernels not launched: {missing}")
        line["launches"] = launches
        events = trainer.events
        line["windows"] = [[e["window"], e["steps"], e["ms"]] for e in events if "window" in e]
        line["densify"] = [e for e in events if "densify" in e]
        line["budget_events"] = [e for e in events if "budgets" in e]
        line["evals"] = [e for e in events if "eval" in e]
        line["host_work"] = [e for e in events if "host" in e]
        line["tensorboard"] = trainer.tb is not None
        line["viewer_listening"] = trainer.gui is not None
        line["final"] = {"step": int(trainer.state.step), "alive": trainer.n_alive(),
                         "capacity": trainer.state.params.capacity,
                         "budgets": [trainer.raster_cfg.max_instances,
                                     trainer.raster_cfg.max_rows]}
        if line["final"]["step"] != last or not line["evals"]:
            raise AssertionError(f"trainer: {line['final']}, evals {line['evals']}")
        with open(os.path.join(straight, "results.json")) as f:
            results = json.load(f)[f"ours_{last}"]
        line["results"] = results
        if not (0.0 < results["SSIM"] <= 1.0 and math.isfinite(results["PSNR"])
                and results["LPIPS"] is not None and math.isfinite(results["LPIPS"])):
            raise AssertionError(f"trainer: results.json {results}")
        line["eval"] = eval_timing(torch, trainer)
        line["profile_dir_trace"] = profile_dir_trace(kernels, trainer)
        del trainer

        with without_tensorboard():
            again, seconds["resumed_train"] = timed(torch, lambda: train_cli.main(
                argv + ["-m", resumed, "--start_checkpoint",
                        os.path.join(straight, "chkpnt200.npz")]))
        line["resumed_windows"] = [[e["window"], e["steps"], e["ms"]]
                                   for e in again.events if "window" in e]
        del again
        equal = checkpoints_equal(os.path.join(straight, f"chkpnt{last}.npz"),
                                  os.path.join(resumed, f"chkpnt{last}.npz"))
        line["resume_equals_straight_bitwise"] = equal
        if resume_bitwise and not equal:
            raise AssertionError("trainer: the resumed run's checkpoint differs from "
                                 "the straight run's")
        steps.drop_step_graphs()
        line["seconds"] = seconds
        line["phase_seconds"] = time.perf_counter() - t_phase
        emit(line)
        bench_trained_line(torch, straight)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from gsjax_torch.config import RasterConfig
    from gsjax_torch.render import kernels
    from gsjax_torch.render.api import render, render_oracle
    from gsjax_torch.render.graph import render_replayed
    from gsjax_torch.synthetic import (
        look_at_origin_camera, orbit_camera, random_scene,
    )
    from gsjax_torch.tools import kernels as tool_kernels
    from gsjax_torch.tools.common import (
        cuda_ms, device_ms, instance_stream, profile_table, with_refused,
    )
    from gsjax_torch.tools.probe_prims import gather_bytes

    dev = torch.device("cuda")
    smi = phase_device()
    phase_build(kernels)

    errs = {k: 0.0 for k in kernels.KERNEL_NAMES}
    mid_scene_checks(torch, kernels, render, RasterConfig, random_scene,
                     look_at_origin_camera, dev, errs)
    rank_form_check(torch, kernels, render, RasterConfig, random_scene,
                    look_at_origin_camera, dev, errs)
    phase_oracle(torch, render, render_oracle, RasterConfig, random_scene,
                 look_at_origin_camera, dev)

    # --- main path at full width -------------------------------------------
    t0 = time.perf_counter()
    params, aux = random_scene(
        BENCH_N, capacity=BENCH_N, sh_degree=3, seed=0, spread=2.5,
        scale_range=(0.004, 0.03), device=dev,
    )
    scene_s = time.perf_counter() - t0
    views = {"origin": look_at_origin_camera(BENCH_W, BENCH_H, device=dev)}
    for a in ORBIT_ANGLES:
        views[f"orbit{a:+.2f}"] = orbit_camera(a, width=BENCH_W, height=BENCH_H, device=dev)
    bg = torch.zeros(3, device=dev)
    cfgs = {fast: RasterConfig(tile_w=32, tile_h=32, fast_fwd=fast, **BENCH_BUDGETS)
            for fast in (False, True)}

    def draw(view, fast):
        return render(params, views[view], active_sh_degree=3, bg_color=bg,
                      cfg=cfgs[fast], alive=aux.alive)

    def draw_replayed(view, fast):
        return render_replayed(params, views[view], active_sh_degree=3, bg_color=bg,
                               cfg=cfgs[fast], alive=aux.alive)

    results = {}
    with torch.no_grad():
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        tool_kernels.reset_launch_counts()
        with Recorder(kernels) as rec:
            for view in views:
                for fast in (False, True):
                    results[(view, fast)] = draw(view, fast)
                    if view == "origin" and not fast:
                        origin_calls = dict(rec.calls)
        torch.cuda.synchronize()
        launches = dict(kernels.launch_counts)
        main_launches = {"views": dict(tool_kernels.launch_counts)}
    missing = [k for k in FORWARD_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the render path: {missing}")
    for view in views:
        exact, fast = results[(view, False)], results[(view, True)]
        n_inst, n_rows = int(exact.num_instances), int(exact.num_rows)
        if n_inst > BENCH_BUDGETS["max_instances"] or n_rows > BENCH_BUDGETS["max_rows"]:
            raise AssertionError(f"{view}: budget overflow ({n_inst}, {n_rows})")
        for out in (exact, fast):
            if out.image.shape != (3, BENCH_H, BENCH_W) or not bool(torch.isfinite(out.image).all()):
                raise AssertionError(f"{view}: bad image")
        fast_gap = float((exact.image - fast.image).abs().max())
        if not fast_gap <= 4e-3:
            raise AssertionError(f"{view}: fast vs exact {fast_gap}")
        line = {"phase": "main", "view": view, "num_instances": n_inst,
                "num_rows": n_rows, "fast_vs_exact": fast_gap,
                "visible": int((exact.radii > 0).sum()),
                "mean_rgb": [float(v) for v in exact.image.mean((1, 2))]}
        if view == "origin":
            line["reference_instances"] = BENCH_REFERENCE_INSTANCES
        emit(line)
    emit({"phase": "main", "scene_seconds": scene_s, "launches": launches})

    with torch.no_grad():
        # --- device time by kernel over one render (dispatched) -------------
        for fast in (False, True):
            origin_ms = cuda_ms(lambda: draw("origin", fast), reps=5)
            emit(dict(phase="profile", view="origin", fast_fwd=fast,
                      **profile_table(lambda: draw("origin", fast), origin_ms)))
        # --- per-view time, dispatched and as replays of the captured render -
        for fast in (False, True):
            emit(views_line(torch, draw, draw_replayed, results, views, fast))
    emit(render_set_growth(torch, render, params, aux, views))

    # --- the training step at full width -----------------------------------
    gt = results[("origin", False)].image
    origin_counts = [int(results[("origin", False)].num_instances),
                     int(results[("origin", False)].num_rows)]
    bank = view_bank(torch, views.values(), [results[(v, False)].image for v in views])
    del results
    tool_kernels.reset_launch_counts()
    train_calls, train_launches, state = phase_train(
        torch, kernels, random_scene, views["origin"], gt, dev)
    # --- a window of steps as replays of the captured step ---------------------
    graph_line = phase_graph(torch, kernels, state, bank, cfgs[False])
    main_launches["step"] = dict(tool_kernels.launch_counts)
    if any(main_launches["views"].values()) or any(main_launches["step"].values()):
        raise AssertionError(f"a tools kernel ran on the main path: {main_launches}")

    # --- densification and the scene path at full width ------------------------
    phase_densify(torch, kernels, render, state, views["origin"], gt)
    del state
    scene, scene_cfg = phase_scene(torch, kernels, render, params)

    # --- the viewer's serving path on the scene phase's Scene -----------------
    phase_viewer(torch, kernels, render, scene, scene_cfg, views)

    # --- the cull: warp counts, the twins, main against twin in turns ---------
    twin_ms = phase_cull(torch, kernels, tool_kernels, origin_calls, train_calls)

    # --- the profiling tools' path, the bench line and the stage profile ------
    mid_params, mid_aux = random_scene(20_000, seed=1, spread=1.5, device=dev)
    stream_mid = instance_stream(
        mid_params, look_at_origin_camera(320, 240, device=dev),
        RasterConfig(tile_size=32, max_instances=1 << 18, max_rows=1 << 16),
        mid_aux.alive)
    stream_bench = instance_stream(params, views["origin"], cfgs[False], aux.alive)
    tools = phase_tools(torch, tool_kernels, stream_mid, stream_bench)
    del stream_mid, mid_params, mid_aux

    from gsjax_torch import profile_stages

    stages = profile_stages.profile(
        profile_stages.Stages(params, aux, views["origin"], cfgs[False]))
    emit(dict(phase="stages", **stages))

    # --- LPIPS, and queue item 7's profilers ---------------------------------
    import os
    import tempfile

    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    lpips_dir = tempfile.TemporaryDirectory(dir=build)
    lpips_weights = phase_lpips(torch, lpips_dir.name)
    phase_profilers(torch, params, aux, views["origin"], cfgs[False])

    # --- each kernel at the main path's shapes -------------------------------
    train_errs = check_backward_kernels(
        kernels, train_calls, dict.fromkeys(kernels.KERNEL_NAMES, 0.0), "main path")
    entries = []
    for name in kernels.KERNEL_NAMES:
        calls = origin_calls if name in FORWARD_KERNELS else train_calls
        args, kw = calls[name]
        fn = getattr(kernels, name)
        plain = getattr(kernels, f"{name}_plain")
        # The kernel against its plain version on these very arguments:
        # integers exactly, the composite forward within 2e-3, the backward
        # kernels as in the kernels phase.
        if name in BACKWARD_KERNELS:
            main_err, main_rel = train_errs[name]
            extra = {"max_tolerance_measure_err": main_rel}
        else:
            tol = 2e-3 if name == "composite_forward" else 0.0
            with torch.no_grad():
                main_err = max_err(fn(*args, **kw), plain(*args, **kw))
            if not main_err <= tol:
                raise AssertionError(f"main path: {name} differs from plain by "
                                     f"{main_err} > {tol}")
            extra = {}
        with torch.no_grad():
            ms = device_ms(lambda: fn(*args, **kw), DEVICE_KERNELS[name])
            event_ms = cuda_ms(lambda: fn(*args, **kw), reps=20, warmup=2)
            plain_ms = cuda_ms(lambda: plain(*args, **kw), reps=2)
        library_ms = None
        if name in ("composite_forward", "composite_backward"):
            inst, tile_start = args[:2]
            n_inst = int(tile_start[-1])
            pix = kw["tile_w"] * kw["tile_h"]
            pairs, live, _ = composite_pairs(
                torch, inst, tile_start, n_tiles=kw["n_tiles"], tiles_x=kw["tiles_x"],
                tile_w=kw["tile_w"], tile_h=kw["tile_h"],
            )
            if name == "composite_forward":
                # Nine fields of each live row read, color + T written.
                nbytes = n_inst * 9 * 4 + tile_start.numel() * 4 + kw["n_tiles"] * pix * 16
                flops = pairs * COMPOSITE_FLOP_PER_PAIR
            else:
                # Live rows read, the whole (P, 16) gradient stream written,
                # the (T, PIX, 4) cotangent read.
                nbytes = (n_inst * 64 + inst.shape[0] * 64 + args[2].numel() * 4
                          + tile_start.numel() * 4)
                flops = pairs * COMPOSITE_FLOP_PER_PAIR + live * BACKWARD_FLOP_PER_LIVE_PAIR
            extra.update(pairs_evaluated=pairs, pairs_live=live)
        elif name == "row_engine":
            table, total_rows = args
            rows_used = min(int(total_rows), kw["budget"])
            with_rows = int((table[1] > table[0]).sum())
            # rstart column whole, 11 more columns of Gaussians with rows,
            # istart/delta/u written.
            nbytes = table.shape[1] * 4 + with_rows * 11 * 4 + 3 * kw["budget"] * 4
            flops = rows_used * 60
            extra["rows"] = rows_used
        elif name == "rank_prefix":
            start, _ = args[:2]
            nbytes = start.numel() * 4 * 2 + kw["budget"] * 4
            flops = kw["budget"] * 4
        elif name == "row_gather":
            src, idx = args
            nbytes = gather_bytes(idx, src.shape[1])
            flops = 0
            extra["shape"] = f"({src.shape[0]},{src.shape[1]})@{idx.shape[0]}"
            # The yardstick: the library's gather at the same indices, and
            # at the int64 copy of them the render path took before.
            library_ms = cuda_ms(lambda: torch.index_select(src, 0, idx), reps=20,
                                 warmup=2)
            extra["library_int64_ms"] = cuda_ms(
                lambda: torch.index_select(src, 0, idx.long()), reps=20, warmup=2)
        else:
            vals, gm_start = args
            lo, hi = int(gm_start[0]), int(gm_start[-1])
            n_owners = gm_start.numel() - 1
            # Each run's rows read, each owner's row written, the bounds read.
            nbytes = (hi - lo) * 64 + n_owners * 64 + gm_start.numel() * 4
            flops = (hi - lo) * 16
            extra["rows_summed"] = hi - lo
            # The yardstick: one PyTorch call computing the same sums.
            lengths = gm_start.diff()
            lib = torch.segment_reduce(vals[lo:hi], "sum", lengths=lengths)
            extra["library_max_abs_err"] = float(
                (lib - kernels.segment_sum_plain(vals, gm_start)).abs().max())
            library_ms = cuda_ms(
                lambda: torch.segment_reduce(vals[lo:hi], "sum", lengths=lengths),
                reps=20, warmup=2)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / F32_FLOP_PER_S * 1e3
        extra.update(ops_per_call(lambda: fn(*args, **kw), DEVICE_KERNELS[name]))
        entries.append(with_refused(dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name], launches=train_launches[name],
            view_run_launches=launches[name], max_abs_err=main_err,
            mid_scene_max_abs_err=errs[name], ms=ms, plain_ms=plain_ms,
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=library_ms, plain_source=PLAIN_SOURCE[name],
            event_ms=event_ms, bytes=nbytes, flops=flops, **extra,
        )))
    fwd_entry = next(e for e in entries if e["name"] == "composite_forward")
    entries += tool_entries(torch, tool_kernels, stream_bench, *tools, fwd_entry,
                            main_launches)
    entries += twin_entries(torch, tool_kernels, entries, origin_calls, train_calls,
                            tools[1], tools[2], twin_ms, main_launches)
    if not all(math.isfinite(e["ms"]) for e in entries):
        raise AssertionError("kernel timing failed")
    for e in entries:
        # Every `ms` above is a device_ms of one session held whole.
        e["ms_source"] = "profiler"

    # --- the remaining tools that profile: bench_scan, probe_gradreduce,
    # scaling_projection (after the kernels line's measurements) -------------
    phase_tools_rest_profiled(torch, params, aux, views["origin"], cfgs[False],
                              stages["stages"])
    # --- the bench line and the timing tools, as replays of captured graphs --
    phase_replayed_timing(torch, params, aux, views["origin"], cfgs[False])

    # --- the device mesh on this card: a 1x1 mesh over NCCL --------------------
    # It times by CUDA events and the host clock only.
    mesh_launches, mesh_errs, mesh_graph_launches = phase_mesh(
        torch, kernels, render, params, aux, views["origin"], views["orbit+0.15"],
        bank, scene, scene_cfg)
    del scene, bank
    for e in entries:
        if e["name"] in mesh_launches:
            e["mesh_launches_per_step"] = mesh_launches[e["name"]]
            e["mesh_slab_max_abs_err"] = mesh_errs[e["name"]]
            e["mesh_graph_window_launches"] = mesh_graph_launches[e["name"]]

    # --- the remaining tools that read no profiler -----------------------------
    phase_tools_rest(torch, params, aux, views["origin"], origin_counts)

    # --- the training CLI, render and metrics on a dataset on disk ------------
    # Its --profile_dir trace and a profiled window after it are held to the
    # port's launch counts, as every profiler session is (whole_session):
    # no measurement depends on running before it.
    phase_trainer(torch, kernels, render, params,
                  graph_line["eager_bitwise_reproducible"], lpips_weights)
    phase_after_trainer(torch, kernels, params, aux, views["origin"], cfgs[False])
    lpips_dir.cleanup()
    emit({"kernels": entries})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
