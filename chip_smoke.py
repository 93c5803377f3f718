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
           sum of magnitudes); row_engine and rank_prefix bit for bit on
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
  views    per-view render time (CUDA events and host clock)
  profile  device time by kernel over one render (torch.profiler)
  tiles    the composite kernels at 64x32 and 64x64 tiles (up to four
           pixels per thread) against their plain versions on the mid
           scene (also in the oracle phase, at 64x32); in every mid-scene
           case the culled composite kernels equal their twins without the
           cull bit for bit (the backward up to the sign of a zero)
  train    train_step() on the bench scene against the exact render of
           that scene, from a perturbed copy: 3 warm-up and 10 timed steps
           (loss per step, ms per step, pixels/s, host ms); all five
           kernels' launch counts over those steps; a profile of one step
  cull     at the bench origin view: for each warp shape (32x1, 16x2, 8x4)
           the (instance, warp) pairs the exact walk visits, those the
           cull keeps and those with a live pixel; the culled composite
           kernels against their twins without the cull, bit for bit, on
           the view's render and training step; each timed against its
           twin in turns (twin, main, main, twin), profiler device time
  tools    the profiling tools' kernels (gsjax_torch/tools/kernels.py:
           the four probes and the two twins) against their plain
           versions on the mid scene; then the tools' own path,
           gsjax_torch.tools.{ablate_kernels, probe_outpath, probe_prims},
           on the bench origin view (one line per measurement), with the
           tools kernels' launch counts over it;
           then each kernel against its plain version at that view's own
           arguments (row_gather: the instance gather's (N,16) rows at P)
  bench    gsjax_torch.bench's JSON line on the bench scene
  stages   gsjax_torch.profile_stages' table on the bench scene
Then the `kernels` line: for the forward kernels at the origin view's
render, for the backward kernels at one training step, for the tools'
kernels at the origin view's instance stream (the twins at the main
kernels' arguments, their times from the cull phase), each kernel's
launches (over the training run; the tools' over their own path, with "path": "tools"
and 0 launches per step and per view), its error against its plain
version on those very arguments (max_abs_err; the kernels and tools
phases' errors in mid_scene_max_abs_err), device time from the profiler,
time by CUDA events with the host's launch work included, plain time,
bound, the time of one PyTorch call computing the same function where
there is one, and the kernel's CUDA launches and the other device
operations of one wrapper call (torch.profiler). Every number in the line
is measured in the run, the bound computed from its inputs. Then the card
line and the result line.
Imports no JAX.
"""

from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time

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
    "row_gather": "gsjax_torch/tools/kernels.py",
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
# Names of each wrapper's CUDA kernels, as the profiler reports them.
DEVICE_KERNELS = {
    "composite_forward": "composite_forward_kernel",
    "row_engine": "row_engine_",
    "rank_prefix": "rank_prefix_kernel",
    "composite_backward": "composite_backward_kernel",
    "segment_sum": "segment_sum_kernel",
    "row_gather": "row_gather_kernel",
    "outpath": "outpath_kernel",
    "blockout": "blockout_kernel",
    "variant": "variant_",
    "composite_forward_nocull": "nocull_forward_kernel",
    "composite_backward_nocull": "nocull_backward_kernel",
}
# The warp shapes the cull phase counts, by warp width (32x1, 16x2, 8x4).
WARP_WIDTHS = (32, 16, 8)
BACKWARD_KERNELS = ("composite_backward", "segment_sum")
FORWARD_KERNELS = ("composite_forward", "row_engine", "rank_prefix")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


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
    instance stream (tools/common.InstanceStream): row_gather on the
    instance gather's own (N,16) rows at P with int32 and int64 indices,
    exactly; outpath and blockout (both variants, both semantics) within
    the forward's 2e-3, the notrans block sum within rtol 1e-5 of its 4 PIX
    summed values (the rest of the block exactly 0); each ablation variant
    as tests/test_torch_tools.py holds it (dma_only rtol 1e-6, the walks
    2e-3 per chunk summed, the backward variants 5e-3 of the largest |d_mx|
    of their cotangent); the twins without the cull as the main kernels
    (2e-3; 5e-3 of each gradient column's largest, on the backward
    variants' cotangent). Returns {kernel: max abs error} and the variants'
    errors."""
    from gsjax_torch.render import kernels
    from gsjax_torch.render.common import N_FIELDS, ROWS

    inst, ts, geo = stream.inst, stream.tile_start, stream.geometry
    pix = geo["tile_w"] * geo["tile_h"]
    errs, variant_errs = {}, {}
    with torch.no_grad():
        src = torch.nn.functional.pad(stream.fields, (0, ROWS - N_FIELDS, 0, 1))
        for idx in (stream.binning.sorted_owner, stream.binning.sorted_owner.long()):
            if not torch.equal(tool_kernels.row_gather(src, idx),
                               tool_kernels.row_gather_plain(src, idx)):
                raise AssertionError(f"{where}: row_gather differs from plain")
        errs["row_gather"] = 0.0

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


def phase_tools(torch, tool_kernels, stream_mid, stream_bench):
    """The tools' kernels against their plain versions on the mid scene;
    then the tools' own path on the bench origin view with the four
    kernels' launch counts set to 0 just before and read just after; then
    the kernels against their plain versions at that view's arguments.
    Returns the tools' measurement rows, the launches and both errors."""
    from gsjax_torch.tools import ablate_kernels, probe_outpath, probe_prims

    mid_errs, mid_variants = check_tool_kernels(torch, tool_kernels, stream_mid,
                                                "mid scene")
    emit({"phase": "tools", "case": "mid_scene", "max_abs_err": mid_errs,
          "variants": mid_variants})
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
    emit({"phase": "tools", "case": "bench_view", "max_abs_err": errs,
          "variants": variant_errs})
    return rows, launches, mid_errs, errs, variant_errs


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
                 variant_errs, fwd_entry, main_launches):
    """The `kernels` line's entries of the tools' four probe kernels at the
    bench origin view: device and event ms from the tools' own run (`rows`),
    the plain versions timed here, bounds from this view's data (the
    composite's pairs are the forward entry's, counted on the same
    stream)."""
    from gsjax_torch.render.common import N_FIELDS, ROWS
    from gsjax_torch.tools.common import cuda_ms, device_ms
    from gsjax_torch.tools.probe_prims import gather_bytes

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
        out.append(dict(
            name=name, route="cuda", source=SOURCES[name], replaces=REPLACES[name],
            launches=launches[name], path="tools",
            step_launches=main_launches["step"][name],
            view_run_launches=main_launches["views"][name],
            max_abs_err=errs[name], mid_scene_max_abs_err=mid_errs[name], ms=ms,
            plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=library_ms, plain_source=PLAIN_SOURCE[name],
            event_ms=event_ms, bytes=nbytes, flops=flops, **extra))

    with torch.no_grad():
        src = torch.nn.functional.pad(stream.fields, (0, ROWS - N_FIELDS, 0, 1))
        idx = stream.binning.sorted_owner
        n_rows = idx.shape[0]
        gather = lambda: tool_kernels.row_gather(src, idx)  # noqa: E731
        entry("row_gather", device_ms(gather, DEVICE_KERNELS["row_gather"]),
              cuda_ms(gather, reps=20, warmup=2),
              lambda: tool_kernels.row_gather_plain(src, idx),
              gather_bytes(idx, ROWS), 0,
              library_ms=cuda_ms(lambda: torch.index_select(src, 0, idx), reps=20,
                                 warmup=2),
              library_int64_ms=cuda_ms(
                  lambda: torch.index_select(src, 0, idx.long()), reps=20, warmup=2),
              call=gather, shape=f"({src.shape[0]},{ROWS})@{n_rows}")
    outpath = {r["variant"]: r for r in rows if r["tool"] == "probe_outpath"}
    entry("outpath", outpath["ship"]["ms"], outpath["ship"]["event_ms"],
          lambda: tool_kernels.outpath_plain(inst, ts, "ship", **geo),
          n_live * 9 * 4 + ts.numel() * 4 + n_tiles * 8 * pix * 4,
          pairs * COMPOSITE_FLOP_PER_PAIR, variant="ship",
          call=lambda: tool_kernels.outpath(inst, ts, "ship", **geo),
          notrans_ms=outpath["notrans"]["ms"])
    entry("blockout", timed["blockout"]["ms"], timed["blockout"]["event_ms"],
          lambda: tool_kernels.blockout_plain(inst, ts, **geo),
          n_live * 9 * 4 + ts.numel() * 4 + n_tiles * pix * 16,
          pairs * COMPOSITE_FLOP_PER_PAIR, semantics="arbitrary",
          call=lambda: tool_kernels.blockout(inst, ts, **geo),
          parallel_ms=timed["blockout_parallel"]["ms"])
    entry("variant", timed["bwd_nowrite"]["ms"], timed["bwd_nowrite"]["event_ms"],
          lambda: tool_kernels.variant_plain(inst, ts, "bwd_nowrite", **geo),
          n_live * 64 + n_tiles * pix * 16 + ts.numel() * 4 + n_tiles * 4,
          pairs * COMPOSITE_FLOP_PER_PAIR + live * BACKWARD_FLOP_PER_LIVE_PAIR,
          variant="bwd_nowrite",
          call=lambda: tool_kernels.variant(inst, ts, "bwd_nowrite", **geo),
          variants={v: dict(ms=timed[v]["ms"], event_ms=timed[v]["event_ms"],
                            max_abs_err=variant_errs[v]) for v in tool_kernels.VARIANTS},
          composite_forward_ms=timed["composite_forward"]["ms"],
          composite_backward_ms=timed["composite_backward"]["ms"])
    return out


def twin_entries(torch, tool_kernels, entries, origin_calls, train_calls,
                 launches, mid_errs, twin_ms, main_launches):
    """The `kernels` line's entries of the two twins without the cull, at
    the main kernels' own arguments (the forward's at the origin view's
    render, the backward's at one training step): device ms from the cull
    phase's turns, their errors against the plain versions, and the main
    kernels' bounds (the same work)."""
    from gsjax_torch.tools.common import cuda_ms

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
        out.append(dict(
            name=twin_name, route="cuda", source=SOURCES[twin_name],
            replaces=REPLACES[twin_name], launches=launches[twin_name], path="tools",
            step_launches=main_launches["step"][twin_name],
            view_run_launches=main_launches["views"][twin_name], max_abs_err=err,
            mid_scene_max_abs_err=mid_errs[twin_name], ms=twin_ms[twin_name],
            plain_ms=plain_ms, bound_ms=main["bound_ms"], bound_by=main["bound_by"],
            library_ms=None, plain_source=PLAIN_SOURCE[twin_name], event_ms=event_ms,
            bytes=main["bytes"], flops=main["flops"], main_ms=main["ms"],
            **ops_per_call(lambda: twin(*args, **kw), DEVICE_KERNELS[twin_name])))
    return out


def phase_train(torch, kernels, random_scene, camera, gt, dev):
    """train_step() on the bench scene at full width: the ground truth is
    the exact render of the scene from `camera`; training starts from the
    same scene with features_dc and the opacity logits perturbed by
    numpy-seeded noise (seed 1, sigma 0.1). L1 + SSIM (lambda_dssim 0.2),
    the default OptimizationConfig. 3 warm-up steps, then 10 timed ones;
    every kernel's launch count over those 13 steps. Then one more step
    records each kernel's arguments, and one is profiled. Returns (the
    recorded calls, the launch counts)."""
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
    return calls, launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from gsjax_torch.config import RasterConfig
    from gsjax_torch.render import kernels
    from gsjax_torch.render.api import render, render_oracle
    from gsjax_torch.synthetic import (
        look_at_origin_camera, orbit_camera, random_scene,
    )
    from gsjax_torch.tools import kernels as tool_kernels
    from gsjax_torch.tools.common import (
        cuda_ms, device_ms, instance_stream, profile_table,
    )

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

    # --- per-view time --------------------------------------------------------
    origin_ms = {}
    with torch.no_grad():
        for fast in (False, True):
            ms = []
            for view in views:
                ms.append(cuda_ms(lambda: draw(view, fast), reps=5))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for view in views:
                draw(view, fast)
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3 / len(views)
            mean_ms = sum(ms) / len(ms)
            origin_ms[fast] = ms[0]
            emit({"phase": "views", "fast_fwd": fast, "ms_per_view": ms,
                  "mean_ms": mean_ms, "host_ms_per_view": host_ms,
                  "mpx_per_s": BENCH_W * BENCH_H / mean_ms / 1e3})

        # --- device time by kernel over one render ---------------------------
        for fast in (False, True):
            emit(dict(phase="profile", view="origin", fast_fwd=fast,
                      **profile_table(lambda: draw("origin", fast), origin_ms[fast])))

    # --- the training step at full width -----------------------------------
    gt = results[("origin", False)].image
    del results
    tool_kernels.reset_launch_counts()
    train_calls, train_launches = phase_train(
        torch, kernels, random_scene, views["origin"], gt, dev)
    main_launches["step"] = dict(tool_kernels.launch_counts)
    if any(main_launches["views"].values()) or any(main_launches["step"].values()):
        raise AssertionError(f"a tools kernel ran on the main path: {main_launches}")

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

    from gsjax_torch import bench, profile_stages

    emit(dict(phase="bench", **bench.run(params, aux, views["origin"], cfgs[False])))
    stages = profile_stages.profile(
        profile_stages.Stages(params, aux, views["origin"], cfgs[False]))
    emit(dict(phase="stages", **stages))

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
        entries.append(dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name], launches=train_launches[name],
            view_run_launches=launches[name], max_abs_err=main_err,
            mid_scene_max_abs_err=errs[name], ms=ms, plain_ms=plain_ms,
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=library_ms, plain_source=PLAIN_SOURCE[name],
            event_ms=event_ms, bytes=nbytes, flops=flops, **extra,
        ))
    fwd_entry = next(e for e in entries if e["name"] == "composite_forward")
    entries += tool_entries(torch, tool_kernels, stream_bench, *tools, fwd_entry,
                            main_launches)
    entries += twin_entries(torch, tool_kernels, entries, origin_calls, train_calls,
                            tools[1], tools[2], twin_ms, main_launches)
    if not all(math.isfinite(e["ms"]) for e in entries):
        raise AssertionError("kernel timing failed")
    emit({"kernels": entries})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
