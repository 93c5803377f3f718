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
           sum of magnitudes), and binning's rank form (600k Gaussians at
           1920x1080 in 16x16 tiles) against its gather path
  oracle   render() and its gradients against the O(N * pixels) oracle
           and its autograd on the card; dead slots' gradients exactly 0
  main     the bench scene (500k Gaussians, SH degree 3, 1920x1080, 32x32
           tiles) rendered from four views, exact and fast_fwd, through
           render(); the forward kernels' launch counts over that run
  views    per-view render time (CUDA events and host clock)
  profile  device time by kernel over one render (torch.profiler)
  train    train_step() on the bench scene against the exact render of
           that scene, from a perturbed copy: 3 warm-up and 10 timed steps
           (loss per step, ms per step, pixels/s, host ms); all five
           kernels' launch counts over those steps; a profile of one step
Then the `kernels` line: for the forward kernels at the origin view's
render, for the backward kernels at one training step, each kernel's
launches (over the training run), its error against its plain version on
those very arguments (max_abs_err; the kernels phase's errors in
mid_scene_max_abs_err), device time from the profiler, time by CUDA events
with the host's launch work included, plain time, bound, and the time of
one PyTorch call computing the same function where there is one. Then the
card line and the result line.
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
}
REPLACES = {
    "composite_forward": "gsjax/render/pallas_kernels.py:220",
    "row_engine": "gsjax/render/pallas_kernels.py:846",
    "rank_prefix": "gsjax/render/pallas_kernels.py:524",
    "composite_backward": "gsjax/render/pallas_kernels.py:1153",
    "segment_sum": "gsjax/render/pallas_kernels.py:331",
}
SOURCES = {
    "composite_forward": "gsjax_torch/csrc/composite_forward.cu",
    "row_engine": "gsjax_torch/csrc/row_engine.cu",
    "rank_prefix": "gsjax_torch/csrc/rank_prefix.cu",
    "composite_backward": "gsjax_torch/csrc/composite_backward.cu",
    "segment_sum": "gsjax_torch/csrc/segment_sum.cu",
}
# Names of each wrapper's CUDA kernels, as the profiler reports them.
DEVICE_KERNELS = {
    "composite_forward": "composite_forward_kernel",
    "row_engine": "row_engine_",
    "rank_prefix": "rank_prefix_kernel",
    "composite_backward": "composite_backward_kernel",
    "segment_sum": "segment_sum_kernel",
}
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


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of fn() in ms, by CUDA events over `reps` runs."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, kernel_name: str, reps: int = 20) -> float:
    """Mean device time in ms of the CUDA kernels named `kernel_name*`
    that one fn() launches, from torch.profiler over `reps` runs. Unlike
    cuda_ms it leaves out the host's time between launches, which is
    longer than a microsecond kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # A profiling session now and then records no device events at all;
    # such a session is taken again.
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and kernel_name in e.key)
        if us > 0:
            return us / 1e3 / reps
    raise AssertionError(f"the profiler saw no device time for {kernel_name}")


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


def phase_build(kernels):
    t0 = time.perf_counter()
    kernels.build()
    seconds = time.perf_counter() - t0
    regs = {}
    for fn, n in re.findall(r"properties for (\S+)\n.*?Used (\d+) registers",
                            kernels.build_log(), re.S):
        short = re.search(r"\d+([a-z_]+_kernel(?:ILb[01])?|[a-z_]+)E", fn)
        regs[short.group(1) if short else fn] = int(n)
    spills = re.findall(r"(\d+) bytes spill stores", kernels.build_log())
    emit({"phase": "build", "seconds": seconds, "registers": regs,
          "spill_store_bytes": [int(s) for s in spills]})


def mid_scene_checks(torch, kernels, render, RasterConfig, random_scene,
                     look_at_origin_camera, dev, errs):
    """Each kernel against its plain version on the arguments of a
    20k-Gaussian 320x240 render and its backward (16x16, 32x32 and an
    overflowing budget)."""
    params, aux = random_scene(20_000, seed=1, spread=1.5, device=dev)
    cam = look_at_origin_camera(320, 240, device=dev)
    cases = {
        "16x16": RasterConfig(tile_size=16, max_instances=1 << 18, max_rows=1 << 16),
        "32x32": RasterConfig(tile_size=32, max_instances=1 << 18, max_rows=1 << 16),
        "overflow": RasterConfig(tile_size=16, max_instances=1 << 14, max_rows=1 << 12),
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
        line = {"phase": "kernels", "case": case, "num_instances": n_inst,
                "num_rows": n_rows}
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
    emit({"phase": "kernels", "case": "rank_form_1080p_16x16", "gaussians": 600_000,
          "num_instances": n_inst, "num_rows": n_rows, "rank_prefix": e,
          "binning_equals_gather_path": True, "launches": launched})


def phase_oracle(torch, render, render_oracle, RasterConfig, random_scene,
                 look_at_origin_camera, dev):
    """render() and its gradients against the oracle and the oracle's
    autograd (2k Gaussians at 128x96): images within 2e-3 (fast_fwd
    4e-3); the six raw-parameter and the mean2d_offset gradients within
    5e-3 of each one's largest; with half the slots dead, their gradients
    exactly 0."""
    from gsjax_torch.model import PARAM_NAMES

    params, aux = random_scene(2_000, seed=2, device=dev)
    cam = look_at_origin_camera(128, 96, device=dev)
    bg = torch.tensor([0.2, 0.3, 0.4], device=dev)
    with torch.no_grad():
        want = render_oracle(params, cam, active_sh_degree=3, bg_color=bg, alive=aux.alive)
        line = {"phase": "oracle", "gaussians": 2000, "width": 128, "height": 96}
        for fast, tol in ((False, 2e-3), (True, 4e-3)):
            cfg = RasterConfig(tile_size=16, max_instances=1 << 16, max_rows=1 << 14,
                               fast_fwd=fast)
            img = render(params, cam, active_sh_degree=3, bg_color=bg, cfg=cfg,
                         alive=aux.alive).image
            e = float((img - want).abs().max())
            if not e <= tol:
                raise AssertionError(f"render fast={fast} vs oracle: {e} > {tol}")
            line["fast_err" if fast else "exact_err"] = e

    cfg = RasterConfig(tile_size=16, max_instances=1 << 16, max_rows=1 << 14)
    leaves = [getattr(params, k) for k in PARAM_NAMES]

    def grads(fn, alive):
        off = torch.zeros((params.capacity, 2), device=dev, requires_grad=True)
        img = fn(alive, off)
        return torch.autograd.grad(torch.mean(img ** 2), leaves + [off])

    def tiled(alive, off):
        return render(params, cam, active_sh_degree=3, bg_color=bg, cfg=cfg,
                      alive=alive, mean2d_offset=off).image

    def oracle(alive, off):
        return render_oracle(params, cam, active_sh_degree=3, bg_color=bg,
                             alive=alive, mean2d_offset=off)

    got, ref = grads(tiled, aux.alive), grads(oracle, aux.alive)
    names = (*PARAM_NAMES, "mean2d_offset")
    grad_err = {}
    for name, g, r in zip(names, got, ref):
        grad_err[name] = float((g - r).abs().max() / r.abs().max().clamp(min=1e-8))
        if not grad_err[name] <= 5e-3:
            raise AssertionError(f"render grad {name} vs oracle: {grad_err[name]} > 5e-3")
    half = aux.alive & (torch.arange(params.capacity, device=dev) < 1_000)
    dead = grads(tiled, half)
    if any(bool((g[1_000:] != 0).any()) for g in dead) or not bool(
            (dead[0][:1_000] != 0).any()):
        raise AssertionError("dead slots' gradients are not exactly 0")
    line["grad_err"] = grad_err
    line["dead_slot_grads_zero"] = True
    emit(line)


def composite_pairs(torch, inst, tile_start, *, n_tiles, tiles_x, tile_w, tile_h):
    """(instance, pixel) pairs the exact composite must evaluate: per pixel,
    its tile's instances up to and including the one that terminates it;
    and the live pairs among them, those that contribute (and so carry
    gradient terms in the backward). The termination rule is the plain
    walk's (tiled.exact_step). Returns (evaluated, live)."""
    from gsjax_torch.render import tiled
    from gsjax_torch.render.common import tile_pixel_coords

    dev, chunk, pix = inst.device, 128, tile_w * tile_h
    i0, i1 = tile_start[:-1].long(), tile_start[1:].long()
    lanes = torch.arange(chunk, device=dev)
    total = live_total = 0
    batch = max(1, (1 << 25) // (pix * chunk))
    for t0 in range(0, n_tiles, batch):
        t1 = min(n_tiles, t0 + batch)
        px, py = tile_pixel_coords(torch.arange(t0, t1, device=dev), tiles_x, tile_w, tile_h)
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
            total += int((mask[:, None, :] & ~before).sum())
            live_total += int((~skip & (alpha > 0)).sum())
            t_cur, done = t_cur_next, skip[..., -1:]
    return total, live_total


def profile_table(torch, fn, unprofiled_ms, **line):
    """Device time by kernel over one fn() from torch.profiler: busy ms,
    the idle share against `unprofiled_ms` (the same work timed by CUDA
    events, without the profiler) and the top device ops."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(
        ((e.self_device_time_total, e.key, e.count)
         for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
        reverse=True,
    )
    busy_ms = sum(r[0] for r in rows) / 1e3
    emit(dict(line, profiled_wall_ms=wall_ms, unprofiled_ms=unprofiled_ms,
              device_busy_ms=busy_ms, idle_share=1.0 - busy_ms / unprofiled_ms,
              device_kernels=sum(r[2] for r in rows),
              top=[{"name": k[:90], "ms": us / 1e3, "count": c}
                   for us, k, c in rows[:15]]))


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

    profile_table(torch, one_step, ms, phase="profile", path="train_step")
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
        with Recorder(kernels) as rec:
            for view in views:
                for fast in (False, True):
                    results[(view, fast)] = draw(view, fast)
                    if view == "origin" and not fast:
                        origin_calls = dict(rec.calls)
        torch.cuda.synchronize()
        launches = dict(kernels.launch_counts)
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
            profile_table(torch, lambda: draw("origin", fast), origin_ms[fast],
                          phase="profile", view="origin", fast_fwd=fast)

    # --- the training step at full width -----------------------------------
    gt = results[("origin", False)].image
    del results
    train_calls, train_launches = phase_train(
        torch, kernels, random_scene, views["origin"], gt, dev)

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
            pairs, live = composite_pairs(
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
