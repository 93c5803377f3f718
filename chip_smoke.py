#!/usr/bin/env python3
"""Drive the gsjax_torch render path on one CUDA card and check it.

Run from the repository root, with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, one JSON line each (any failure exits non-zero):
  device   the card's name and power limit (nvidia-smi)
  build    the CUDA kernels compiled from gsjax_torch/csrc
  kernels  each kernel against its plain PyTorch version on the card, on
           the arguments a mid-size render gives it (integers exact,
           composite within 2e-3, fast within 4e-3), and binning's rank
           form (600k Gaussians at 1920x1080 in 16x16 tiles) against its
           gather path
  oracle   render() against the O(N * pixels) oracle on the card
  main     the bench scene (500k Gaussians, SH degree 3, 1920x1080, 32x32
           tiles) rendered from four views, exact and fast_fwd, through
           render(); every kernel's launch count over that run
  views    per-view render time (CUDA events and host clock)
  profile  device time by kernel over one render (torch.profiler)
Then the `kernels` line, at the main path's shapes (the origin view's
exact render): each kernel's launches, its error against its plain version
on those very arguments (max_abs_err; the composite's fast mode in
fast_max_abs_err; the kernels phase's errors in mid_scene_max_abs_err),
device time from the profiler, time by CUDA events with the host's launch
work included, plain time and bound. Then the card line and the result
line.
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
# kernel: dx, dy, the quadratic form (9), exp, opacity * G.
COMPOSITE_FLOP_PER_PAIR = 13

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
}
REPLACES = {
    "composite_forward": "gsjax/render/pallas_kernels.py:220",
    "row_engine": "gsjax/render/pallas_kernels.py:846",
    "rank_prefix": "gsjax/render/pallas_kernels.py:524",
}
SOURCES = {
    "composite_forward": "gsjax_torch/csrc/composite_forward.cu",
    "row_engine": "gsjax_torch/csrc/row_engine.cu",
    "rank_prefix": "gsjax_torch/csrc/rank_prefix.cu",
}
# Names of each wrapper's CUDA kernels, as the profiler reports them.
DEVICE_KERNELS = {
    "composite_forward": "composite_forward_kernel",
    "row_engine": "row_engine_",
    "rank_prefix": "rank_prefix_kernel",
}


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
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and kernel_name in e.key)
    if not us > 0:
        raise AssertionError(f"the profiler saw no device time for {kernel_name}")
    return us / 1e3 / reps


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
    """Each kernel against its plain version on a 20k-Gaussian 320x240
    render's arguments (16x16, 32x32 and an overflowing budget)."""
    params, aux = random_scene(20_000, seed=1, spread=1.5, device=dev)
    cam = look_at_origin_camera(320, 240, device=dev)
    cases = {
        "16x16": RasterConfig(tile_size=16, max_instances=1 << 18, max_rows=1 << 16),
        "32x32": RasterConfig(tile_size=32, max_instances=1 << 18, max_rows=1 << 16),
        "overflow": RasterConfig(tile_size=16, max_instances=1 << 14, max_rows=1 << 12),
    }
    for case, cfg in cases.items():
        kernels.reset_launch_counts()
        with Recorder(kernels) as rec, torch.no_grad():
            out = render(params, cam, active_sh_degree=3,
                         bg_color=torch.zeros(3, device=dev), cfg=cfg, alive=aux.alive)
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
        for fast, tol in ((False, 2e-3), (True, 4e-3)):
            kwf = dict(kw, fast=fast)
            e = max_err(kernels.composite_forward(*args, **kwf),
                        kernels.composite_forward_plain(*args, **kwf))
            if not e <= tol:
                raise AssertionError(f"{case}: composite fast={fast} error {e} > {tol}")
            errs["composite_forward"] = max(errs["composite_forward"], e)
            line["composite_fast" if fast else "composite_exact"] = e
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
    emit(line)


def composite_pairs(torch, inst, tile_start, *, n_tiles, tiles_x, tile_w, tile_h):
    """(instance, pixel) pairs the exact composite must evaluate: per pixel,
    its tile's instances up to and including the one that terminates it.
    The termination rule is the plain walk's (tiled.exact_step)."""
    from gsjax_torch.render import tiled
    from gsjax_torch.render.common import tile_pixel_coords

    dev, chunk, pix = inst.device, 128, tile_w * tile_h
    i0, i1 = tile_start[:-1].long(), tile_start[1:].long()
    lanes = torch.arange(chunk, device=dev)
    total = 0
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
            alpha = tiled._chunk_alpha(f, px, py, mask)
            _, skip, _, t_cur_next = tiled.exact_step(t_cur, done, alpha)
            before = torch.cat([done, skip[..., :-1]], dim=-1)  # done before lane
            total += int((mask[:, None, :] & ~before).sum())
            t_cur, done = t_cur_next, skip[..., -1:]
    return total


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
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
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
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        for fast in (False, True):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                draw("origin", fast)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            rows = sorted(
                ((e.self_device_time_total, e.key, e.count)
                 for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                reverse=True,
            )
            busy_ms = sum(r[0] for r in rows) / 1e3
            # Idle share against the unprofiled view time (CUDA events).
            emit({"phase": "profile", "view": "origin", "fast_fwd": fast,
                  "profiled_wall_ms": wall_ms, "view_ms": origin_ms[fast],
                  "device_busy_ms": busy_ms,
                  "idle_share": 1.0 - busy_ms / origin_ms[fast],
                  "device_kernels": sum(r[2] for r in rows),
                  "top": [{"name": k[:90], "ms": us / 1e3, "count": c}
                          for us, k, c in rows[:12]]})

        # --- each kernel at the main path's shapes ---------------------------
        entries = []
        for name in kernels.KERNEL_NAMES:
            args, kw = origin_calls[name]
            fn = getattr(kernels, name)
            plain = getattr(kernels, f"{name}_plain")
            # The kernel against its plain version on these very arguments:
            # integers exactly, the composite within 2e-3 (fast 4e-3).
            if name == "composite_forward":
                checks = ((dict(kw, fast=False), 2e-3), (dict(kw, fast=True), 4e-3))
            else:
                checks = ((kw, 0.0),)
            main_errs = []
            for kwc, tol in checks:
                e = max_err(fn(*args, **kwc), plain(*args, **kwc))
                if not e <= tol:
                    raise AssertionError(f"main path: {name} {kwc.get('fast', '')} "
                                         f"differs from plain by {e} > {tol}")
                main_errs.append(e)
            ms = device_ms(lambda: fn(*args, **kw), DEVICE_KERNELS[name])
            event_ms = cuda_ms(lambda: fn(*args, **kw), reps=20, warmup=2)
            plain_ms = cuda_ms(lambda: plain(*args, **kw), reps=2)
            if name == "composite_forward":
                inst, tile_start = args
                n_inst = int(tile_start[-1])
                pairs = composite_pairs(
                    torch, inst, tile_start, n_tiles=kw["n_tiles"], tiles_x=kw["tiles_x"],
                    tile_w=kw["tile_w"], tile_h=kw["tile_h"],
                )
                pix = kw["tile_w"] * kw["tile_h"]
                nbytes = n_inst * 9 * 4 + tile_start.numel() * 4 + kw["n_tiles"] * pix * 16
                flops = pairs * COMPOSITE_FLOP_PER_PAIR
                extra = {"pairs_evaluated": pairs, "fast_max_abs_err": main_errs[1],
                         "fast_ms": device_ms(lambda: fn(*args, **dict(kw, fast=True)),
                                              DEVICE_KERNELS[name])}
            elif name == "row_engine":
                table, total_rows = args
                rows_used = min(int(total_rows), kw["budget"])
                with_rows = int((table[1] > table[0]).sum())
                # rstart column whole, 11 more columns of Gaussians with rows,
                # istart/delta/u written.
                nbytes = table.shape[1] * 4 + with_rows * 11 * 4 + 3 * kw["budget"] * 4
                flops = rows_used * 60
                extra = {"rows": rows_used}
            else:
                start, _ = args[:2]
                nbytes = start.numel() * 4 * 2 + kw["budget"] * 4
                flops = kw["budget"] * 4
                extra = {}
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / F32_FLOP_PER_S * 1e3
            entries.append(dict(
                name=name, route="cuda", source=SOURCES[name],
                replaces=REPLACES[name], launches=launches[name],
                max_abs_err=main_errs[0], mid_scene_max_abs_err=errs[name],
                ms=ms, plain_ms=plain_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=None, plain_source=PLAIN_SOURCE[name],
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
