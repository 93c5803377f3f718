"""What the profiling tools share: the bench scene and its instance stream,
and timing on the card.

The bench scene is bench.py's (500,000 Gaussians, SH degree 3, seed 0,
spread 2.5, scales 0.004-0.03, the origin view at 1920x1080, 32x32 tiles,
budgets of 1,179,648 instances and 524,288 rows), rebuilt bit for bit from
numpy by synthetic.random_scene. Its instance stream is what render()
hands the composite kernels for that view.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from gsjax_torch.config import RasterConfig
from gsjax_torch.core.cameras import Camera
from gsjax_torch.render.api import depth_sorted_bins, render
from gsjax_torch.render.binning import Binning, num_tiles
from gsjax_torch.render.common import build_inst_data
from gsjax_torch.render.graph import render_replayed
from gsjax_torch.render.preprocess import preprocess
from gsjax_torch.synthetic import look_at_origin_camera, random_scene

BENCH_N = 500_000
WIDTH, HEIGHT = 1920, 1080
SH_DEGREE = 3
TILE = 32
BUDGETS = dict(max_instances=1_179_648, max_rows=524_288)


def require_card(tool: str) -> None:
    """Measurement needs the card: exits with a message on a machine
    without one (never falls back to the CPU)."""
    if not torch.cuda.is_available():
        raise SystemExit(f"{tool}: no CUDA device; it measures the card")


def bench_scene(device=None, n: int = BENCH_N, width: int = WIDTH,
                height: int = HEIGHT, budgets: dict = BUDGETS):
    """(params, aux, camera, cfg) of the bench scene; `n`, the view size and
    the budgets shrink it for a test on the CPU."""
    params, aux = random_scene(
        n, capacity=n, sh_degree=SH_DEGREE, seed=0, spread=2.5,
        scale_range=(0.004, 0.03), device=device,
    )
    camera = look_at_origin_camera(width, height, device=device)
    cfg = RasterConfig(tile_w=TILE, tile_h=TILE, **budgets)
    return params, aux, camera, cfg


def trained_orbit_camera(angle: float, width: int, height: int,
                         fov_x: float = 0.85, radius: float = 4.2,
                         elev: float = 0.45, device=None) -> Camera:
    """COLMAP-convention orbit camera looking at the quality scene's center
    (0, 0.45, 0): the pose family of tools/synthetic_scene.camera_pose, as
    tools/bench_trained.py's _orbit_camera builds it."""
    target = np.array([0.0, 0.45, 0.0])
    pos = target + radius * np.array(
        [np.sin(angle) * np.cos(elev), np.sin(elev), np.cos(angle) * np.cos(elev)]
    )
    fwd = target - pos
    fwd /= np.linalg.norm(fwd)
    up_gl = np.array([0.0, 1.0, 0.0])
    right = np.cross(fwd, up_gl)
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    # world->cam rows, COLMAP convention (x right, y down, z forward).
    R_w2c = np.stack([right, -up, fwd], axis=0)
    t = -R_w2c @ pos
    fov_y = 2.0 * np.arctan(np.tan(fov_x / 2.0) * height / width)
    return Camera.create(
        R_w2c.T.astype(np.float32), t.astype(np.float32),
        fov_x=fov_x, fov_y=float(fov_y), width=width, height=height, device=device,
    )


@dataclasses.dataclass
class InstanceStream:
    """The composite kernels' inputs for one view: inst (P, 16) f32 rows,
    tile_start (T + 1,) int32, the depth-ordered fields (N, 9) they were
    gathered from, the binning, and the tile geometry the kernels take."""

    inst: torch.Tensor
    tile_start: torch.Tensor
    fields: torch.Tensor
    binning: Binning
    geometry: dict


def instance_stream(params, camera, cfg, alive=None, sh_degree: int = SH_DEGREE):
    """render()'s pipeline up to the composite kernels' inputs."""
    with torch.no_grad():
        proj = preprocess(
            xyz=params.xyz, sh=params.get_features(), opacity=params.get_opacity(),
            scaling=params.get_scaling(), rotation=params.rotation, camera=camera,
            active_sh_degree=sh_degree, alive=alive,
        )
        fields, binning = depth_sorted_bins(proj, camera, cfg)
        inst = build_inst_data(fields, binning.sorted_owner)
    tiles_x, tiles_y = num_tiles(camera.height, camera.width, cfg.tw, cfg.th)
    geometry = dict(n_tiles=tiles_x * tiles_y, tiles_x=tiles_x, tile_w=cfg.tw,
                    tile_h=cfg.th)
    return InstanceStream(inst, binning.tile_start, fields, binning, geometry)


# --- timing on the card ---------------------------------------------------------


def forward_frame(params, aux, camera, cfg, sh_degree: int = SH_DEGREE,
                  replayed: bool = False):
    """A viewer frame's work as a callable: render() under no_grad on a
    black background, returning its RenderOutput; with `replayed`, a
    replay of the captured render (render/graph.render_replayed, captured
    at the first call), as the port serves a frame."""
    bg = torch.zeros(3, device=params.device)
    fn = render_replayed if replayed else render

    def frame():
        with torch.no_grad():
            return fn(params, camera, active_sh_degree=sh_degree, bg_color=bg,
                      cfg=cfg, alive=aux.alive)

    return frame


def replayed_train_steps(params, aux, camera, cfg, steps: int, sh_degree: int = SH_DEGREE):
    """`steps` training steps (render, L1 + SSIM against a zero image,
    backward, Adam) on a copy of the scene's state as one call: replays of
    the captured step (train.step.step_graph, captured at the first call)
    on a one-view CameraBank. Returns the callable; it returns the
    window's losses."""
    from gsjax_torch.config import OptimizationConfig
    from gsjax_torch.scene import CameraBank
    from gsjax_torch.train import step as step_mod
    from gsjax_torch.train.optimizer import adam_init

    dev = params.device
    state = step_mod.clone_state(step_mod.TrainState(
        params=params, opt=adam_init(params), aux=aux,
        step=torch.ones((), dtype=torch.int32, device=dev)))
    shape = (camera.height, camera.width)
    bank = CameraBank.from_cameras([camera], [np.zeros((3, *shape), np.uint8)],
                                   [np.full((1, *shape), 255, np.uint8)])
    cams = torch.zeros(steps, dtype=torch.int32)
    bgs = torch.zeros((steps, 3), dtype=torch.float32)

    def run():
        _, m = step_mod.train_steps(
            state, bank, cams, bgs, active_sh_degree=sh_degree,
            opt_cfg=OptimizationConfig(), raster_cfg=cfg, spatial_lr_scale=1.0)
        return m.loss

    return run


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean time of fn() in ms, by CUDA events around `reps` back-to-back
    runs: device time plus whatever host time between launches the device
    waits for."""
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


# torch.profiler on the card now and then records no device events for a
# session, several sessions in a row at times: such a session is taken
# again, after a pause that grows with each try.
PROFILE_TRIES = 10


def _profiled(fn, reps: int, accept):
    """The CUDA events of one profiling session over `reps` runs of fn()
    (after one unprofiled run) that `accept` takes, trying PROFILE_TRIES
    sessions; None if none was accepted."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(PROFILE_TRIES):
        if attempt:
            time.sleep(0.05 * attempt)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if accept(events):
            return events
    return None


def device_ms(fn, kernel_name: str | None = None, reps: int = 20) -> float:
    """Mean device time in ms of the device work one fn() launches (only
    the kernels whose names hold `kernel_name`, if given), from
    torch.profiler over `reps` runs. Unlike cuda_ms it leaves out the
    host's time between launches, which is longer than a microsecond
    kernel. A session often misses one launch: a named kernel's time is
    its mean per recorded launch times its launches per call."""
    def named(events):
        return [e for e in events if kernel_name is None or kernel_name in e.name]

    events = _profiled(fn, reps, lambda ev: sum(e.self_device_time_total for e in named(ev)) > 0)
    if events is None:
        raise AssertionError(f"the profiler saw no device time for {kernel_name} "
                             f"in {PROFILE_TRIES} sessions")
    events = named(events)
    us = sum(e.self_device_time_total for e in events)
    if kernel_name is None:
        return us / 1e3 / reps
    return us / len(events) * max(round(len(events) / reps), 1) / 1e3


def device_ops(fn, kernel_name: str | None = None, calls: int = 5) -> dict:
    """The device operations of one fn() under no_grad, by torch.profiler
    over `calls` calls, rounded to whole operations per call (a session
    often misses one event): kernels, memsets, and with `kernel_name` the
    launches of the kernels whose names hold it (`named`; a session that
    recorded none of them is taken again)."""
    def is_memset(e):
        return "memset" in e.name.lower()

    def accept(events):
        return any(kernel_name in e.name for e in events) if kernel_name else bool(events)

    with torch.no_grad():
        events = _profiled(fn, calls, accept)
    if events is None:
        raise AssertionError(f"the profiler saw no device operation of {kernel_name} "
                             f"in {PROFILE_TRIES} sessions")
    memsets = sum(map(is_memset, events))
    out = {"kernels": round((len(events) - memsets) / calls),
           "memsets": round(memsets / calls)}
    if kernel_name:
        out["named"] = round(sum(kernel_name in e.name for e in events) / calls)
    return out


def profile_table(fn, unprofiled_ms: float, top: int = 15) -> dict:
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
    return dict(profiled_wall_ms=wall_ms, unprofiled_ms=unprofiled_ms,
                device_busy_ms=busy_ms, idle_share=1.0 - busy_ms / unprofiled_ms,
                device_kernels=sum(r[2] for r in rows),
                top=[{"name": k[:90], "ms": us / 1e3, "count": c}
                     for us, k, c in rows[:top]])
