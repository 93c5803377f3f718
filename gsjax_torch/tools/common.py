"""What the profiling tools share: the bench scene and its instance stream,
and timing on the card.

The bench scene is bench.py's (500,000 Gaussians, SH degree 3, seed 0,
spread 2.5, scales 0.004-0.03, the origin view at 1920x1080, 32x32 tiles,
budgets of 1,179,648 instances and 524,288 rows), rebuilt bit for bit from
numpy by synthetic.random_scene. Its instance stream is what render()
hands the composite kernels for that view.
"""

from __future__ import annotations

import contextlib
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
from gsjax_torch.utils.profiler import start_session, stop_session

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


# The names torch.profiler gives each kernel wrapper's CUDA kernels (a
# substring of each; no name holds another wrapper's).
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


class IncompleteSession(AssertionError):
    """A torch.profiler session that did not record every kernel launch
    the port counted while it was open."""


def port_launches() -> dict[str, int]:
    """The port's kernel launches executed on the card so far, by wrapper:
    the main kernels' (graph replays included, captures apart:
    render/graph.executed_launches) and the tools kernels'."""
    from gsjax_torch.render.graph import executed_launches
    from gsjax_torch.tools import kernels as tool_kernels

    return {**executed_launches(), **tool_kernels.launch_counts}


def kernel_events(names) -> dict[str, int]:
    """The device events among `names` of each kernel wrapper."""
    return {k: sum(sub in n for n in names) for k, sub in DEVICE_KERNELS.items()}


def session_gaps(names, launched: dict[str, int]) -> dict[str, tuple[int, int]]:
    """{wrapper: (events, launches)} for every wrapper whose kernel events
    among the device event names `names` differ from its launches."""
    seen = kernel_events(names)
    return {k: (seen[k], launched.get(k, 0)) for k in DEVICE_KERNELS
            if seen[k] != launched.get(k, 0)}


def check_whole(names, launched: dict[str, int], what: str = "a profiler session") -> None:
    """Raises IncompleteSession unless the device events `names` hold each
    kernel wrapper's launches exactly, and hold any event at all."""
    gaps = session_gaps(names, launched)
    if gaps:
        raise IncompleteSession(what + " recorded " + "; ".join(
            f"{seen} events of {k} ({DEVICE_KERNELS[k]}) where the port launched {n}"
            for k, (seen, n) in gaps.items()))
    if not names:
        raise IncompleteSession(f"{what} recorded no device event")


def device_event_names(prof) -> list[str]:
    """The names of a finished session's device operations, from the
    profiler's raw (Kineto) events; a range's span on the device timeline
    is not one (trace.is_marker)."""
    from torch.autograd import DeviceType

    from gsjax_torch.tools.trace import is_marker

    return [r.name() for r in prof.profiler.kineto_results.events()
            if r.device_type() == DeviceType.CUDA and not is_marker(r.name())]


@contextlib.contextmanager
def whole_session(cpu: bool = False):
    """A torch.profiler session (CUDA activity; with `cpu` the CPU's too)
    that opens with the port's warm-up step (utils/profiler.start_session)
    and is held to the port's own launch counts: when the body ends (the
    card synchronized), the session's events of each kernel wrapper must
    number the launches the port counted while it recorded
    (port_launches), and it must hold a device event. Else
    IncompleteSession, naming the kernel and both counts: a session is
    neither rescaled nor, here, taken again (whole_profile counts its
    retries). Yields the profiler."""
    from torch.profiler import ProfilerActivity

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    prof = start_session(activities)
    before = port_launches()
    try:
        yield prof
    finally:
        stop_session(prof)
    launched = {k: n - before[k] for k, n in port_launches().items()}
    check_whole(device_event_names(prof), launched)


# Sessions whole_profile takes over one body before it gives up. The
# warm-up step leaves an incomplete session now and then (PERF.md §6,
# fault F4): each one is refused, counted and reported.
PROFILE_TRIES = 3
_refused: list[str] = []


def whole_profile(body, cpu: bool = False):
    """The profiler of one whole session (whole_session) over body(). An
    incomplete session is refused and body() profiled again, at most
    PROFILE_TRIES sessions in all (the last refusal raises); every refused
    session's error is kept until with_refused reports it."""
    for attempt in range(PROFILE_TRIES):
        try:
            with whole_session(cpu) as prof:
                body()
            return prof
        except IncompleteSession as e:
            _refused.append(str(e))
            if attempt == PROFILE_TRIES - 1:
                raise


def with_refused(row: dict) -> dict:
    """`row`, with the errors of the profiler sessions refused since the
    last call (`profiler_sessions_refused`) where there were any: the line
    that reports a number also counts the sessions taken again for it."""
    refused = list(_refused)
    _refused.clear()
    return {**row, "profiler_sessions_refused": refused} if refused else row


def _profiled(fn, reps: int) -> list:
    """The device operations (CUDA events) of one whole session over `reps`
    runs of fn(), after one unprofiled run."""
    from torch.autograd import DeviceType

    from gsjax_torch.tools.trace import is_marker

    def body():
        for _ in range(reps):
            fn()

    fn()
    torch.cuda.synchronize()
    prof = whole_profile(body)
    return [e for e in prof.events()
            if e.device_type == DeviceType.CUDA and not is_marker(e.name)]


def device_ms(fn, kernel_name: str | None = None, reps: int = 20) -> float:
    """Mean device time in ms of the device work one fn() launches (only
    the kernels whose names hold `kernel_name`, if given), from one whole
    torch.profiler session over `reps` runs. Unlike cuda_ms it leaves out
    the host's time between launches, which is longer than a microsecond
    kernel."""
    events = [e for e in _profiled(fn, reps)
              if kernel_name is None or kernel_name in e.name]
    if not events:
        raise AssertionError(f"fn launched no kernel named {kernel_name}")
    return sum(e.self_device_time_total for e in events) / 1e3 / reps


def _per_call(count: int, calls: int, what: str) -> int:
    if count % calls:
        raise AssertionError(f"{count} {what} over {calls} calls: not the same each call")
    return count // calls


def device_ops(fn, kernel_name: str | None = None, calls: int = 5) -> dict:
    """The device operations of one fn() under no_grad, from one whole
    torch.profiler session over `calls` calls: kernels, memsets, and with
    `kernel_name` the launches of the kernels whose names hold it
    (`named`). Each count is the same for every call (else an error)."""
    with torch.no_grad():
        names = [e.name for e in _profiled(fn, calls)]
    memsets = sum("memset" in n.lower() for n in names)
    out = {"kernels": _per_call(len(names) - memsets, calls, "kernels"),
           "memsets": _per_call(memsets, calls, "memsets")}
    if kernel_name:
        out["named"] = _per_call(sum(kernel_name in n for n in names), calls, kernel_name)
    return out


def profile_table(fn, unprofiled_ms: float, top: int = 15) -> dict:
    """Device time by kernel over one fn() from torch.profiler: busy ms,
    the idle share against `unprofiled_ms` (the same work timed by CUDA
    events, without the profiler) and the top device ops."""
    from torch.autograd import DeviceType

    from gsjax_torch.tools.trace import is_marker

    wall = []

    def body():
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)

    torch.cuda.synchronize()
    prof = whole_profile(body, cpu=True)
    wall_ms = wall[-1]
    rows = sorted(
        ((e.self_device_time_total, e.key, e.count) for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA and not is_marker(e.key)),
        reverse=True,
    )
    busy_ms = sum(r[0] for r in rows) / 1e3
    return dict(profiled_wall_ms=wall_ms, unprofiled_ms=unprofiled_ms,
                device_busy_ms=busy_ms, idle_share=1.0 - busy_ms / unprofiled_ms,
                device_kernels=sum(r[2] for r in rows),
                top=[{"name": k[:90], "ms": us / 1e3, "count": c}
                     for us, k, c in rows[:top]])
