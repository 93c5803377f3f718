"""The training step, and windows of steps.

`train_step` is the body of the reference hot loop (reference:
train.py:69-128) for one view, as `gsjax.train.step._step_core` runs it:
render -> L1 + SSIM loss -> backward -> Adam. The screen-space position
gradient that the reference reads from its dummy means2D tensor is the
gradient of an explicit zero `mean2d_offset` input, taken in the same
backward pass.

`train_steps` runs a window of W steps, each on a view picked from a
CameraBank on the device, as gsjax's scan of `_step_core` does. On CPU
tensors it is a Python loop of `_step_core`. On CUDA tensors it replays
one captured CUDA graph of `_step_core` W times: the graph reads the
window's camera index and background through a cursor on the device, so
a step is one `replay()` and a window makes no host sync. Under
`torch.autograd.set_detect_anomaly` (which a graph cannot capture) the
window runs the loop on the card too.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from gsjax_torch.config import OptimizationConfig, RasterConfig
from gsjax_torch.core.cameras import Camera
from gsjax_torch.model import PARAM_NAMES, GaussianAux, GaussianParams
from gsjax_torch.render import kernels
from gsjax_torch.render.api import render
from gsjax_torch.train.densify import add_densification_stats
from gsjax_torch.train.loss import l1_loss, ssim
from gsjax_torch.train.optimizer import AdamState, adam_update, make_lr_tree


@dataclasses.dataclass
class TrainState:
    params: GaussianParams
    opt: AdamState
    aux: GaussianAux
    step: torch.Tensor  # [] int32, 1-based like the reference loop


@dataclasses.dataclass
class StepMetrics:
    loss: torch.Tensor
    l1: torch.Tensor
    num_instances: torch.Tensor
    num_rows: torch.Tensor


METRIC_DTYPES = {
    "loss": torch.float32, "l1": torch.float32, "num_instances": torch.int32,
    "num_rows": torch.int32,
}
AUX_NAMES = ("alive", "max_radii2d", "xyz_grad_accum", "denom")


def state_tensors(state: TrainState) -> list[torch.Tensor]:
    """Every tensor of the state, in a fixed order."""
    return (
        [getattr(state.params, k) for k in PARAM_NAMES]
        + [state.opt.mu[k] for k in PARAM_NAMES]
        + [state.opt.nu[k] for k in PARAM_NAMES]
        + [getattr(state.aux, k) for k in AUX_NAMES]
        + [state.opt.count, state.step]
    )


@torch.no_grad()
def clone_state(state: TrainState) -> TrainState:
    """A copy of the state holding new tensors."""
    return TrainState(
        params=GaussianParams(
            **{k: getattr(state.params, k).detach().clone() for k in PARAM_NAMES}),
        opt=AdamState(
            count=state.opt.count.clone(),
            mu={k: v.clone() for k, v in state.opt.mu.items()},
            nu={k: v.clone() for k, v in state.opt.nu.items()},
        ),
        aux=GaussianAux(**{k: getattr(state.aux, k).clone() for k in AUX_NAMES}),
        step=state.step.clone(),
    )


@torch.no_grad()
def copy_state_(dst: TrainState, src: TrainState) -> None:
    """Write every tensor of src into dst's tensor of the same name, in
    place (same capacity): the tensors a captured step reads keep their
    addresses."""
    for d, s in zip(state_tensors(dst), state_tensors(src)):
        if d.data_ptr() != s.data_ptr():
            d.copy_(s)


def train_step(
    state: TrainState,
    camera: Camera,
    gt_image: torch.Tensor,
    bg: torch.Tensor,
    *,
    active_sh_degree: int,
    opt_cfg: OptimizationConfig,
    raster_cfg: RasterConfig,
    spatial_lr_scale: float,
) -> tuple[TrainState, StepMetrics]:
    """One optimization iteration on one view.

    Args:
      state: updated in place: the parameters and Adam moments are
        overwritten, and the returned state holds the same tensors.
      camera: the view.
      gt_image: [3,H,W] f32 ground truth in [0, 1].
      bg: [3] background for this step.
    """
    params = state.params
    offset = torch.zeros(
        (params.capacity, 2), dtype=torch.float32, device=params.device,
        requires_grad=True,
    )
    out = render(
        params, camera, active_sh_degree=active_sh_degree, bg_color=bg,
        cfg=raster_cfg, alive=state.aux.alive, mean2d_offset=offset,
    )
    l1 = l1_loss(out.image, gt_image)
    lam = opt_cfg.lambda_dssim
    loss = (1.0 - lam) * l1 + lam * (1.0 - ssim(out.image, gt_image))
    leaves = [getattr(params, k) for k in PARAM_NAMES]
    *g_params, g_offset = torch.autograd.grad(loss, [*leaves, offset])

    aux = add_densification_stats(state.aux, out.radii, g_offset)
    lr_tree = make_lr_tree(opt_cfg, spatial_lr_scale, state.step)
    # In place, under no_grad (inside adam_update): the parameters and the
    # moments are overwritten rather than copied.
    opt = adam_update(dict(zip(PARAM_NAMES, g_params)), state.opt, params, lr_tree)

    new_state = TrainState(params=params, opt=opt, aux=aux, step=state.step + 1)
    metrics = StepMetrics(
        loss=loss.detach(), l1=l1.detach(), num_instances=out.num_instances,
        num_rows=out.num_rows,
    )
    return new_state, metrics


def _step_core(
    state: TrainState,
    bank,
    cam_idx: torch.Tensor,
    bg: torch.Tensor,
    active_sh_degree: int,
    opt_cfg: OptimizationConfig,
    raster_cfg: RasterConfig,
    spatial_lr_scale: float,
) -> tuple[TrainState, StepMetrics]:
    """One step on view cam_idx ([] int tensor on the bank's device) of a
    CameraBank, picked on the device (gsjax/train/step.py:69-106)."""
    camera, gt_image = bank.pick(cam_idx)
    return train_step(
        state, camera, gt_image, bg, active_sh_degree=active_sh_degree,
        opt_cfg=opt_cfg, raster_cfg=raster_cfg, spatial_lr_scale=spatial_lr_scale,
    )


def stack_metrics(metrics: list[StepMetrics]) -> StepMetrics:
    return StepMetrics(**{
        k: torch.stack([getattr(m, k) for m in metrics]) for k in METRIC_DTYPES
    })


def scan_steps(
    state: TrainState,
    bank,
    cam_indices: torch.Tensor,
    bgs: torch.Tensor,
    *,
    active_sh_degree: int,
    opt_cfg: OptimizationConfig,
    raster_cfg: RasterConfig,
    spatial_lr_scale: float,
) -> tuple[TrainState, StepMetrics]:
    """The window as a Python loop of `_step_core` on the state's device
    (the semantics of gsjax's lax.scan); metrics stacked to [W]."""
    dev = state.params.device
    cam_indices = torch.as_tensor(cam_indices, dtype=torch.int32).to(dev)
    bgs = torch.as_tensor(bgs, dtype=torch.float32).to(dev)
    metrics = []
    for k in range(cam_indices.shape[0]):
        state, m = _step_core(
            state, bank, cam_indices[k], bgs[k], active_sh_degree, opt_cfg,
            raster_cfg, spatial_lr_scale,
        )
        metrics.append(m)
    return state, stack_metrics(metrics)


def train_steps(
    state: TrainState,
    bank,
    cam_indices: torch.Tensor,
    bgs: torch.Tensor,
    *,
    active_sh_degree: int,
    opt_cfg: OptimizationConfig,
    raster_cfg: RasterConfig,
    spatial_lr_scale: float,
) -> tuple[TrainState, StepMetrics]:
    """A window of W iterations (gsjax/train/step.py:152-179).

    cam_indices: [W] int view indices into `bank`; bgs: [W, 3]. Returns the
    state and the per-step metrics stacked along the window, on the
    state's device. On the card the window replays the captured step
    (`step_graph`) and updates the state's tensors in place; the returned
    state holds the same tensors. On the CPU, and on the card under
    anomaly detection, it is `scan_steps`.
    """
    kw = dict(active_sh_degree=active_sh_degree, opt_cfg=opt_cfg,
              raster_cfg=raster_cfg, spatial_lr_scale=spatial_lr_scale)
    if state.params.device.type != "cuda" or torch.is_anomaly_enabled():
        return scan_steps(state, bank, cam_indices, bgs, **kw)
    return step_graph(state, bank, **kw).run(cam_indices, bgs)


# --- the captured step ------------------------------------------------------

# Steps a graph's camera, background and metric buffers hold: the longest
# window `train_steps` replays on the card (the Trainer's are at most its
# max_window, 50 by default).
GRAPH_WINDOW = 1024
# Eager steps on a copy of the state before a capture (torch's
# whole-network capture recipe): they build the kernels, start autograd's
# device threads and fill the allocator's cache.
WARMUP_STEPS = 2

# Kernel launches made by graph replays. render/kernels.py counts launches
# on the host, where a wrapper calls its kernel; a capture records each
# such launch once into the graph (counted there, though a capture runs
# nothing) and a replay repeats them, so the launches of replays are the
# capture's count times the replays.
replayed_launch_counts = {name: 0 for name in kernels.KERNEL_NAMES}
# One record per capture: its key's sizes, warm-up and capture ms, the
# bytes its memory pool took and the launches it recorded.
captures: list[dict] = []

_GRAPHS: dict[tuple, "StepGraph"] = {}


def reset_graph_counts() -> None:
    for name in replayed_launch_counts:
        replayed_launch_counts[name] = 0
    captures.clear()


def executed_launches() -> dict[str, int]:
    """Kernel launches executed on the card since the counts were reset:
    the host's count, less what captures recorded, plus the replays'."""
    return {k: kernels.launch_counts[k] + replayed_launch_counts[k]
            - sum(c["launches"][k] for c in captures) for k in kernels.KERNEL_NAMES}


def drop_step_graphs() -> None:
    """Forget every captured step (and free its memory pool): after a
    budget change or a capacity growth, as gsjax's `_apply_budgets` drops
    its compiled executables."""
    _GRAPHS.clear()


def _bound_ptrs(state: TrainState, bank) -> tuple[int, ...]:
    bank_tensors = (bank.views, bank.full_projs, bank.centers, bank.tan_fovx,
                    bank.tan_fovy, bank.gt_rgb, bank.alpha)
    return tuple(t.data_ptr() for t in (*state_tensors(state), *bank_tensors))


def capture_step(body, state: TrainState, record: dict):
    """Capture body(state) once as a torch.cuda.CUDAGraph, torch's
    whole-network recipe: WARMUP_STEPS eager runs of body on a copy of the
    state on a side stream first, then the capture, which runs nothing.
    Appends `record` with the warm-up and capture ms, the bytes the
    graph's memory pool took and the launches it recorded to `captures`.
    Returns (graph, {kernel: launches per replay}). A capture error
    propagates."""
    dev = state.params.device
    t0 = time.perf_counter()
    side = torch.cuda.Stream(device=dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        scratch = clone_state(state)
        for _ in range(WARMUP_STEPS):
            body(scratch)
        del scratch
    torch.cuda.current_stream(dev).wait_stream(side)
    torch.cuda.synchronize(dev)
    warmup_ms = (time.perf_counter() - t0) * 1e3

    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(dev)
    before = dict(kernels.launch_counts)
    t0 = time.perf_counter()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        body(state)
    torch.cuda.synchronize(dev)
    capture_ms = (time.perf_counter() - t0) * 1e3
    launches = {k: kernels.launch_counts[k] - before[k] for k in kernels.KERNEL_NAMES}
    captures.append({
        **record, "warmup_ms": warmup_ms, "capture_ms": capture_ms,
        "pool_bytes": torch.cuda.memory_reserved(dev) - reserved,
        "launches": dict(launches),
    })
    return graph, launches


def register_graph(key: tuple, state: TrainState, make):
    """The captured step under `key`, whose last element starts with the
    addresses of the state's tensors; made by make() on first use.
    Capturing for a new state drops the graphs bound to another one."""
    graph = _GRAPHS.get(key)
    if graph is None:
        state_ptrs = tuple(t.data_ptr() for t in state_tensors(state))
        for k in [k for k in _GRAPHS if k[-1][:len(state_ptrs)] != state_ptrs]:
            del _GRAPHS[k]
        graph = _GRAPHS[key] = make()
    return graph


def step_graph(
    state: TrainState,
    bank,
    *,
    active_sh_degree: int,
    opt_cfg: OptimizationConfig,
    raster_cfg: RasterConfig,
    spatial_lr_scale: float,
) -> "StepGraph":
    """The captured step for this key, captured on first use: the
    counterpart of gsjax's executable key (resolution, capacity, SH
    degree, configs), plus the addresses of the state's and the bank's
    tensors, which the graph reads and writes in place. Capturing for a
    new state drops the graphs bound to another one."""
    key = (bank.width, bank.height, state.params.capacity, active_sh_degree,
           raster_cfg, opt_cfg, spatial_lr_scale, _bound_ptrs(state, bank))
    return register_graph(key, state, lambda: StepGraph(
        state, bank, active_sh_degree=active_sh_degree, opt_cfg=opt_cfg,
        raster_cfg=raster_cfg, spatial_lr_scale=spatial_lr_scale))


class CapturedStep:
    """A training step captured once as a torch.cuda.CUDAGraph, bound to
    one state (the base of StepGraph and the mesh's ShardedStepGraph).

    The graph runs `_step(state)`, which reads the subclass's bound inputs,
    copies the new state into the state's tensors (the parameters and
    moments are updated in place by Adam; the new aux, step and Adam count
    are copied back), writes the step's four metrics into row `cursor` of
    [GRAPH_WINDOW] buffers and adds one to the cursor, all on the device.
    A capture or replay error propagates.
    """

    def _capture(self, state: TrainState, record: dict) -> None:
        dev = state.params.device
        self.state = state
        self.cursor = torch.zeros((), dtype=torch.int64, device=dev)
        self.out = {k: torch.zeros(GRAPH_WINDOW, dtype=d, device=dev)
                    for k, d in METRIC_DTYPES.items()}
        self.graph, self.launches = capture_step(self._body, state, record)

    def _step(self, state: TrainState) -> tuple[TrainState, StepMetrics]:
        raise NotImplementedError

    def _body(self, state: TrainState) -> None:
        new, m = self._step(state)
        with torch.no_grad():
            copy_state_(state, new)
            at = self.cursor.view(1)
            for k, buf in self.out.items():
                buf.index_copy_(0, at, getattr(m, k).reshape(1))
            self.cursor.add_(1)

    @staticmethod
    def check_window(w: int) -> None:
        if w > GRAPH_WINDOW:
            raise ValueError(f"a window of {w} steps is longer than the "
                             f"captured step's buffers ({GRAPH_WINDOW})")

    def _replay(self, w: int, feed=None) -> tuple[TrainState, StepMetrics]:
        """w replays, feed(k) issuing step k's input copies before its
        replay (in stream order); metrics [W] on the card (copies: the next
        window reuses the buffers)."""
        self.cursor.zero_()
        for k in range(w):
            if feed is not None:
                feed(k)
            self.graph.replay()
        for name, n in self.launches.items():
            replayed_launch_counts[name] += n * w
        return self.state, StepMetrics(**{k: v[:w].clone() for k, v in self.out.items()})


class StepGraph(CapturedStep):
    """`_step_core` captured once, bound to one state and one bank: each
    replay reads view index and background number `cursor` of the
    window's buffers."""

    def __init__(self, state: TrainState, bank, *, active_sh_degree: int,
                 opt_cfg: OptimizationConfig, raster_cfg: RasterConfig,
                 spatial_lr_scale: float):
        dev = state.params.device
        self.bank = bank
        self.step_kw = dict(active_sh_degree=active_sh_degree, opt_cfg=opt_cfg,
                            raster_cfg=raster_cfg, spatial_lr_scale=spatial_lr_scale)
        self.cam_buf = torch.zeros(GRAPH_WINDOW, dtype=torch.int32, device=dev)
        self.bg_buf = torch.zeros((GRAPH_WINDOW, 3), dtype=torch.float32, device=dev)
        self._capture(state, dict(
            width=bank.width, height=bank.height, capacity=state.params.capacity,
            active_sh_degree=active_sh_degree,
            budgets=[raster_cfg.max_instances, raster_cfg.max_rows]))

    def _step(self, state: TrainState) -> tuple[TrainState, StepMetrics]:
        at = self.cursor.view(1)
        cam_idx = self.cam_buf.index_select(0, at).squeeze(0)
        bg = self.bg_buf.index_select(0, at).squeeze(0)
        return _step_core(state, self.bank, cam_idx, bg, **self.step_kw)

    def run(self, cam_indices, bgs) -> tuple[TrainState, StepMetrics]:
        """Replay the step once per view of the window."""
        # From pinned host memory without blocking: a pageable copy would
        # wait for the card (torch synchronizes the stream after one).
        cam_indices, bgs = (
            t.contiguous().pin_memory() if t.device.type == "cpu" else t
            for t in (torch.as_tensor(cam_indices, dtype=torch.int32),
                      torch.as_tensor(bgs, dtype=torch.float32)))
        w = cam_indices.shape[0]
        self.check_window(w)
        self.cam_buf[:w].copy_(cam_indices, non_blocking=True)
        self.bg_buf[:w].copy_(bgs, non_blocking=True)
        return self._replay(w)
