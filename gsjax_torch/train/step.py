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

import torch

from gsjax_torch.config import OptimizationConfig, RasterConfig
from gsjax_torch.core.cameras import Camera
from gsjax_torch.model import PARAM_NAMES, GaussianAux, GaussianParams
from gsjax_torch.render.api import render
from gsjax_torch.render.graph import (  # noqa: F401  (the graphs' accounting, shared)
    WARMUP_RUNS,
    capture_graph,
    captures,
    count_replays,
    drop_render_graphs,
    executed_launches,
    replayed_launch_counts,
    reset_graph_counts,
)
from gsjax_torch.train import mcmc
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
    generator: torch.Generator | None = None,
) -> tuple[TrainState, StepMetrics]:
    """One optimization iteration on one view.

    Args:
      state: updated in place: the parameters and Adam moments are
        overwritten, and the returned state holds the same tensors.
      camera: the view.
      gt_image: [3,H,W] f32 ground truth in [0, 1].
      bg: [3] background for this step.
      generator: under opt_cfg's "mcmc" strategy, the source of the
        position noise (the device's default generator when None); unused
        otherwise.
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
    if opt_cfg.mcmc:
        loss = loss + mcmc.regularizers(params, state.aux.alive, opt_cfg.opacity_reg,
                                        opt_cfg.scale_reg)
    leaves = [getattr(params, k) for k in PARAM_NAMES]
    *g_params, g_offset = torch.autograd.grad(loss, [*leaves, offset])

    aux = add_densification_stats(state.aux, out.radii, g_offset)
    lr_tree = make_lr_tree(opt_cfg, spatial_lr_scale, state.step)
    # In place, under no_grad (inside adam_update): the parameters and the
    # moments are overwritten rather than copied.
    opt = adam_update(dict(zip(PARAM_NAMES, g_params)), state.opt, params, lr_tree)
    if opt_cfg.mcmc:
        mcmc.add_position_noise_(params, state.aux.alive, lr_tree["xyz"], opt_cfg.noise_lr,
                                 generator)

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
    generator: torch.Generator | None = None,
) -> tuple[TrainState, StepMetrics]:
    """One step on view cam_idx ([] int tensor on the bank's device) of a
    CameraBank, picked on the device (gsjax/train/step.py:69-106)."""
    camera, gt_image = bank.pick(cam_idx)
    return train_step(
        state, camera, gt_image, bg, active_sh_degree=active_sh_degree,
        opt_cfg=opt_cfg, raster_cfg=raster_cfg, spatial_lr_scale=spatial_lr_scale,
        generator=generator,
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
    generator: torch.Generator | None = None,
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
            raster_cfg, spatial_lr_scale, generator,
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
    generator: torch.Generator | None = None,
) -> tuple[TrainState, StepMetrics]:
    """A window of W iterations (gsjax/train/step.py:152-179).

    cam_indices: [W] int view indices into `bank`; bgs: [W, 3]. Returns the
    state and the per-step metrics stacked along the window, on the
    state's device. On the card the window replays the captured step
    (`step_graph`) and updates the state's tensors in place; the returned
    state holds the same tensors. On the CPU, and on the card under
    anomaly detection, it is `scan_steps`. generator: the position noise's
    source under "mcmc" (train_step); the graph advances it on every
    replay, so step k of a window draws what an eager step would at the
    generator's offset then.
    """
    kw = dict(active_sh_degree=active_sh_degree, opt_cfg=opt_cfg,
              raster_cfg=raster_cfg, spatial_lr_scale=spatial_lr_scale)
    if opt_cfg.mcmc:
        kw["generator"] = generator
    if state.params.device.type != "cuda" or torch.is_anomaly_enabled():
        return scan_steps(state, bank, cam_indices, bgs, **kw)
    return step_graph(state, bank, **kw).run(cam_indices, bgs)


# --- the captured step ------------------------------------------------------

# Steps a graph's camera, background and metric buffers hold: the longest
# window `train_steps` replays on the card (the Trainer's are at most its
# max_window, 50 by default).
GRAPH_WINDOW = 1024

_GRAPHS: dict[tuple, "StepGraph"] = {}


def drop_step_graphs() -> None:
    """Forget every captured step and render (and free their memory
    pools): after a budget change or a capacity growth, as gsjax's
    `_apply_budgets` drops its compiled executables."""
    _GRAPHS.clear()
    drop_render_graphs()


def _bound_ptrs(state: TrainState, bank) -> tuple[int, ...]:
    bank_tensors = (bank.views, bank.full_projs, bank.centers, bank.tan_fovx,
                    bank.tan_fovy, bank.gt_rgb, bank.alpha)
    return tuple(t.data_ptr() for t in (*state_tensors(state), *bank_tensors))


def capture_step(body, state: TrainState, record: dict, generators=()):
    """Capture body(state) once (render/graph.py's capture_graph), warmed up
    by WARMUP_RUNS eager runs of body on a copy of the state; `generators`
    are the generators body draws from other than the device's default.
    Returns (graph, {kernel: launches per replay}). A capture error
    propagates."""
    def warm_up():
        scratch = clone_state(state)
        for _ in range(WARMUP_RUNS):
            body(scratch)

    return capture_graph(lambda: body(state), state.params.device,
                         {"graph": "step", **record}, warm_up, generators)


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
    generator: torch.Generator | None = None,
) -> "StepGraph":
    """The captured step for this key, captured on first use: the
    counterpart of gsjax's executable key (resolution, capacity, SH
    degree, configs), the noise's generator where the step draws one, plus
    the addresses of the state's and the bank's tensors, which the graph
    reads and writes in place. Capturing for a new state drops the graphs
    bound to another one."""
    drawn = () if generator is None else (generator,)
    key = (bank.width, bank.height, state.params.capacity, active_sh_degree,
           raster_cfg, opt_cfg, spatial_lr_scale, *drawn, _bound_ptrs(state, bank))
    return register_graph(key, state, lambda: StepGraph(
        state, bank, active_sh_degree=active_sh_degree, opt_cfg=opt_cfg,
        raster_cfg=raster_cfg, spatial_lr_scale=spatial_lr_scale, generator=generator))


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

    def _capture(self, state: TrainState, record: dict, generators=()) -> None:
        dev = state.params.device
        self.state = state
        self.cursor = torch.zeros((), dtype=torch.int64, device=dev)
        self.out = {k: torch.zeros(GRAPH_WINDOW, dtype=d, device=dev)
                    for k, d in METRIC_DTYPES.items()}
        self.graph, self.launches = capture_step(self._body, state, record, generators)

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
        count_replays(self.launches, w)
        return self.state, StepMetrics(**{k: v[:w].clone() for k, v in self.out.items()})


class StepGraph(CapturedStep):
    """`_step_core` captured once, bound to one state and one bank: each
    replay reads view index and background number `cursor` of the
    window's buffers."""

    def __init__(self, state: TrainState, bank, *, active_sh_degree: int,
                 opt_cfg: OptimizationConfig, raster_cfg: RasterConfig,
                 spatial_lr_scale: float, generator: torch.Generator | None = None):
        dev = state.params.device
        self.bank = bank
        self.step_kw = dict(active_sh_degree=active_sh_degree, opt_cfg=opt_cfg,
                            raster_cfg=raster_cfg, spatial_lr_scale=spatial_lr_scale)
        if generator is not None:
            self.step_kw["generator"] = generator
        self.cam_buf = torch.zeros(GRAPH_WINDOW, dtype=torch.int32, device=dev)
        self.bg_buf = torch.zeros((GRAPH_WINDOW, 3), dtype=torch.float32, device=dev)
        self._capture(state, dict(
            width=bank.width, height=bank.height, capacity=state.params.capacity,
            active_sh_degree=active_sh_degree,
            budgets=[raster_cfg.max_instances, raster_cfg.max_rows]),
            () if generator is None else (generator,))

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
