"""Renders captured once as CUDA graphs and replayed, as gsjax runs every
render it serves, evaluates or times through `jax.jit`.

gsjax compiles a render per static key and caches the executable
(gsjax/train/trainer.py:215-256 for the viewer and `render_view`,
`_eval_bank_fn` at :825-861 for the held-out evaluation,
gsjax/cli/render.py:49-74 for the render CLI). The port's counterpart is a
torch.cuda.CUDAGraph of the same work, captured once per key and replayed:
a 1080p view is one replay instead of ~500 launches from the host.

* `render_replayed` takes render()'s arguments. On CUDA tensors it replays
  the RenderGraph of its key, captured on first use; on the CPU it is
  render() itself.
* `eval_views` is the held-out evaluation of views of a CameraBank: on CUDA
  tensors one captured EvalGraph (render, clamp, L1, PSNR of the view at a
  cursor) replayed per view, the per-view results written into buffers
  that the caller reads back once; on the CPU the same sums eagerly.
* Keys: gsjax's (width, height, SH degree, the SH and covariance paths,
  fast, RasterConfig), the capacity, and the addresses of the tensors the
  graph reads (the parameters and `alive`; an evaluation's bank too). A
  graph holds those tensors, so an address in a live key names them.
* The render graphs have a registry of their own, apart from the training
  step's (train/step.py), so a viewer frame drops no captured step.
  Capturing for other parameters drops the graphs bound to the old ones,
  and at most RENDER_GRAPH_CAP stay live, the least recently used dropped
  first: a viewer may ask for many resolutions. `drop_render_graphs` drops
  them all; train.step.drop_step_graphs calls it on a capacity growth, a
  budget change and a new Trainer.
* Before each replay the view's camera tensors, the background and the
  scaling modifier (a 0-d tensor in the graph) are copied into the graph's
  bound buffers, in stream order. A replay overwrites the graph's outputs,
  so the caller gets copies.
* A capture or replay error propagates: nothing falls back to eager
  dispatch on the card.

The capture recipe (`capture_graph`) and the launch accounting
(`captures`, `replayed_launch_counts`, `executed_launches`) serve the
training step's graphs too.
"""

from __future__ import annotations

import collections
import time

import torch

from gsjax_torch.core.cameras import Camera
from gsjax_torch.image_metrics import psnr as psnr_fn
from gsjax_torch.model import PARAM_NAMES
from gsjax_torch.render import kernels
from gsjax_torch.render.api import RenderOutput, render

# Eager runs of a graph's body before its capture (torch's whole-network
# capture recipe): they build the kernels, start autograd's device threads
# and fill the allocator's cache.
WARMUP_RUNS = 2
# Render graphs kept live at once.
RENDER_GRAPH_CAP = 4
# Views one series of an EvalGraph's replays evaluates (its buffers' rows).
EVAL_VIEWS = 256
CAMERA_TENSORS = ("view", "full_proj", "cam_center", "tan_fovx", "tan_fovy")

# Kernel launches made by graph replays. render/kernels.py counts launches
# on the host, where a wrapper calls its kernel; a capture records each
# such launch once into the graph (counted there, though a capture runs
# nothing) and a replay repeats them, so the launches of replays are the
# capture's count times the replays.
replayed_launch_counts = {name: 0 for name in kernels.KERNEL_NAMES}
# One record per capture: what it captured, its key's sizes, warm-up and
# capture ms, the bytes its memory pool took and the launches it recorded.
captures: list[dict] = []

_GRAPHS: collections.OrderedDict[tuple, object] = collections.OrderedDict()


def reset_graph_counts() -> None:
    for name in replayed_launch_counts:
        replayed_launch_counts[name] = 0
    captures.clear()


def executed_launches() -> dict[str, int]:
    """Kernel launches executed on the card since the counts were reset:
    the host's count, less what captures recorded, plus the replays'."""
    return {k: kernels.launch_counts[k] + replayed_launch_counts[k]
            - sum(c["launches"][k] for c in captures) for k in kernels.KERNEL_NAMES}


def count_replays(launches: dict[str, int], replays: int) -> None:
    for name, n in launches.items():
        replayed_launch_counts[name] += n * replays


def uses_graphs(device: torch.device) -> bool:
    """Whether work on `device` runs as replays of captured graphs: on a
    CUDA device; on the CPU it runs eagerly."""
    return device.type == "cuda"


def capture_graph(body, device: torch.device, record: dict, warm_up=None, generators=()):
    """Capture body() once as a torch.cuda.CUDAGraph, torch's whole-network
    recipe: warm_up() (by default WARMUP_RUNS runs of body) eagerly on a
    side stream first, then the capture, which runs nothing. Appends
    `record` with the warm-up and capture ms, the bytes the graph's memory
    pool took and the launches it recorded to `captures`. Returns (graph,
    {kernel: launches per replay}). A capture error propagates.

    `generators`: the CUDA generators body draws from other than the
    device's default (which every capture registers): each is registered
    with the graph, so every replay draws at the generator's offset then
    and advances it, as an eager run of body would."""
    t0 = time.perf_counter()
    side = torch.cuda.Stream(device=device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        if warm_up is None:
            for _ in range(WARMUP_RUNS):
                body()
        else:
            warm_up()
    torch.cuda.current_stream(device).wait_stream(side)
    torch.cuda.synchronize(device)
    warmup_ms = (time.perf_counter() - t0) * 1e3

    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(device)
    before = dict(kernels.launch_counts)
    t0 = time.perf_counter()
    graph = torch.cuda.CUDAGraph()
    for g in generators:
        graph.register_generator_state(g)
    with torch.cuda.graph(graph):
        body()
    torch.cuda.synchronize(device)
    capture_ms = (time.perf_counter() - t0) * 1e3
    launches = {k: kernels.launch_counts[k] - before[k] for k in kernels.KERNEL_NAMES}
    captures.append({
        **record, "warmup_ms": warmup_ms, "capture_ms": capture_ms,
        "pool_bytes": torch.cuda.memory_reserved(device) - reserved,
        "launches": dict(launches),
    })
    return graph, launches


# --- the registry -------------------------------------------------------------------


def drop_render_graphs() -> None:
    """Forget every captured render (and free its memory pool), as gsjax
    drops its compiled renders."""
    _GRAPHS.clear()


def _bound(params, alive) -> tuple:
    """The capacity and the addresses of the scene tensors a graph reads."""
    ptrs = tuple(getattr(params, k).data_ptr() for k in PARAM_NAMES)
    return (params.capacity, *ptrs, 0 if alive is None else alive.data_ptr())


def _registered(key: tuple, make):
    """The graph under `key` (whose last element is its _bound tuple), made
    by make() on first use: capturing for other scene tensors drops the
    graphs bound to the old ones, and the least recently used go past
    RENDER_GRAPH_CAP."""
    graph = _GRAPHS.get(key)
    if graph is not None:
        _GRAPHS.move_to_end(key)
        return graph
    for k in [k for k in _GRAPHS if k[-1] != key[-1]]:
        del _GRAPHS[k]
    while len(_GRAPHS) >= RENDER_GRAPH_CAP:
        _GRAPHS.popitem(last=False)
    graph = _GRAPHS[key] = make()
    return graph


def render_key(params, alive, width: int, height: int, *, active_sh_degree: int,
               cfg, convert_shs_outside: bool, compute_cov3d_outside: bool) -> tuple:
    """gsjax's render_view key (gsjax/train/trainer.py:237-240: width,
    height, SH degree, the SH and covariance paths, fast, the raster
    configuration), then the bound scene tensors."""
    return (width, height, active_sh_degree, convert_shs_outside,
            compute_cov3d_outside, cfg.fast_fwd, cfg, _bound(params, alive))


# --- one render -----------------------------------------------------------------------


class RenderGraph:
    """render(...) under no_grad captured once as a CUDA graph, bound to
    one scene's tensors (the parameters, alive) and one key. Each call
    copies the view's camera tensors, the background and the scaling
    modifier into the graph's buffers, replays, and returns copies of the
    outputs."""

    def __init__(self, params, alive, camera: Camera, *, active_sh_degree: int, cfg,
                 convert_shs_outside: bool, compute_cov3d_outside: bool):
        dev = params.device
        self.cam = {k: getattr(camera, k).detach().clone() for k in CAMERA_TENSORS}
        self.bg = torch.zeros(3, dtype=torch.float32, device=dev)
        self.scaling = torch.ones((), dtype=torch.float32, device=dev)
        bound = Camera(**self.cam, width=camera.width, height=camera.height)

        def body():
            with torch.no_grad():
                self.out = render(
                    params, bound, active_sh_degree=active_sh_degree,
                    bg_color=self.bg, cfg=cfg, scaling_modifier=self.scaling,
                    alive=alive, convert_shs_outside=convert_shs_outside,
                    compute_cov3d_outside=compute_cov3d_outside,
                )

        self.graph, self.launches = capture_graph(body, dev, dict(
            graph="render", width=camera.width, height=camera.height,
            capacity=params.capacity, active_sh_degree=active_sh_degree,
            fast_fwd=cfg.fast_fwd, budgets=[cfg.max_instances, cfg.max_rows]))

    def __call__(self, camera: Camera, bg_color: torch.Tensor,
                 scaling_modifier: float = 1.0) -> RenderOutput:
        with torch.no_grad():
            for k, buf in self.cam.items():
                buf.copy_(getattr(camera, k))
            self.bg.copy_(bg_color)
            self.scaling.fill_(scaling_modifier)
        self.graph.replay()
        count_replays(self.launches, 1)
        out = self.out
        return RenderOutput(image=out.image.clone(), radii=out.radii.clone(),
                            num_instances=out.num_instances.clone(),
                            num_rows=out.num_rows.clone())


def render_replayed(params, camera: Camera, *, active_sh_degree: int,
                    bg_color: torch.Tensor, cfg, scaling_modifier: float = 1.0,
                    alive: torch.Tensor | None = None,
                    convert_shs_outside: bool = False,
                    compute_cov3d_outside: bool = False) -> RenderOutput:
    """render() without gradients (no override colour, no mean2d offset): on
    a CUDA device a replay of the captured graph of its key, on the CPU
    render() itself. The outputs belong to the caller."""
    kw = dict(active_sh_degree=active_sh_degree, cfg=cfg,
              convert_shs_outside=convert_shs_outside,
              compute_cov3d_outside=compute_cov3d_outside)
    if not uses_graphs(params.device):
        with torch.no_grad():
            return render(params, camera, bg_color=bg_color,
                          scaling_modifier=scaling_modifier, alive=alive, **kw)
    if camera.device != params.device:
        raise ValueError(f"the camera lies on {camera.device}, the scene on {params.device}")
    key = render_key(params, alive, camera.width, camera.height, **kw)
    graph = _registered(key, lambda: RenderGraph(params, alive, camera, **kw))
    return graph(camera, bg_color, scaling_modifier)


# --- the held-out evaluation ------------------------------------------------------------


def _eval_terms(img: torch.Tensor, gt: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The L1 and PSNR of a render clipped to [0, 1] against its ground
    truth (gsjax/train/trainer.py:849-855)."""
    img = torch.clamp(img, 0.0, 1.0)
    return torch.mean(torch.abs(img - gt)), psnr_fn(img, gt).mean()


class EvalGraph:
    """One view's held-out evaluation captured once as a CUDA graph, bound
    to one scene's tensors and one CameraBank: the view at row `cursor` of
    the index buffer is rendered under no_grad, clipped, and its L1 and
    PSNR written into row `cursor` of the result buffers, and the cursor
    moves on, all on the device (gsjax's `_eval_bank_fn`, a jitted
    lax.scan over the views)."""

    def __init__(self, params, alive, bank, *, active_sh_degree: int, cfg,
                 convert_shs_outside: bool, compute_cov3d_outside: bool):
        dev = params.device
        self.idx = torch.zeros(EVAL_VIEWS, dtype=torch.int64, device=dev)
        self.cursor = torch.zeros((), dtype=torch.int64, device=dev)
        self.bg = torch.zeros(3, dtype=torch.float32, device=dev)
        self.result = torch.zeros((2, EVAL_VIEWS), dtype=torch.float32, device=dev)

        def body():
            with torch.no_grad():
                at = self.cursor.view(1)
                cam, gt = bank.pick(self.idx.index_select(0, at).squeeze(0))
                img = render(
                    params, cam, active_sh_degree=active_sh_degree, bg_color=self.bg,
                    cfg=cfg, alive=alive, convert_shs_outside=convert_shs_outside,
                    compute_cov3d_outside=compute_cov3d_outside,
                ).image
                self.result.index_copy_(1, at, torch.stack(_eval_terms(img, gt))[:, None])
                self.cursor.add_(1)

        self.graph, self.launches = capture_graph(body, dev, dict(
            graph="eval", width=bank.width, height=bank.height, views=bank.count,
            capacity=params.capacity, active_sh_degree=active_sh_degree,
            budgets=[cfg.max_instances, cfg.max_rows]))

    def __call__(self, idxs: list[int], bg_color: torch.Tensor) -> torch.Tensor:
        """(2, len(idxs)): the L1 and PSNR of each view, on the device."""
        parts = []
        with torch.no_grad():
            self.bg.copy_(bg_color)
            for off in range(0, len(idxs), EVAL_VIEWS):
                chunk = idxs[off:off + EVAL_VIEWS]
                self.idx[:len(chunk)].copy_(torch.as_tensor(chunk, dtype=torch.int64))
                self.cursor.zero_()
                for _ in chunk:
                    self.graph.replay()
                parts.append(self.result[:, :len(chunk)].clone())
        count_replays(self.launches, len(idxs))
        return torch.cat(parts, dim=1)


def eval_views(params, alive, bank, idxs: list[int], *, bg_color: torch.Tensor,
               active_sh_degree: int, cfg, convert_shs_outside: bool = False,
               compute_cov3d_outside: bool = False) -> torch.Tensor:
    """(2, len(idxs)) on the bank's device: the L1 and PSNR of each view
    idxs[j] of `bank` rendered without gradients and clipped to [0, 1],
    against its ground truth. On a CUDA device replays of the EvalGraph of
    the key (gsjax's `_eval_bank_fn` key: "eval", the bank's resolution,
    SH degree, the SH and covariance paths, the raster configuration;
    then the bank's and the scene's tensors); on the CPU eagerly."""
    kw = dict(active_sh_degree=active_sh_degree, cfg=cfg,
              convert_shs_outside=convert_shs_outside,
              compute_cov3d_outside=compute_cov3d_outside)
    if not uses_graphs(params.device):
        rows = []
        with torch.no_grad():
            for i in idxs:
                cam, gt = bank.pick(torch.tensor(i, device=params.device))
                img = render(params, cam, bg_color=bg_color, alive=alive, **kw).image
                rows.append(torch.stack(_eval_terms(img, gt)))
        return torch.stack(rows, dim=1)
    bank_ptrs = tuple(t.data_ptr() for t in (bank.views, bank.full_projs, bank.centers,
                                            bank.tan_fovx, bank.tan_fovy, bank.gt_rgb,
                                            bank.alpha))
    key = ("eval", bank.width, bank.height, active_sh_degree, convert_shs_outside,
           compute_cov3d_outside, cfg, bank_ptrs, _bound(params, alive))
    graph = _registered(key, lambda: EvalGraph(params, alive, bank, **kw))
    return graph(list(idxs), bg_color)
