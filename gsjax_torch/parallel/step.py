"""Mesh-sharded training step: camera data parallelism x tile-slab
parallelism (gsjax/parallel/step.py).

Semantics against the single-device step (train/step.py): the batch of
B = the mesh's "data" size cameras is averaged; with B = 1 this is the
reference's one camera per iteration (reference: train.py:76-128). The
densification statistics accumulate over every camera of the batch (sums
for the gradient norms and counts, max for the radii).

Loss sharding: each rank computes the loss on its own slab, O(slab) work.
L1 is a masked local sum; SSIM needs a 5-row halo (11x11 window) from each
slab neighbour, exchanged with point-to-point sends (edge ranks receive
zeros, which is the reference's zero-padded conv boundary,
utils/loss_utils.py:39-41).

Gradient algebra: each rank differentiates its own local objective
  obj_r = ((1-λ)·Σ|err| − λ·Σ ssim_map) / (C·H·W)   over its slab rows,
so the loss is Σ_tile obj_r + λ and the full gradient is the plain sum of
the per-rank gradients. No collective sits inside the differentiated
scalar: the all-reduces run on gradients that autograd.grad returned. The
halo exchange is an autograd.Function whose backward sends each halo's
cotangent back to the rank that produced those rows (the transpose of
gsjax's ppermute).

The window (make_sharded_train_steps) replays one captured CUDA graph of
the step on a CUDA mesh, the collectives inside it; on a CPU mesh it is a
Python loop of the step.

Two-stage backward: the local objective is differentiated with respect
to the raster fields (mean_pix 2, conic 3, rgb 3, opacity 1: 9 floats per
Gaussian), those are summed over "tile" as one [N, 9] tensor, and the sum
is pushed through the preprocess graph once. The parameter gradients and
the statistics are then summed over "data" in one flat buffer. Every rank
then runs the same Adam, so the replicas stay equal.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from gsjax_torch.config import OptimizationConfig, RasterConfig
from gsjax_torch.core.cameras import Camera
from gsjax_torch.model import PARAM_NAMES, GaussianAux
from gsjax_torch.parallel.mesh import dim_size
from gsjax_torch.parallel.render import composite_slab, slab_rows
from gsjax_torch.render.preprocess import preprocess
from gsjax_torch.train.loss import ssim_map
from gsjax_torch.train.optimizer import adam_update, make_lr_tree
from gsjax_torch.train.step import (
    CapturedStep,
    StepMetrics,
    TrainState,
    register_graph,
    stack_metrics,
    state_tensors,
)

HALO = 5  # 11x11 SSIM window: window_size // 2 rows each side


def _swap(to_prev, to_next, prev, nxt, group):
    """Send to_prev to rank prev and to_next to rank nxt (global ranks, None
    at an end of the tile dimension); returns (from_prev, from_next), what
    those ranks sent here, zeros where there is no neighbour."""
    from_prev = to_next.new_zeros(to_next.shape)
    from_next = to_prev.new_zeros(to_prev.shape)
    ops = []
    if prev is not None:
        ops += [dist.P2POp(dist.isend, to_prev.contiguous(), prev, group),
                dist.P2POp(dist.irecv, from_prev, prev, group)]
    if nxt is not None:
        ops += [dist.P2POp(dist.isend, to_next.contiguous(), nxt, group),
                dist.P2POp(dist.irecv, from_next, nxt, group)]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return from_prev, from_next


class _HaloExchange(torch.autograd.Function):
    """img [C, S, W] -> (up, down) [C, HALO, W]: the last HALO rows of the
    previous tile rank's slab and the first HALO rows of the next one's
    (zeros at the ends). Backward: each halo's cotangent goes back to the
    rank whose rows it came from and is added into those rows."""

    @staticmethod
    def forward(ctx, img, prev, nxt, group):
        ctx.links = (prev, nxt, group)
        ctx.rows = img.shape[1]
        return _swap(img[:, :HALO], img[:, -HALO:], prev, nxt, group)

    @staticmethod
    def backward(ctx, g_up, g_down):
        prev, nxt, group = ctx.links
        # My up halo came from prev's last rows, my down halo from nxt's
        # first rows: each cotangent goes back there, and the neighbours'
        # cotangents of my own rows come here.
        from_prev, from_next = _swap(g_up, g_down, prev, nxt, group)
        c, _, w = from_prev.shape
        g = from_prev.new_zeros((c, ctx.rows, w))
        g[:, :HALO] += from_prev
        g[:, -HALO:] += from_next
        return g, None, None, None


def halo_exchange(img, prev, nxt, group):
    """(up, down) halos of a [C, S, W] slab; differentiable."""
    if prev is None and nxt is None:
        z = img.new_zeros((img.shape[0], HALO, img.shape[2]))
        return z, z
    return _HaloExchange.apply(img, prev, nxt, group)


def make_sharded_train_step(
    mesh,
    *,
    height: int,
    width: int,
    active_sh_degree: int,
    opt_cfg: OptimizationConfig,
    raster_cfg: RasterConfig,
    spatial_lr_scale: float,
):
    """Build the sharded train step for this rank of `mesh`.

    Returns step(state, views, projs, centers, tanx, tany, gt, bg,
    sh_degree=None) -> (state, metrics): views/projs [B,4,4], centers
    [B,3], tanx/tany [B], gt [B,3,H,W] (the whole batch on every rank) with
    B = the mesh's "data" size, bg [3]. Rank (d, t) trains on camera d over
    its slab t. Every rank calls it with the same arguments and the same
    state; the state is updated in place (Adam) and returned.
    `sh_degree` defaults to active_sh_degree. step.one_step is the same
    function; step.sharded_grads(params, alive, views, projs, centers,
    tanx, tany, gt, bg, sh_degree=None) returns the reduced gradients
    before Adam: ({name: grad}, accum delta [N], denom delta [N], radii max
    [N], loss, l1, [num_instances, num_rows] max over the mesh).
    """
    n_tile = dim_size(mesh, "tile")
    n_data = dim_size(mesh, "data")
    d_idx = mesh.get_local_rank("data")
    t_idx = mesh.get_local_rank("tile")
    tile_group = mesh.get_group("tile")
    data_group = mesh.get_group("data")
    prev = int(mesh.mesh[d_idx, t_idx - 1]) if t_idx > 0 else None
    nxt = int(mesh.mesh[d_idx, t_idx + 1]) if t_idx + 1 < n_tile else None
    ts = raster_cfg.th
    rows = slab_rows(height, n_tile, ts)
    slab_px = rows * ts
    if slab_px < HALO:
        raise ValueError(f"a slab of {slab_px} pixel rows is shorter than the "
                         f"SSIM halo ({HALO})")
    py0 = float(t_idx * slab_px)
    lam = opt_cfg.lambda_dssim
    npix = 3.0 * height * width

    def local_obj(mean_pix, conic, rgb, opacity, depth, ext, qmax, gt, bg):
        """This rank's objective over its slab rows; the full-image loss is
        the sum over the tile ranks plus lambda_dssim."""
        color, t, counts = composite_slab(
            mean_pix, conic, rgb, opacity, depth, ext, qmax,
            height=height, width=width, cfg=raster_cfg, py0=py0, rows=rows,
        )
        img = color[:, :, :width] + t[None, :, :width] * bg[:, None, None]
        # Rows past the image (the padded tile grid of the last slab) are
        # zeroed: the full-image SSIM sees zero padding there, and zero img
        # against zero gt adds nothing to L1.
        row_ids = t_idx * slab_px + torch.arange(slab_px, device=img.device)
        row_ok = (row_ids < height).to(torch.float32)[None, :, None]
        img = img * row_ok
        # The replicated gt: this slab and its halos, zero-padded at the ends.
        gt_pad = F.pad(gt, (0, 0, HALO, n_tile * slab_px + HALO - height))
        gt_ext = gt_pad[:, t_idx * slab_px:t_idx * slab_px + slab_px + 2 * HALO]
        up, down = halo_exchange(img, prev, nxt, tile_group)
        img_ext = torch.cat([up, img, down], dim=1)
        l1_sum = torch.sum(torch.abs(img - gt_ext[:, HALO:-HALO]))
        smap = ssim_map(img_ext, gt_ext, pad_h=False)
        ssim_sum = torch.sum(smap * row_ok)
        obj = ((1.0 - lam) * l1_sum - lam * ssim_sum) / npix
        return obj, counts, l1_sum

    def sharded_grads(params, alive, views, projs, centers, tanx, tany, gt, bg,
                      sh_degree=None):
        sh = active_sh_degree if sh_degree is None else int(sh_degree)
        camera = Camera(view=views[d_idx], full_proj=projs[d_idx],
                        cam_center=centers[d_idx], tan_fovx=tanx[d_idx],
                        tan_fovy=tany[d_idx], width=width, height=height)
        cap = params.capacity
        offset = torch.zeros((cap, 2), dtype=torch.float32, device=params.device,
                             requires_grad=True)
        proj = preprocess(
            xyz=params.xyz, sh=params.get_features(), opacity=params.get_opacity(),
            scaling=params.get_scaling(), rotation=params.rotation, camera=camera,
            active_sh_degree=sh, mean2d_offset=offset, alive=alive,
        )
        # Stage 1: the slab objective's gradient in the raster fields.
        fields = (proj.mean_pix, proj.conic, proj.rgb, proj.opacity)
        cut = [f.detach().requires_grad_() for f in fields]
        obj, counts, l1_sum = local_obj(
            *cut, proj.depth.detach(), proj.ext.detach(), proj.qmax.detach(),
            gt[d_idx], bg)
        d_cut = torch.autograd.grad(obj, cut)
        # Each rank differentiated its own slab objective, so the sum over
        # "tile" is the whole image's raster cotangent.
        packed = torch.cat([d.reshape(cap, -1) for d in d_cut], dim=1)
        dist.all_reduce(packed, group=tile_group)
        widths = [d[0].numel() if d.dim() > 1 else 1 for d in d_cut]
        d_fields = [p.reshape(f.shape) for p, f in
                    zip(torch.split(packed, widths, dim=1), fields)]
        # Stage 2: once through the preprocess graph.
        leaves = [getattr(params, k) for k in PARAM_NAMES]
        *g_params, g_offset = torch.autograd.grad(
            fields, [*leaves, offset], grad_outputs=d_fields)

        # The camera batch over "data": the parameter gradients averaged,
        # the densification statistics summed (the screen gradient keeps
        # the reference's per-camera meaning), in one buffer.
        radii = proj.radius
        visible = radii > 0
        norm = torch.linalg.vector_norm(g_offset, dim=-1)
        flat = torch.cat([g.reshape(-1) for g in g_params] + [
            torch.where(visible, norm, torch.zeros_like(norm)),
            visible.to(torch.float32)])
        dist.all_reduce(flat, group=data_group)
        sizes = [g.numel() for g in g_params] + [cap, cap]
        *g_flat, accum_delta, denom_delta = torch.split(flat, sizes)
        grads = {k: (g * (1.0 / n_data)).reshape(leaf.shape)
                 for k, g, leaf in zip(PARAM_NAMES, g_flat, leaves)}
        radii_max = torch.where(visible, radii.to(torch.float32),
                                torch.zeros_like(norm))
        dist.all_reduce(radii_max, op=dist.ReduceOp.MAX, group=data_group)

        # Loss and L1 over the whole mesh (the mesh is the world): summed
        # over "tile", averaged over "data".
        sums = torch.stack([obj.detach(), l1_sum.detach()])
        dist.all_reduce(sums)
        loss = sums[0] * (1.0 / n_data) + lam
        l1 = sums[1] / npix * (1.0 / n_data)
        dist.all_reduce(counts, op=dist.ReduceOp.MAX)
        return grads, accum_delta, denom_delta, radii_max, loss, l1, counts

    def one_step(state: TrainState, views, projs, centers, tanx, tany, gt, bg,
                 sh_degree=None) -> tuple[TrainState, StepMetrics]:
        grads, accum_d, denom_d, radii_max, loss, l1, counts = sharded_grads(
            state.params, state.aux.alive, views, projs, centers, tanx, tany, gt,
            bg, sh_degree)
        aux = GaussianAux(
            alive=state.aux.alive,
            max_radii2d=torch.maximum(state.aux.max_radii2d, radii_max),
            xyz_grad_accum=state.aux.xyz_grad_accum + accum_d,
            denom=state.aux.denom + denom_d,
        )
        lr_tree = make_lr_tree(opt_cfg, spatial_lr_scale, state.step)
        opt = adam_update(grads, state.opt, state.params, lr_tree)
        new_state = TrainState(params=state.params, opt=opt, aux=aux,
                               step=state.step + 1)
        return new_state, StepMetrics(loss=loss, l1=l1, num_instances=counts[0],
                                      num_rows=counts[1])

    def step(state, views, projs, centers, tanx, tany, gt, bg, sh_degree=None):
        return one_step(state, views, projs, centers, tanx, tany, gt, bg, sh_degree)

    step.one_step = one_step
    step.sharded_grads = sharded_grads
    return step


def make_sharded_train_steps(
    mesh,
    *,
    height: int,
    width: int,
    active_sh_degree: int,
    opt_cfg: OptimizationConfig,
    raster_cfg: RasterConfig,
    spatial_lr_scale: float,
):
    """A window of sharded steps: the mesh-path twin of
    train.step.train_steps, where gsjax runs one lax.scan.

    Returns steps(state, views [W,B,4,4], projs, centers, tanx, tany,
    gt [W,B,3,H,W], bgs [W,3], sh_degree=None) -> (state, metrics stacked
    to [W]), with B = the mesh's "data" size. On a CUDA mesh the window
    replays one captured CUDA graph of `one_step` W times
    (ShardedStepGraph; the state's tensors are updated in place, and the
    returned state holds them). On a CPU mesh it is a Python loop of
    `one_step`: gloo collectives cannot be captured. Under
    torch.autograd.set_detect_anomaly, which a graph cannot capture, the
    CUDA mesh runs the loop too.
    """
    one_step = make_sharded_train_step(
        mesh, height=height, width=width, active_sh_degree=active_sh_degree,
        opt_cfg=opt_cfg, raster_cfg=raster_cfg, spatial_lr_scale=spatial_lr_scale,
    ).one_step

    def loop(state, views, projs, centers, tanx, tany, gt, bgs, sh_degree=None):
        bgs = bgs.to(state.params.device)
        metrics = []
        for k in range(views.shape[0]):
            state, m = one_step(state, views[k], projs[k], centers[k], tanx[k],
                                tany[k], gt[k], bgs[k], sh_degree)
            metrics.append(m)
        return state, stack_metrics(metrics)

    def steps(state, views, projs, centers, tanx, tany, gt, bgs, sh_degree=None):
        if mesh.device_type != "cuda" or torch.is_anomaly_enabled():
            return loop(state, views, projs, centers, tanx, tany, gt, bgs, sh_degree)
        sh = active_sh_degree if sh_degree is None else int(sh_degree)
        inputs = (views, projs, centers, tanx, tany, gt, bgs)
        key = (id(one_step), width, height, state.params.capacity, sh, views.shape[1],
               raster_cfg, opt_cfg, spatial_lr_scale,
               tuple(t.data_ptr() for t in state_tensors(state)))
        graph = register_graph(key, state, lambda: ShardedStepGraph(
            one_step, state, inputs, sh, dict(
                mesh=list(mesh.mesh.shape), width=width, height=height,
                capacity=state.params.capacity, active_sh_degree=sh,
                budgets=[raster_cfg.max_instances, raster_cfg.max_rows])))
        return graph.run(*inputs)

    steps.loop = loop
    return steps


class ShardedStepGraph(CapturedStep):
    """The sharded step (`one_step`) captured once on a CUDA (NCCL) mesh,
    bound to one state: the twin of train.step.StepGraph.

    Each replay reads one step's inputs from the graph's own buffers
    (views, projections, centres, tangents [B, ...], gt [B,3,H,W],
    background [3]) and runs the step with its collectives (the halo's
    send/receive, the [N,9] all_reduce over "tile", the flat all_reduce
    over "data", the radii, loss and counts); a window copies each step's
    inputs into those buffers (on the card, in stream order) before its
    replay. The collectives are captured on the capture stream: NCCL
    records them into the graph, and the eager warm-up steps before the
    capture have started every communicator the step uses. Every rank
    captures and replays in the same order, as it calls the eager step.
    """

    def __init__(self, one_step, state: TrainState, inputs, sh_degree: int,
                 record: dict):
        dev = state.params.device
        self.one_step, self.sh_degree = one_step, sh_degree
        # The warm-up steps read the window's first step.
        self.inputs = [x[0].to(dev, torch.float32, copy=True) for x in inputs]
        self._capture(state, record)

    def _step(self, state: TrainState) -> tuple[TrainState, StepMetrics]:
        return self.one_step(state, *self.inputs, self.sh_degree)

    def run(self, views, projs, centers, tanx, tany, gt, bgs):
        """Replay the step once per step of the window ([W, ...] inputs)."""
        w = views.shape[0]
        self.check_window(w)
        dev = self.cursor.device
        # A host-side background goes up in one copy from pinned memory,
        # without blocking (a pageable copy would wait for the card).
        if bgs.device.type == "cpu":
            bgs = torch.as_tensor(bgs, dtype=torch.float32).contiguous().pin_memory()
        window = [x.to(dev, non_blocking=True)
                  for x in (views, projs, centers, tanx, tany, gt, bgs)]

        def feed(k):
            for buf, x in zip(self.inputs, window):
                buf.copy_(x[k], non_blocking=True)

        return self._replay(w, feed)
