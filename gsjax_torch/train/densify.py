"""Adaptive density control under static shapes.

The port of `gsjax.train.densify`: the clone / split / prune with its
optimizer surgery (reference: scene/gaussian_model.py:349-407,
train.py:113-123), over fixed-capacity buffers compacted by
cumsum-scatter, as gsjax does it.

Semantics, as gsjax's:
* grads = xyz_grad_accum / denom (0 where denom is 0).
* clone: grad >= threshold AND max(scale) <= percent_dense * extent; copies
  the raw parameters; cloned slots get ZEROED Adam moments.
* split: grad >= threshold AND max(scale) > percent_dense * extent; N=2
  samples ~ Normal(0, scale) rotated into world space; new scale =
  log(scale / (0.8 * N)); originals removed; zeroed moments.
* destination layout: kept | clones | split A | split B; rows past the
  capacity are dropped and counted.
* final prune: opacity < min_opacity, plus (when max_screen_size is set)
  the world-size criterion 0.1 * extent, scaled by max(1, dist / extent)
  from `unbounded_center` when one is given. Pruning clears the alive
  mask only; compaction happens on the next densify.
* all densification stats (accum/denom/max_radii2D) reset to zero.

Torch specifics:
* The split noise is a (2, C, 3) standard normal draw from a
  torch.Generator (or injected by the caller); it cannot be gsjax's
  jax.random stream. Tests inject gsjax's own draws.
* No host sync: the counts stay [] int32 device tensors used as offsets;
  the caller reads DensifyStats.
* A dropped row goes to an extra (C+1)-th buffer row that is sliced off,
  where gsjax's scatter drops it with mode="drop".
* The activations that decide clone, split and prune (exp of the scales,
  sigmoid of the opacities, the distance to the center) are taken in
  float64 and rounded to float32: correctly rounded on any device, so the
  card and the CPU take the same decisions on the same state. gsjax takes
  them in float32, within an ulp of these.
* The results are new tensors and a new GaussianParams module; the
  inputs are not modified.
"""

from __future__ import annotations

import dataclasses

import torch

from gsjax_torch.model import (
    DEAD_OPACITY_FILL,
    DEAD_SCALING_FILL,
    PARAM_NAMES,
    GaussianAux,
    GaussianParams,
)
from gsjax_torch.core.transforms import build_rotation
from gsjax_torch.train.optimizer import AdamState

SPLIT_N = 2
SPLIT_SCALE_SHRINK = 0.8 * SPLIT_N  # reference: scene/gaussian_model.py:363


@dataclasses.dataclass
class DensifyStats:
    """Diagnostics from one densify step (all [] int32)."""

    n_alive: torch.Tensor
    n_cloned: torch.Tensor
    n_split: torch.Tensor
    n_pruned: torch.Tensor
    n_dropped: torch.Tensor  # candidates lost to capacity overflow


def add_densification_stats(
    aux: GaussianAux, radii: torch.Tensor, screen_grad: torch.Tensor
) -> GaussianAux:
    """Per-iteration stat accumulation (reference: train.py:115-116,
    scene/gaussian_model.py:405-407). radii: [C] int32 screen radii (0 =
    not visible); screen_grad: [C,2] NDC position gradient."""
    visible = radii > 0
    norm = torch.linalg.vector_norm(screen_grad, dim=-1)
    return dataclasses.replace(
        aux,
        max_radii2d=torch.where(
            visible, torch.maximum(aux.max_radii2d, radii.to(torch.float32)),
            aux.max_radii2d,
        ),
        xyz_grad_accum=aux.xyz_grad_accum
        + torch.where(visible, norm, torch.zeros_like(norm)),
        denom=aux.denom + visible.to(torch.float32),
    )


def split_noise(
    capacity: int, device: torch.device, generator: torch.Generator | None = None
) -> torch.Tensor:
    """The (2, C, 3) standard normal draws of one densify's two split
    children, as densify_and_prune draws them from `generator`."""
    return torch.randn((SPLIT_N, capacity, 3), generator=generator, device=device)


@torch.no_grad()
def densify_and_prune(
    params: GaussianParams,
    aux: GaussianAux,
    opt: AdamState,
    generator: torch.Generator | None = None,
    *,
    grad_threshold: float,
    min_opacity: float,
    extent: float,
    max_screen_size: int,
    percent_dense: float,
    unbounded_center: torch.Tensor | None = None,
    noise: torch.Tensor | None = None,
) -> tuple[GaussianParams, GaussianAux, AdamState, DensifyStats]:
    """One densify+prune pass; compacts alive Gaussians to the buffer front.

    generator: the source of the split noise (torch's default generator of
      the device when None); ignored when `noise` is given.
    max_screen_size: 0 disables the size-based prune criteria (the reference
      passes None before the first opacity reset, train.py:119).
    unbounded_center: when set ([3] scene center; skysphere mode), the
      world-size prune threshold scales with max(1, dist/extent), so a far
      shell splat that subtends the same solid angle survives. None keeps
      the reference's flat threshold (reference:
      scene/gaussian_model.py:398-401).
    noise: optional (2, C, 3) standard normal draws of the two split
      children, on the parameters' device.
    """
    cap = params.capacity
    dev = params.device
    alive = aux.alive
    grads = torch.where(
        aux.denom > 0, aux.xyz_grad_accum / torch.clamp(aux.denom, min=1.0),
        torch.zeros_like(aux.denom),
    )
    scaling = torch.exp(params.scaling.double()).float()
    max_scale = scaling.max(dim=-1).values

    hot = alive & (grads >= grad_threshold)
    small = max_scale <= percent_dense * extent
    clone_mask = hot & small
    split_mask = hot & ~small
    keep_mask = alive & ~split_mask

    # --- destination layout: [kept | clones | splitA | splitB] ------------
    def count(mask):
        return torch.sum(mask.to(torch.int32), dtype=torch.int32)

    n_keep, n_clone, n_split = count(keep_mask), count(clone_mask), count(split_mask)

    def dests(mask, offset):
        pos = torch.cumsum(mask.to(torch.int32), 0, dtype=torch.int32) - 1 + offset
        return torch.where(mask & (pos < cap), pos, cap).to(torch.int64)  # cap: dropped

    dst_keep = dests(keep_mask, 0)
    dst_clone = dests(clone_mask, n_keep)
    dst_split_a = dests(split_mask, n_keep + n_clone)
    dst_split_b = dests(split_mask, n_keep + n_clone + n_split)

    # --- split sampling (reference: scene/gaussian_model.py:358-363) ------
    if noise is None:
        noise = split_noise(cap, dev, generator)
    rot = build_rotation(params.rotation)  # [C,3,3]

    def split_xyz(normal):
        sample = normal * scaling
        # rot @ sample as a broadcast multiply-sum: IEEE float32, no TF32.
        turned = (rot[:, :, 0] * sample[:, None, 0] + rot[:, :, 1] * sample[:, None, 1]
                  + rot[:, :, 2] * sample[:, None, 2])
        return params.xyz + turned

    # Tensor divisors here and below: CUDA divides by a Python scalar as a
    # product with its reciprocal, an ulp from the CPU's quotient.
    shrink = torch.tensor(SPLIT_SCALE_SHRINK, device=dev)
    split_scaling = torch.log(torch.clamp(scaling / shrink, min=1e-20))
    sources = {k: getattr(params, k).detach() for k in PARAM_NAMES}
    split_a = dict(sources, scaling=split_scaling, xyz=split_xyz(noise[0]))
    split_b = dict(split_a, xyz=split_xyz(noise[1]))

    # Dead-slot fill values keep downstream math finite: identity rotation
    # (zero quats would NaN on normalize), tiny scale, ~zero opacity.
    fills = {"scaling": DEAD_SCALING_FILL, "opacity": DEAD_OPACITY_FILL}
    new = {}
    for k, src in sources.items():
        buf = src.new_full((cap + 1, *src.shape[1:]), fills.get(k, 0.0))
        if k == "rotation":
            buf[:, 0] = 1.0
        for rows, dst in ((src, dst_keep), (src, dst_clone),
                          (split_a[k], dst_split_a), (split_b[k], dst_split_b)):
            buf.index_copy_(0, dst, rows)
        new[k] = buf[:cap]
    new_params = GaussianParams(**new)

    # Adam moments: kept rows move with their params; all new rows zero
    # (reference optimizer surgery: scene/gaussian_model.py:273-327).
    def move_moments(tree):
        out = {}
        for k, m in tree.items():
            buf = m.new_zeros((cap + 1, *m.shape[1:]))
            buf.index_copy_(0, dst_keep, m)
            out[k] = buf[:cap]
        return out

    new_opt = AdamState(count=opt.count, mu=move_moments(opt.mu), nu=move_moments(opt.nu))

    total = n_keep + n_clone + 2 * n_split
    slot = torch.arange(cap, dtype=torch.int32, device=dev)
    new_alive = slot < torch.clamp(total, max=cap)
    n_dropped = torch.clamp(total - cap, min=0)

    # --- final prune (reference: scene/gaussian_model.py:389-401) ---------
    new_opacity = torch.sigmoid(new["opacity"][:, 0].double()).float()
    new_max_scale = torch.exp(new["scaling"].double()).float().max(dim=-1).values
    prune = new_opacity < min_opacity
    if max_screen_size:
        # max_radii2D is zeroed by the postfix in the reference, so the
        # screen-size test there never fires; only the world-size test does.
        ws_threshold = 0.1 * extent
        if unbounded_center is not None:
            dist = torch.linalg.vector_norm(
                (new["xyz"] - unbounded_center[None, :]).double(), dim=-1).float()
            ws_threshold = ws_threshold * torch.clamp(
                dist / torch.tensor(extent, device=dev), min=1.0)
        prune = prune | (new_max_scale > ws_threshold)
    prune = prune & new_alive
    n_pruned = count(prune)
    new_alive = new_alive & ~prune

    zeros = torch.zeros(cap, dtype=torch.float32, device=dev)
    new_aux = GaussianAux(
        alive=new_alive, max_radii2d=zeros, xyz_grad_accum=zeros.clone(),
        denom=zeros.clone(),
    )
    stats = DensifyStats(
        n_alive=count(new_alive),
        n_cloned=n_clone,
        n_split=n_split,
        n_pruned=n_pruned,
        n_dropped=n_dropped,
    )
    return new_params, new_aux, new_opt, stats


@torch.no_grad()
def reset_opacity(
    params: GaussianParams, opt: AdamState, max_opacity: float = 0.01
) -> tuple[GaussianParams, AdamState]:
    """Clamp opacity to <= max_opacity and zero its Adam moments
    (reference: scene/gaussian_model.py:210-213, 258-271). Returns a new
    module holding the other parameters' tensors."""
    cur = torch.sigmoid(params.opacity)
    new = torch.clamp(cur, max=max_opacity)
    new_raw = torch.log(new / (1.0 - new))
    fields = {k: getattr(params, k).detach() for k in PARAM_NAMES}
    fields["opacity"] = new_raw
    return (
        GaussianParams(**fields),
        AdamState(
            count=opt.count,
            mu=dict(opt.mu, opacity=torch.zeros_like(opt.mu["opacity"])),
            nu=dict(opt.nu, opacity=torch.zeros_like(opt.nu["opacity"])),
        ),
    )
