"""3DGS-MCMC density control over the port's fixed-capacity buffers.

3D Gaussian Splatting as Markov Chain Monte Carlo (Kheradmand et al.,
NeurIPS 2024, arXiv:2404.09591; github.com/ubc-vision/3dgs-mcmc, and
gsplat's MCMCStrategy) keeps the Gaussians, the rasterizer and the
photometric loss of 3DGS and replaces the training dynamics
(o = sigmoid(opacity logit), s = exp(log-scale)):

* the loss gains opacity_reg * mean(o) + scale_reg * mean(s), the means
  over the alive slots (s over all three axes): `regularizers`;
* after Adam's update on every step, SGLD position noise
  xyz += Sigma eps sigma_k(1 - o) noise_lr lr_xyz, Sigma = (R S)(R S)^T from
  the normalized quaternion and s, eps ~ N(0, I3) drawn over every slot,
  sigma_k(x) = 1 / (1 + exp(-100 (x - 0.995))): `add_position_noise_`;
* at the densify boundaries, relocation and growth
  (`relocate_and_grow`): the alive slots with o <= 0.005 are dead; as many
  sources as dead slots are drawn with replacement from the other alive
  slots, weighted by o; a source drawn c times takes n = c + 1 (clamped to
  [1, 51]), o' = 1 - (1 - o)^(1/n) and s' = s o / sum_{j=1..n}
  sum_{k<j} C(j-1, k) (-1)^k o'^(k+1) / sqrt(k+1), o' then clamped to
  [0.005, 1 - eps_f32]; each dead slot takes a copy of its source with
  (o', s'), and Adam's two moments are zeroed at the sources (3dgs-mcmc's
  relocate_gs). Then growth adds min(cap_max, floor(1.05 N)) - N Gaussians
  (none at or past the cap), drawn the same way over all alive slots, into
  free slots with zeroed moments (add_new_gs).

Port specifics:
* Growth fills free slots of the fixed capacity (the Trainer sizes it to
  hold cap_max once); nothing is reallocated.
* The sum over (j, k) is summed over k with C(n, k+1) = sum_{j=k+1..n}
  C(j-1, k) (the same terms, grouped), in float32.
* Relocation and growth run between windows, on the state's tensors in
  place (a captured step keeps its addresses). The draws are
  torch.multinomial's, from the caller's generator; the counts are read
  to the host once.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from gsjax_torch.core.transforms import build_rotation, inverse_sigmoid
from gsjax_torch.model import PARAM_NAMES, GaussianParams

DEAD_OPACITY = 0.005
GROWTH = 1.05
N_MAX = 51
GATE_K = 100.0
GATE_X0 = 0.995


# --- inside the step ------------------------------------------------------------------


def regularizers(params: GaussianParams, alive: torch.Tensor, opacity_reg: float,
                 scale_reg: float) -> torch.Tensor:
    """opacity_reg * mean(o) + scale_reg * mean(s) over the alive slots, s
    over its three axes. The dead slots' raw values are masked before the
    activations, so nothing of them reaches a gradient."""
    w = alive.to(torch.float32)
    n = torch.clamp(torch.sum(w), min=1.0)
    o = torch.sigmoid(torch.where(alive, params.opacity[:, 0], 0.0))
    s = torch.exp(torch.where(alive[:, None], params.scaling, 0.0))
    return (opacity_reg * torch.sum(o * w) / n
            + scale_reg * torch.sum(s * w[:, None]) / (3.0 * n))


def gate(opacity: torch.Tensor) -> torch.Tensor:
    """sigma_k(1 - o): about 1 for o near 0, vanishing above o ~ 0.05."""
    return 1.0 / (1.0 + torch.exp(-GATE_K * ((1.0 - opacity) - GATE_X0)))


def position_noise(params: GaussianParams, alive: torch.Tensor, xyz_lr: torch.Tensor,
                   noise_lr: float, generator: torch.Generator | None,
                   eps: torch.Tensor | None = None) -> torch.Tensor:
    """[C, 3] SGLD noise Sigma eps sigma_k(1 - o) noise_lr lr_xyz, zero at the
    dead slots; eps is one (C, 3) standard normal draw from `generator` (the
    device's default when None) unless given."""
    p = params
    if eps is None:
        eps = torch.randn((p.capacity, 3), generator=generator, device=p.device)
    scale = gate(torch.sigmoid(p.opacity[:, 0])) * noise_lr * xyz_lr
    rs = build_rotation(p.rotation) * torch.exp(p.scaling)[:, None, :]  # R S
    # Sigma eps = (R S) ((R S)^T eps), as broadcast multiply-sums: IEEE
    # float32 on every device, no TF32 product.
    t = (rs * eps[:, :, None]).sum(dim=1)
    v = (rs * t[:, None, :]).sum(dim=2)
    return torch.where(alive[:, None], v * scale[:, None], 0.0)


@torch.no_grad()
def add_position_noise_(params: GaussianParams, alive: torch.Tensor, xyz_lr: torch.Tensor,
                        noise_lr: float, generator: torch.Generator | None) -> None:
    """xyz += position_noise(...), in place (after Adam's update)."""
    params.xyz.add_(position_noise(params, alive, xyz_lr, noise_lr, generator))


# --- at the densify boundaries --------------------------------------------------------


@dataclasses.dataclass
class Picks:
    """One relocation's and growth's draws ([] int64 slot indices): dead
    slot `dead[i]` took a copy of `dead_src[i]`, free slot `new[i]` one of
    `new_src[i]`."""

    dead: torch.Tensor
    dead_src: torch.Tensor
    new: torch.Tensor
    new_src: torch.Tensor


def _binomials(device) -> torch.Tensor:
    """[N_MAX + 1, N_MAX + 1] float32 C(n, k) (0 for k > n)."""
    return torch.tensor([[math.comb(n, k) for k in range(N_MAX + 1)]
                         for n in range(N_MAX + 1)], dtype=torch.float32, device=device)


def relocation_update(opacity: torch.Tensor, scaling: torch.Tensor, n: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """(o', s') of sources with activated opacity [D], activated scaling
    [D, 3] and multiplicity n [D] (int, in [1, N_MAX]); o' clamped to
    [DEAD_OPACITY, 1 - eps_f32] after s' is formed, as 3dgs-mcmc clamps it."""
    nf = n.to(torch.float32)
    o_new = 1.0 - torch.pow(1.0 - opacity, 1.0 / nf)
    k = torch.arange(N_MAX, device=opacity.device)
    coef = _binomials(opacity.device)[n[:, None].long(), k[None, :] + 1]  # C(n, k+1)
    sign = 1.0 - 2.0 * (k % 2).to(torch.float32)
    terms = coef * sign / torch.sqrt((k + 1).to(torch.float32)) * torch.pow(
        o_new[:, None], (k + 1).to(torch.float32))
    s_new = (opacity / terms.sum(dim=1))[:, None] * scaling
    o_new = torch.clamp(o_new, DEAD_OPACITY, 1.0 - torch.finfo(torch.float32).eps)
    return o_new, s_new


def _indices(mask: torch.Tensor, count: int) -> torch.Tensor:
    """[count] int64 indices of mask's first `count` set entries in order,
    without a host sync (count, at most the mask's popcount, is known)."""
    pos = torch.cumsum(mask.to(torch.int64), 0) - 1
    out = torch.empty(count + 1, dtype=torch.int64, device=mask.device)
    slot = torch.arange(mask.shape[0], dtype=torch.int64, device=mask.device)
    # Every other slot lands on the spare last entry.
    out.scatter_(0, torch.where(mask & (pos < count), pos, count), slot)
    return out[:count]


def _draw(weights: torch.Tensor, count: int, generator) -> torch.Tensor:
    if count == 0:
        return torch.zeros(0, dtype=torch.int64, device=weights.device)
    return torch.multinomial(weights, count, replacement=True, generator=generator)


@torch.no_grad()
def _apply_picks(params: GaussianParams, opt, dst: torch.Tensor, src: torch.Tensor,
                 zero_dst_moments: bool) -> None:
    """Copy each source row into its destination with (o', s') at both,
    zero Adam's moments at the sources (and at the destinations for growth),
    in place."""
    if src.numel() == 0:
        return
    counts = torch.bincount(src, minlength=params.capacity)
    n = torch.clamp(counts[src] + 1, 1, N_MAX)
    o_new, s_new = relocation_update(torch.sigmoid(params.opacity[src, 0]),
                                     torch.exp(params.scaling[src]), n)
    for k in PARAM_NAMES:
        p = getattr(params, k)
        p.index_copy_(0, dst, p[src])
    raw_o, raw_s = inverse_sigmoid(o_new)[:, None], torch.log(s_new)
    for idx in (dst, src):
        params.opacity.index_put_((idx,), raw_o)
        params.scaling.index_put_((idx,), raw_s)
    for tree in (opt.mu, opt.nu):
        for m in tree.values():
            m.index_fill_(0, src, 0.0)
            if zero_dst_moments:
                m.index_fill_(0, dst, 0.0)


@torch.no_grad()
def relocate_and_grow(params: GaussianParams, aux, opt, *, cap_max: int,
                      generator: torch.Generator | None = None,
                      picks: Picks | None = None) -> tuple[Picks, dict[str, int]]:
    """One relocation, then growth, on the state's tensors in place.

    picks: the draws to apply instead of drawing (tests; the benchmark's
      reference applies the program's). Returns the picks applied and
      {"n_dead", "n_added", "n_alive"} (n_alive after growth)."""
    alive = aux.alive
    dead = alive & (torch.sigmoid(params.opacity[:, 0]) <= DEAD_OPACITY)
    n_dead, n_alive = (int(v) for v in torch.stack([dead.sum(), alive.sum()]).tolist())
    if picks is None:
        dead_idx = _indices(dead, n_dead)
        sources = alive & ~dead
        if n_alive == n_dead:  # nothing to draw from
            dead_idx = dead_idx[:0]
        dead_src = _draw(torch.where(sources, torch.sigmoid(params.opacity[:, 0]), 0.0),
                         dead_idx.numel(), generator)
    else:
        dead_idx, dead_src = picks.dead, picks.dead_src
    _apply_picks(params, opt, dead_idx, dead_src, zero_dst_moments=False)

    n_new = max(0, min(cap_max, int(GROWTH * n_alive)) - n_alive)
    n_new = min(n_new, params.capacity - n_alive)
    if picks is None:
        new_idx = _indices(~alive, n_new)
        new_src = _draw(torch.where(alive, torch.sigmoid(params.opacity[:, 0]), 0.0),
                        n_new, generator)
    else:
        new_idx, new_src = picks.new, picks.new_src
    _apply_picks(params, opt, new_idx, new_src, zero_dst_moments=True)
    alive.index_fill_(0, new_idx, True)
    return (Picks(dead_idx, dead_src, new_idx, new_src),
            {"n_dead": n_dead, "n_added": int(new_idx.numel()),
             "n_alive": n_alive + int(new_idx.numel())})


def capacity_for(cap_max: int) -> int:
    """The capacity that holds cap_max Gaussians by the Trainer's growth
    rule: the smallest power of two (at least 1024) of which cap_max is at
    most three quarters."""
    cap = 1024
    while cap_max > 0.75 * cap:
        cap *= 2
    return cap
