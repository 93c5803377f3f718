"""Plain 3DGS-MCMC training (Kheradmand et al., NeurIPS 2024,
arXiv:2404.09591; github.com/ubc-vision/3dgs-mcmc train.py and
scene/gaussian_model.py): one step (L1 + D-SSIM plus the opacity and
scale regularizers, its gradient through the plain render, Adam, then the
SGLD position noise) and one relocation and growth given the program's
draws. Plain PyTorch in float32, TF32 off unless the caller's `precision`
allows it; it imports nothing of the program under test, nor JAX.

The state holds the alive Gaussians only, as the published code does:
{params, mu, nu: {name: [n, ...]}, count, step: int}. o = sigmoid(opacity
logit), s = exp(log-scale).

* Noise: eps is the first n rows of one (capacity, 3) standard normal draw
  from the generator handed in (seeded and offset as the program's was
  before the step), times sigma_k(1 - o) noise_lr lr_xyz, then
  Sigma = (R S)(R S)^T applied, xyz += the result.
* Relocation takes the program's draws (multinomial picks cannot be held
  bit for bit between two sums of millions of weights) and checks them:
  the dead slots are exactly the rows with o <= 0.005, every source a
  row that is not dead; growth adds min(cap_max, floor(1.05 n)) - n rows
  (at most what the capacity leaves) at rows n, n + 1, ... from alive
  sources. n of a source is counted here from the picks. A draw that
  breaks any of this raises InvalidPicks.
"""

from __future__ import annotations

import math

import torch

from gsbench.reference import render as ref_render
from gsbench.reference import train as ref_train

DEAD_OPACITY = 0.005
GROWTH = 1.05
N_MAX = 51
NAMES = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity")


class InvalidPicks(ValueError):
    """The program's relocation or growth draws are not ones the method
    can make from this state."""


def regularizers(params: dict, opt: dict) -> torch.Tensor:
    """opacity_reg mean(o) + scale_reg mean(s) (3dgs-mcmc train.py)."""
    return (opt["opacity_reg"] * torch.sigmoid(params["opacity"]).mean()
            + opt["scale_reg"] * torch.exp(params["scaling"]).mean())


def noise(params: dict, lr_xyz: float, noise_lr: float, generator: torch.Generator,
          capacity: int) -> torch.Tensor:
    """[n, 3] position noise (3dgs-mcmc train.py, after optimizer.step())."""
    n = params["xyz"].shape[0]
    eps = torch.randn((capacity, 3), generator=generator, device=params["xyz"].device)[:n]
    x = 1.0 - torch.sigmoid(params["opacity"])
    gate = 1.0 / (1.0 + torch.exp(-100.0 * (x - 0.995)))
    cov = ref_render.covariance3d(params["scaling"], params["rotation"])
    return torch.bmm(cov, (eps * gate * noise_lr * lr_xyz)[:, :, None])[:, :, 0]


def step(state: dict, cam: ref_render.Cam, gt: torch.Tensor, bg: torch.Tensor, degree: int,
         opt: dict, spatial_lr_scale: float, generator: torch.Generator, capacity: int,
         regularize: bool = True) -> tuple[float, dict]:
    """One MCMC step on one view, state updated in place. Returns (loss,
    gradients). regularize=False leaves the regularizers out (a fault the
    output check must catch)."""
    params = {k: v.detach().requires_grad_(True) for k, v in state["params"].items()}
    frame = ref_render.render(params, cam, bg, degree)
    image = frame.image.requires_grad_(True)
    loss = ref_train.loss_of(image, gt, opt["lambda_dssim"])
    (g_image,) = torch.autograd.grad(loss, [image])
    ref_render.backward(params, cam, bg, degree, g_image)
    if regularize:
        reg = regularizers(params, opt)
        reg.backward()
        loss = loss + reg
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p)) for k, p in params.items()}
    lrs = ref_train.learning_rates(opt, spatial_lr_scale, state["step"])
    t = state["count"] + 1
    b1, b2 = ref_train.BETA1, ref_train.BETA2
    bc1, bc2 = 1.0 - b1**t, 1.0 - b2**t
    with torch.no_grad():
        for k, g in grads.items():
            m = state["mu"][k].mul_(b1).add_((1.0 - b1) * g)
            v = state["nu"][k].mul_(b2).add_((1.0 - b2) * g * g)
            state["params"][k] = state["params"][k] - lrs[k] * (m / bc1) / (
                torch.sqrt(v / bc2) + ref_train.EPS)
        state["params"]["xyz"] = state["params"]["xyz"] + noise(
            state["params"], lrs["xyz"], opt["noise_lr"], generator, capacity)
    state["count"] = t
    state["step"] += 1
    return float(loss.detach()), grads


def relocated(opacity: torch.Tensor, scale: torch.Tensor, n: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(o', s') of compute_relocation: o' = 1 - (1 - o)^(1/n), s' = s o /
    sum_{j=1..n} sum_{k=0..j-1} C(j-1, k) (-1)^k o'^(k+1) / sqrt(k+1), the
    sum term by term as written; o' then clamped to [0.005, 1 - eps]."""
    o_new = 1.0 - torch.pow(1.0 - opacity, 1.0 / n.to(torch.float32))
    denom = torch.zeros_like(opacity)
    for j in range(1, int(n.max()) + 1):
        for k in range(j):
            term = (math.comb(j - 1, k) * (-1.0) ** k / math.sqrt(k + 1)) * o_new ** (k + 1)
            denom = denom + torch.where(n >= j, term, torch.zeros_like(term))
    s_new = (opacity / denom)[:, None] * scale
    return torch.clamp(o_new, DEAD_OPACITY, 1.0 - torch.finfo(torch.float32).eps), s_new


def _move(state: dict, dst: torch.Tensor, src: torch.Tensor, zero_dst: bool) -> None:
    """Copy rows src into rows dst with (o', s') at both; Adam's moments
    zeroed at the sources (and at dst for new rows)."""
    if src.numel() == 0:
        return
    p = state["params"]
    n = torch.clamp(torch.bincount(src, minlength=p["xyz"].shape[0])[src] + 1, 1, N_MAX)
    o_new, s_new = relocated(torch.sigmoid(p["opacity"][src, 0]), torch.exp(p["scaling"][src]), n)
    for k in NAMES:
        p[k][dst] = p[k][src]
    for idx in (dst, src):
        p["opacity"][idx] = torch.log(o_new / (1.0 - o_new))[:, None]
        p["scaling"][idx] = torch.log(s_new)
    for tree in (state["mu"], state["nu"]):
        for k in NAMES:
            tree[k][src] = 0.0
            if zero_dst:
                tree[k][dst] = 0.0


@torch.no_grad()
def relocate_and_grow(state: dict, picks: dict, cap_max: int, capacity: int) -> None:
    """Apply the program's relocation and growth draws (picks: dead,
    dead_src, new, new_src, int64) to the state, after checking them."""
    p = state["params"]
    dev = p["xyz"].device
    picks = {k: torch.as_tensor(v, device=dev, dtype=torch.int64) for k, v in picks.items()}
    n = p["xyz"].shape[0]
    o = torch.sigmoid(p["opacity"][:, 0])
    dead = o <= DEAD_OPACITY
    want = torch.nonzero(dead)[:, 0]
    if not torch.equal(torch.sort(picks["dead"]).values, want):
        raise InvalidPicks(f"relocated {picks['dead'].numel()} slots; {want.numel()} are dead")
    src = picks["dead_src"]
    if src.numel() != want.numel() or (src.numel() and (
            bool((src < 0).any()) or bool((src >= n).any()) or bool(dead[src].any()))):
        raise InvalidPicks("a relocation source is dead or not a Gaussian")
    _move(state, picks["dead"], src, zero_dst=False)

    g = min(max(0, min(cap_max, int(GROWTH * n)) - n), capacity - n)
    new, src = picks["new"], picks["new_src"]
    if not torch.equal(new, torch.arange(n, n + g, device=dev)) or src.numel() != g or (
            g and (bool((src < 0).any()) or bool((src >= n).any()))):
        raise InvalidPicks(f"growth added {new.numel()} Gaussians; {g} expected")
    if g:
        for tree in (p, state["mu"], state["nu"]):
            for k in NAMES:
                tree[k] = torch.cat([tree[k], torch.zeros_like(tree[k][:g])])
        _move(state, new, src, zero_dst=True)
