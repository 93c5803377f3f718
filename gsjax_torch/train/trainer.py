"""Host-side training orchestration around the training step.

The port of `gsjax.train.trainer`'s capacity helpers. The Gaussian buffers
have a static capacity; when densification fills it, every per-Gaussian
buffer is re-padded to a larger capacity (the reference reallocates its
tensors every densify instead, reference: scene/gaussian_model.py:307-327).
The rest of gsjax's Trainer (schedule, densify cadence, budgets, eval,
checkpoints, resume) is not ported yet.
"""

from __future__ import annotations

import torch

from gsjax_torch.model import PARAM_NAMES, GaussianAux, pad_gaussian_params
from gsjax_torch.train.optimizer import AdamState
from gsjax_torch.train.step import TrainState


def _pow2_chunks(n: int) -> list[int]:
    """Binary decomposition of a window length, largest chunk first
    (100 -> [64, 32, 4]): windows run as power-of-two chunks, so the set
    of window lengths ever built stays bounded."""
    out = []
    bit = 1 << max(n.bit_length() - 1, 0)
    while n:
        if n >= bit:
            out.append(bit)
            n -= bit
        bit >>= 1
    return out


@torch.no_grad()
def grow_capacity(state: TrainState, new_cap: int) -> TrainState:
    """Re-pad every per-Gaussian buffer to new_cap with the dead-slot fill.

    Returns a new state: a new GaussianParams module, new moment and aux
    tensors (zero moments and dead slots in the new rows), the same count
    and step; the old state's tensors are not modified. A new_cap no
    larger than the capacity returns the state as it is."""
    old = state.params.capacity
    extra = new_cap - old
    if extra <= 0:
        return state

    def pad(x: torch.Tensor, fill=0.0) -> torch.Tensor:
        out = x.new_full((new_cap, *x.shape[1:]), fill)
        out[:old] = x
        return out

    params = pad_gaussian_params(
        **{k: getattr(state.params, k).detach() for k in PARAM_NAMES}, capacity=new_cap)
    opt = AdamState(
        count=state.opt.count,
        mu={k: pad(v) for k, v in state.opt.mu.items()},
        nu={k: pad(v) for k, v in state.opt.nu.items()},
    )
    aux = GaussianAux(
        alive=pad(state.aux.alive, False),
        max_radii2d=pad(state.aux.max_radii2d),
        xyz_grad_accum=pad(state.aux.xyz_grad_accum),
        denom=pad(state.aux.denom),
    )
    return TrainState(params=params, opt=opt, aux=aux, step=state.step)
