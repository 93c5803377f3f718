"""Full-training-state checkpoints, in gsjax's npz form.

The analog of torch.save((gaussians.capture(), iteration)) (reference:
train.py:130-132; scene/gaussian_model.py:61-93): one .npz with every
tensor of the TrainState (params, Adam moments and count, densification
stats, alive mask, step) plus the scalars the reference captures
(active_sh_degree, spatial_lr_scale). The keys and dtypes are
`gsjax.train.checkpoint`'s, so either package loads the other's files.
gsjax's orbax form is not ported.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from gsjax_torch.config import resolve_device
from gsjax_torch.interop import train_state_from_numpy, train_state_to_numpy
from gsjax_torch.model import PARAM_NAMES
from gsjax_torch.train.step import TrainState


def save_checkpoint(
    path: str,
    state: TrainState,
    active_sh_degree: int,
    spatial_lr_scale: float,
    extra: dict | None = None,
) -> None:
    """`extra` is a flat dict of numpy arrays persisted under "extra.<k>"
    (the trainer's host-side RNG and camera-stack snapshot, which a
    restored run needs to reproduce an uninterrupted one)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tree = train_state_to_numpy(state)
    arrays = {"step": tree["step"]}
    for f in PARAM_NAMES:
        arrays[f"params.{f}"] = tree["params"][f]
        arrays[f"mu.{f}"] = tree["opt"]["mu"][f]
        arrays[f"nu.{f}"] = tree["opt"]["nu"][f]
    arrays["opt.count"] = tree["opt"]["count"]
    for k, v in tree["aux"].items():
        arrays[f"aux.{k}"] = v
    arrays["meta.active_sh_degree"] = np.asarray(active_sh_degree)
    arrays["meta.spatial_lr_scale"] = np.asarray(spatial_lr_scale)
    for k, v in (extra or {}).items():
        arrays[f"extra.{k}"] = np.asarray(v)
    # Write-then-rename: a kill mid-save must never leave a truncated
    # archive at the final path. os.replace is atomic on POSIX.
    if not path.endswith(".npz"):
        path = path + ".npz"  # np.savez appends it; keep tmp/final in sync
    tmp = path + ".tmp.npz"
    try:
        with open(tmp, "wb") as fh:
            np.savez(fh, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_checkpoint(
    path: str, device: torch.device | str | None = None
) -> tuple[TrainState, int, float]:
    """Returns (state, active_sh_degree, spatial_lr_scale), the state on
    `device` (default CUDA). load_checkpoint_extra also returns the extras."""
    state, sh, lr, _ = load_checkpoint_extra(path, device)
    return state, sh, lr


def load_checkpoint_extra(
    path: str, device: torch.device | str | None = None
) -> tuple[TrainState, int, float, dict]:
    """Returns (state, active_sh_degree, spatial_lr_scale, extra), where
    extra holds whatever dict was passed to save_checkpoint."""
    dev = resolve_device(device)
    with np.load(path) as z:
        tree = {
            "params": {f: z[f"params.{f}"] for f in PARAM_NAMES},
            "opt": {
                "count": z["opt.count"],
                "mu": {f: z[f"mu.{f}"] for f in PARAM_NAMES},
                "nu": {f: z[f"nu.{f}"] for f in PARAM_NAMES},
            },
            "aux": {k[len("aux."):]: z[k] for k in z.files if k.startswith("aux.")},
            "step": z["step"],
        }
        extra = {k[len("extra."):]: z[k] for k in z.files if k.startswith("extra.")}
        sh = int(z["meta.active_sh_degree"])
        lr = float(z["meta.spatial_lr_scale"])
    return train_state_from_numpy(tree, dev), sh, lr, extra
