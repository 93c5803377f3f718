"""Skysphere support: a shell of far-field "sky" Gaussians.

The port of `gsjax.sky`: an optional shell of large, far Gaussians
initialized on a sphere around the scene, which learn the sky and far
field instead of leaving it to the constant background color. Disabled by
default (sky_gaussians 0 keeps exact reference behavior). The shell's
arrays are made in numpy, as gsjax makes them, and placed on the model's
device.
"""

from __future__ import annotations

import numpy as np
import torch

from gsjax_torch.core.sh import RGB2SH, num_sh_coeffs
from gsjax_torch.core.transforms import inverse_sigmoid
from gsjax_torch.model import GaussianAux, GaussianParams


def fibonacci_sphere(n: int) -> np.ndarray:
    """[n,3] near-uniform unit directions (golden-angle spiral)."""
    i = np.arange(n, dtype=np.float64) + 0.5
    phi = np.arccos(1.0 - 2.0 * i / n)
    theta = np.pi * (1.0 + 5.0**0.5) * i
    return np.stack(
        [
            np.cos(theta) * np.sin(phi),
            np.sin(theta) * np.sin(phi),
            np.cos(phi),
        ],
        axis=-1,
    ).astype(np.float32)


def sky_shell_arrays(
    n: int,
    center: np.ndarray,
    radius: float,
    sh_degree: int,
    opacity: float = 0.7,
    zenith_color=(0.45, 0.62, 0.90),
    horizon_color=(0.85, 0.88, 0.94),
) -> dict:
    """Raw parameter arrays for n sky Gaussians on a sphere of `radius`
    around `center`. Colors follow a zenith->horizon gradient (COLMAP
    convention: -y is up); scales cover the sphere surface
    (each splat ~ 2x its Voronoi cell: s = 2 r sqrt(pi/n))."""
    dirs = fibonacci_sphere(n)
    xyz = center[None, :].astype(np.float32) + radius * dirs
    up = -dirs[:, 1]  # elevation in COLMAP convention (y down)
    t = np.clip(up, 0.0, 1.0)[:, None]
    rgb = (1.0 - t) * np.asarray(horizon_color, np.float32) + t * np.asarray(
        zenith_color, np.float32
    )
    k = num_sh_coeffs(sh_degree)
    f_dc = np.asarray(RGB2SH(rgb))[:, None, :].astype(np.float32)
    f_rest = np.zeros((n, k - 1, 3), np.float32)
    s = 2.0 * radius * np.sqrt(np.pi / n)
    scaling = np.full((n, 3), np.log(s), np.float32)
    rotation = np.zeros((n, 4), np.float32)
    rotation[:, 0] = 1.0
    opac = np.full(
        (n, 1), float(inverse_sigmoid(torch.tensor(opacity))), np.float32
    )
    return {
        "xyz": xyz,
        "features_dc": f_dc,
        "features_rest": f_rest,
        "scaling": scaling,
        "rotation": rotation,
        "opacity": opac,
    }


@torch.no_grad()
def add_sky_shell(
    params: GaussianParams,
    aux: GaussianAux,
    n: int,
    center: np.ndarray,
    radius: float,
) -> tuple[GaussianParams, GaussianAux]:
    """Append n sky Gaussians into dead capacity slots (grows buffers to
    the next power of two if needed). Returns new (params, aux); the sky
    rows are written into the new tensors."""
    n_alive = int(aux.n_alive())
    cap = params.capacity
    need = n_alive + n
    if need > cap:
        from gsjax_torch.train.optimizer import adam_init
        from gsjax_torch.train.step import TrainState
        from gsjax_torch.train.trainer import grow_capacity

        state = grow_capacity(
            TrainState(
                params=params, opt=adam_init(params), aux=aux,
                step=torch.zeros((), dtype=torch.int32, device=params.device),
            ),
            max(1 << (need - 1).bit_length(), cap),
        )
        params, aux = state.params, state.aux

    sky = sky_shell_arrays(n, center, radius, params.max_sh_degree)
    sl = slice(n_alive, n_alive + n)
    fields = {}
    for k, v in sky.items():
        t = getattr(params, k).detach().clone()
        t[sl] = torch.as_tensor(v, device=t.device)
        fields[k] = t
    alive = aux.alive.clone()
    alive[sl] = True
    return GaussianParams(**fields), GaussianAux(
        alive=alive, max_radii2d=aux.max_radii2d, xyz_grad_accum=aux.xyz_grad_accum,
        denom=aux.denom,
    )
