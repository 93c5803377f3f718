"""Seeded scenes: Gaussians, cameras and ground truths at a configuration's
scale, made on the device in a few large calls.

No scene data is in the repository, so a configuration takes its scale
from a published dataset (Gaussian count, resolution, views, held-out
split) and this module makes its geometry and pixels from the seed. The
generator's shapes (where the Gaussians lie, their sizes, opacities and
colours, the orbit of the cameras) are the configuration's `assumed`
values. The cameras do not depend on the seed; the Gaussians, the
ground truths, the Adam moments and the requests do.

Everything here is plain numpy and torch: the port and the reference get
the same tensors from it.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

SH_C0 = 0.28209479177387814
ZNEAR = 0.01
ZFAR = 100.0
PARAM_NAMES = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity")


def capacity_for(n: int) -> int:
    """The capacity a training run holds n Gaussians at: the port's
    Trainer starts at a power of two and doubles it whenever a densify
    leaves more than three quarters of it alive, so n lives in the
    smallest power of two (at least 1024) of which it is at most 3/4."""
    cap = 1024
    while n > 0.75 * cap:
        cap *= 2
    return cap


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


# --- cameras ------------------------------------------------------------------------


def projection_matrix(fov_x: float, fov_y: float) -> np.ndarray:
    """OpenGL-style perspective in the column-vector convention of the
    published 3DGS code (utils/graphics_utils.py getProjectionMatrix)."""
    tan_y = math.tan(fov_y / 2.0)
    tan_x = math.tan(fov_x / 2.0)
    p = np.zeros((4, 4), np.float32)
    p[0, 0] = 1.0 / tan_x
    p[1, 1] = 1.0 / tan_y
    p[2, 2] = ZFAR / (ZFAR - ZNEAR)
    p[2, 3] = -(ZFAR * ZNEAR) / (ZFAR - ZNEAR)
    p[3, 2] = 1.0
    return p


def look_at(pos: np.ndarray, target: np.ndarray) -> np.ndarray:
    """World-to-camera 4x4 (float32) of a camera at pos looking at target,
    COLMAP axes (x right, y down, z forward)."""
    fwd = target - pos
    fwd = fwd / np.linalg.norm(fwd)
    up = np.array([0.0, -1.0, 0.0])
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    up2 = np.cross(fwd, right)
    r = np.stack([right, up2, fwd], axis=0)
    view = np.eye(4)
    view[:3, :3] = r
    view[:3, 3] = -r @ pos
    return view.astype(np.float32)


@dataclasses.dataclass
class Views:
    """Stacked cameras of one resolution: views/full_projs [V,4,4] (w2c
    and proj @ w2c, column-vector), centers [V,3], tan_fovx/tan_fovy [V]."""

    views: torch.Tensor
    full_projs: torch.Tensor
    centers: torch.Tensor
    tan_fovx: torch.Tensor
    tan_fovy: torch.Tensor
    width: int
    height: int

    @property
    def count(self) -> int:
        return self.views.shape[0]


def views_from_matrices(mats: list[np.ndarray], fov_x: float, fov_y: float,
                        width: int, height: int, device) -> Views:
    proj = projection_matrix(fov_x, fov_y)
    full = [(proj @ m).astype(np.float32) for m in mats]
    centers = [np.linalg.inv(m.astype(np.float64))[:3, 3] for m in mats]
    n = len(mats)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return Views(views=t(np.stack(mats)), full_projs=t(np.stack(full)),
                 centers=t(np.stack(centers)),
                 tan_fovx=t(np.full(n, math.tan(fov_x / 2.0))),
                 tan_fovy=t(np.full(n, math.tan(fov_y / 2.0))),
                 width=width, height=height)


def orbit_pose(cfg: dict, angle: float, lift: float) -> np.ndarray:
    """The w2c matrix of the orbit at `angle`, `lift` in [-1, 1] scaling
    the orbit's height swing."""
    orb = cfg["assumed"]["orbit"]
    r = orb["radius"]
    pos = np.array([r * math.sin(angle), orb["height"] + orb["height_swing"] * lift,
                    -r * math.cos(angle)])
    return look_at(pos, np.array([0.0, orb["target_height"], 0.0]))


def orbit_angles(cfg: dict) -> list[tuple[float, float]]:
    """(angle, lift) of each of the dataset's images, in capture order."""
    n = cfg["images"]
    return [(2.0 * math.pi * i / n, math.sin(3.0 * 2.0 * math.pi * i / n)) for i in range(n)]


def split(cfg: dict) -> tuple[list[int], list[int]]:
    """Train and held-out image indices: every `llffhold`-th image is held
    out, as the published loader's eval split (scene/dataset_readers.py)."""
    hold = cfg["llffhold"]
    idx = range(cfg["images"])
    return [i for i in idx if i % hold != 0], [i for i in idx if i % hold == 0]


def fovs(cfg: dict) -> tuple[float, float]:
    f = cfg["assumed"]["focal_px"]
    return (2.0 * math.atan(cfg["width"] / (2.0 * f)),
            2.0 * math.atan(cfg["height"] / (2.0 * f)))


def camera_set(cfg: dict, which: str, device) -> Views:
    train, test = split(cfg)
    poses = orbit_angles(cfg)
    idx = train if which == "train" else test
    fx, fy = fovs(cfg)
    return views_from_matrices([orbit_pose(cfg, *poses[i]) for i in idx], fx, fy,
                               cfg["width"], cfg["height"], device)


def normalization(cfg: dict) -> tuple[np.ndarray, float]:
    """(centre, extent) of the train cameras, the published NeRF++ rule
    (scene/dataset_readers.py getNerfppNorm): extent = 1.1 x the largest
    distance of a camera centre from their mean."""
    train, _ = split(cfg)
    poses = orbit_angles(cfg)
    centers = np.stack([np.linalg.inv(orbit_pose(cfg, *poses[i]).astype(np.float64))[:3, 3]
                        for i in train])
    mid = centers.mean(axis=0)
    return mid, float(np.linalg.norm(centers - mid, axis=1).max() * 1.1)


# --- Gaussians ------------------------------------------------------------------------


def fibonacci_sphere(n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.float64) + 0.5
    phi = np.arccos(1.0 - 2.0 * i / n)
    theta = np.pi * (1.0 + 5.0**0.5) * i
    return np.stack([np.cos(theta) * np.sin(phi), np.sin(theta) * np.sin(phi),
                     np.cos(phi)], axis=-1).astype(np.float32)


def sky_shell(n: int, center: np.ndarray, radius: float, k: int) -> dict:
    """The fork's sky shell (gsjax's sky.py, copied): n Gaussians on a
    sphere of `radius` around `center`, a zenith-to-horizon colour ramp,
    scale 2 r sqrt(pi / n), opacity 0.7, identity rotations."""
    dirs = fibonacci_sphere(n)
    xyz = center[None, :].astype(np.float32) + radius * dirs
    t = np.clip(-dirs[:, 1], 0.0, 1.0)[:, None]
    rgb = (1.0 - t) * np.asarray((0.85, 0.88, 0.94), np.float32) + t * np.asarray(
        (0.45, 0.62, 0.90), np.float32)
    rot = np.zeros((n, 4), np.float32)
    rot[:, 0] = 1.0
    return {
        "xyz": xyz,
        "features_dc": ((rgb - 0.5) / SH_C0)[:, None, :].astype(np.float32),
        "features_rest": np.zeros((n, k - 1, 3), np.float32),
        "scaling": np.full((n, 3), math.log(2.0 * radius * math.sqrt(math.pi / n)), np.float32),
        "rotation": rot,
        "opacity": np.full((n, 1), math.log(0.7 / 0.3), np.float32),
    }


def _logit(p: torch.Tensor) -> torch.Tensor:
    return torch.log(p / (1.0 - p))


def gaussians(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """Raw (pre-activation) parameters of the configuration's Gaussians,
    {name: [n, ...] float32}, the sky shell last. Three parts, their
    shares, sizes and opacities from `assumed.gaussians`: an object
    around the orbit's target, a ground disk and a background belt
    beyond the orbit."""
    a = cfg["assumed"]["gaussians"]
    n = cfg["gaussians"]
    k = (cfg["sh_degree"] + 1) ** 2
    g = generator(seed, device)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=device)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device)

    n_obj = int(n * a["object_share"])
    n_gnd = int(n * a["ground_share"])
    n_bg = n - n_obj - n_gnd
    obj = randn(n_obj, 3) * torch.tensor(a["object_sigma"], device=device)
    obj[:, 1] += a["object_height"]
    rg = a["ground_radius"] * torch.sqrt(rand(n_gnd))
    ag = 2.0 * math.pi * rand(n_gnd)
    gnd = torch.stack([rg * torch.sin(ag), a["ground_height"] + 0.02 * randn(n_gnd),
                       rg * torch.cos(ag)], dim=-1)
    lo, hi = a["background_radius"]
    rb = lo + (hi - lo) * rand(n_bg)
    ab = 2.0 * math.pi * rand(n_bg)
    ylo, yhi = a["background_height"]
    bg = torch.stack([rb * torch.sin(ab), ylo + (yhi - ylo) * rand(n_bg),
                      rb * torch.cos(ab)], dim=-1)
    xyz = torch.cat([obj, gnd, bg])

    med = torch.cat([torch.full((n_obj,), a["object_scale"], device=device),
                     torch.full((n_gnd,), a["ground_scale"], device=device),
                     torch.full((n_bg,), a["background_scale"], device=device)])
    scaling = torch.log(med)[:, None] + a["scale_log_sigma"] * randn(n, 3)
    rotation = randn(n, 4)
    solid = rand(n) < a["opaque_share"]
    lo_o, hi_o = a["opaque_range"]
    lo_t, hi_t = a["translucent_range"]
    op = torch.where(solid, lo_o + (hi_o - lo_o) * rand(n), lo_t + (hi_t - lo_t) * rand(n))
    # Colour: a smooth field over space plus noise, as SH DC; the higher
    # bands small, as a trained scene's view dependence is.
    f = torch.tensor(a["colour_frequency"], device=device)
    base = 0.5 + 0.35 * torch.sin(xyz @ f.T + torch.tensor([0.0, 2.0, 4.0], device=device))
    rgb = (base + a["colour_noise"] * randn(n, 3)).clamp(0.02, 0.98)
    params = {
        "xyz": xyz,
        "features_dc": ((rgb - 0.5) / SH_C0)[:, None, :],
        "features_rest": a["sh_rest_sigma"] * randn(n, k - 1, 3),
        "scaling": scaling,
        "rotation": rotation,
        "opacity": _logit(op)[:, None],
    }
    n_sky = cfg.get("sky_gaussians", 0)
    if n_sky:
        center, extent = normalization(cfg)
        sky = sky_shell(n_sky, center, cfg["sky_radius_scale"] * extent, k)
        params = {name: torch.cat([params[name], torch.as_tensor(sky[name], device=device)])
                  for name in PARAM_NAMES}
    return {name: v.contiguous() for name, v in params.items()}


def adam_moments(cfg: dict, seed: int, params: dict[str, torch.Tensor]
                 ) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
    """Adam's first and second moments of a run resumed mid-training, from
    the seed: mu ~ N(0, (mu_share * s)^2), sqrt(nu) ~ s * U(0.5, 1.5),
    with s each group's gradient scale in `assumed.adam_scale`."""
    scale = cfg["assumed"]["adam_scale"]
    share = cfg["assumed"]["adam_mu_share"]
    g = generator(seed + 1, params["xyz"].device)
    mu, nu = {}, {}
    for name in PARAM_NAMES:
        p = params[name]
        s = scale[name]
        mu[name] = share * s * torch.randn(p.shape, generator=g, device=p.device)
        nu[name] = (s * (0.5 + torch.rand(p.shape, generator=g, device=p.device))) ** 2
    return mu, nu


def ground_truths(cfg: dict, seed: int, count: int, device, chunk: int = 16) -> torch.Tensor:
    """[count, 3, H, W] uint8: seeded smooth images (bilinearly upsampled
    noise of `assumed.gt_cells` cells a side), made in chunks of views."""
    h, w = cfg["height"], cfg["width"]
    cells = cfg["assumed"]["gt_cells"]
    g = generator(seed + 2, device)
    out = torch.empty((count, 3, h, w), dtype=torch.uint8, device=device)
    for s in range(0, count, chunk):
        m = min(chunk, count - s)
        low = torch.rand((m, 3, cells, max(1, cells * w // h)), generator=g, device=device)
        img = torch.nn.functional.interpolate(low, size=(h, w), mode="bilinear",
                                              align_corners=False)
        out[s:s + m] = (img * 255.0).round().clamp(0, 255).to(torch.uint8)
    return out
