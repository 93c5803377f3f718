"""Procedural multi-object scene with ray-traced ground truth.

The port's copy of the JAX package's `tools/synthetic_scene.py` (whose
points PLY comes from that package's writer): a Blender-format dataset
(transforms_{train,test}.json + PNGs + points3d.ply) whose ground-truth
images come from an independent numpy ray tracer — matte colored spheres
over a checkered ground plane under a sky gradient — so training quality
is measured against imagery the rasterizer never produced. The same seed
gives the same files as the original.

    python -m gsjax_torch.tools.synthetic_scene <out dir> [--res 400]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

LIGHT_DIR = np.array([0.45, 0.8, 0.35])
LIGHT_DIR = LIGHT_DIR / np.linalg.norm(LIGHT_DIR)


def _scene_spheres(n: int, rng) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sphere centers/radii/colors clustered near the origin above ground."""
    centers = rng.uniform([-1.4, 0.1, -1.4], [1.4, 1.2, 1.4], (n, 3))
    radii = rng.uniform(0.12, 0.38, n)
    centers[:, 1] = np.maximum(centers[:, 1], radii + 0.02)
    colors = rng.uniform(0.15, 0.95, (n, 3))
    return centers, radii, colors


def _trace(origin, dirs, centers, radii, colors):
    """Ray-trace spheres + checkerboard plane (y=0) + sky. dirs: [H,W,3]."""
    h, w, _ = dirs.shape
    t_hit = np.full((h, w), np.inf)
    color = np.zeros((h, w, 3), np.float32)
    normal = np.zeros((h, w, 3), np.float32)

    # Spheres.
    for c, r, col in zip(centers, radii, colors):
        oc = origin - c
        b = np.einsum("hwc,c->hw", dirs, oc)
        disc = b * b - (oc @ oc - r * r)
        ok = disc > 0
        t = -b - np.sqrt(np.maximum(disc, 0.0))
        hit = ok & (t > 1e-3) & (t < t_hit)
        t_hit[hit] = t[hit]
        p = origin + dirs * t[..., None]
        nrm = (p - c) / r
        color[hit] = col
        normal[hit] = nrm[hit]

    # Ground plane y=0 with checkerboard.
    dy = dirs[..., 1]
    t_pl = np.where(dy < -1e-6, -origin[1] / dy, np.inf)
    hit_pl = (t_pl > 1e-3) & (t_pl < t_hit)
    p = origin + dirs * t_pl[..., None]
    checker = ((np.floor(p[..., 0] / 0.5) + np.floor(p[..., 2] / 0.5)) % 2)
    pl_col = np.where(
        checker[..., None] > 0.5,
        np.array([0.82, 0.78, 0.72]),
        np.array([0.25, 0.3, 0.38]),
    )
    t_hit[hit_pl] = t_pl[hit_pl]
    color[hit_pl] = pl_col[hit_pl]
    normal[hit_pl] = np.array([0.0, 1.0, 0.0])

    # Matte shading with a hard shadow ray toward the light.
    hit_any = np.isfinite(t_hit)
    lam = np.clip(np.einsum("hwc,c->hw", normal, LIGHT_DIR), 0.0, 1.0)
    p_hit = origin + dirs * np.where(hit_any, t_hit, 0.0)[..., None]
    shadow = np.zeros((h, w), bool)
    for c, r in zip(centers, radii):
        oc = p_hit + normal * 1e-3 - c
        b = oc @ LIGHT_DIR
        disc = b * b - (np.einsum("hwc,hwc->hw", oc, oc) - r * r)
        t = -b - np.sqrt(np.maximum(disc, 0.0))
        shadow |= (disc > 0) & (t > 1e-3)
    shade = 0.35 + 0.65 * np.where(shadow, 0.0, lam)
    lit = color * shade[..., None]

    # Sky gradient for misses.
    sky_t = np.clip(dirs[..., 1] * 0.5 + 0.5, 0, 1)[..., None]
    sky = (1 - sky_t) * np.array([0.9, 0.85, 0.75]) + sky_t * np.array(
        [0.35, 0.55, 0.9]
    )
    out = np.where(hit_any[..., None], lit, sky)
    return np.clip(out, 0.0, 1.0)


def camera_pose(angle: float, elev: float = 0.45, radius: float = 4.2):
    """OpenGL c2w orbit pose looking at (0, 0.45, 0)."""
    target = np.array([0.0, 0.45, 0.0])
    pos = target + radius * np.array(
        [np.sin(angle) * np.cos(elev), np.sin(elev), np.cos(angle) * np.cos(elev)]
    )
    fwd = target - pos
    fwd /= np.linalg.norm(fwd)
    up = np.array([0.0, 1.0, 0.0])
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    up2 = np.cross(right, fwd)
    c2w = np.eye(4)
    c2w[:3, 0] = right
    c2w[:3, 1] = up2
    c2w[:3, 2] = -fwd
    c2w[:3, 3] = pos
    return c2w


def generate(
    root: str,
    *,
    res: int = 400,
    n_train: int = 96,
    n_test: int = 8,
    n_spheres: int = 24,
    n_seed_points: int = 5_000,
    fov_x: float = 0.85,
    seed: int = 11,
) -> str:
    """Writes the dataset under root and returns root. 96 train views: at
    ~1M Gaussians a densified model has far more parameters than a
    28-view dataset has pixels, and overfits; the reference's benchmark
    scenes carry 100-300 views (reference: full_eval.py:15-18)."""
    from PIL import Image

    from gsjax_torch.data.ply import store_points_ply

    rng = np.random.default_rng(seed)
    centers, radii, colors = _scene_spheres(n_spheres, rng)
    os.makedirs(root, exist_ok=True)

    focal = 0.5 * res / np.tan(0.5 * fov_x)
    xs = (np.arange(res) + 0.5 - res / 2) / focal
    ys = -(np.arange(res) + 0.5 - res / 2) / focal
    gx, gy = np.meshgrid(xs, ys)

    def make_split(name, n, offset):
        frames = []
        os.makedirs(os.path.join(root, name), exist_ok=True)
        for i in range(n):
            angle = (i + offset) * (2 * np.pi / n)
            # Three interleaved elevation rings (plus jitter) so the view
            # set constrains the scene vertically, not just around one orbit.
            elev = (0.15, 0.4, 0.65)[i % 3] + 0.08 * (
                ((i * 7919) % n) / max(n - 1, 1) - 0.5
            )
            c2w = camera_pose(angle, elev)
            d_cam = np.stack([gx, gy, -np.ones_like(gx)], axis=-1)
            d_world = np.einsum("rc,hwc->hwr", c2w[:3, :3], d_cam)
            d_world /= np.linalg.norm(d_world, axis=-1, keepdims=True)
            img = _trace(c2w[:3, 3], d_world, centers, radii, colors)
            rgba = np.concatenate(
                [img, np.ones((res, res, 1))], axis=-1
            )
            fname = f"r_{i}"
            Image.fromarray(
                np.round(rgba * 255).astype(np.uint8)
            ).save(os.path.join(root, name, fname + ".png"))
            frames.append(
                {
                    "file_path": f"./{name}/{fname}",
                    "transform_matrix": c2w.tolist(),
                }
            )
        with open(os.path.join(root, f"transforms_{name}.json"), "w") as f:
            json.dump({"camera_angle_x": fov_x, "frames": frames}, f)

    make_split("train", n_train, 0.0)
    make_split("test", n_test, 0.37)

    # Seed cloud: surface samples of the true geometry + ground samples,
    # like a COLMAP sparse cloud would give.
    n_sph = n_seed_points // 2
    which = rng.integers(0, n_spheres, n_sph)
    dirs = rng.normal(size=(n_sph, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    pts_s = centers[which] + dirs * radii[which][:, None]
    cols_s = colors[which]
    n_gr = n_seed_points - n_sph
    pts_g = np.stack(
        [
            rng.uniform(-3, 3, n_gr),
            np.zeros(n_gr),
            rng.uniform(-3, 3, n_gr),
        ],
        axis=-1,
    )
    checker = (np.floor(pts_g[:, 0] / 0.5) + np.floor(pts_g[:, 2] / 0.5)) % 2
    cols_g = np.where(
        checker[:, None] > 0.5,
        np.array([0.82, 0.78, 0.72]),
        np.array([0.25, 0.3, 0.38]),
    )
    pts = np.concatenate([pts_s, pts_g])
    cols = np.concatenate([cols_s, cols_g]) * 255.0
    store_points_ply(os.path.join(root, "points3d.ply"), pts, cols)
    return root


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("out", help="directory to write the dataset to")
    parser.add_argument("--res", type=int, default=400)
    args = parser.parse_args(argv)
    generate(args.out, res=args.res)
    print(f"scene written to {args.out}")


if __name__ == "__main__":
    main()
