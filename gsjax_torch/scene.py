"""Scene assembly: dataset -> device-resident cameras + initialized model.

The port of `gsjax.scene` (reference: scene/__init__.py:25-93): detects the
dataset type, loads cameras and the seed point cloud, writes input.ply and
cameras.json for the viewers, computes cameras_extent, and initializes (or
reloads) the model.

The ground-truth images live on the device as a stacked uint8 bank per
resolution group, and a step picks its camera from the bank with a device
index, so the hot loop moves no image from the host and waits on nothing.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import shutil

import numpy as np
import torch

from gsjax_torch.config import ModelConfig, resolve_device
from gsjax_torch.core.cameras import Camera
from gsjax_torch.data.camera_utils import camera_to_json, load_camera
from gsjax_torch.data.dataset import CameraInfo, SceneInfo, load_scene_info
from gsjax_torch.data.ply import load_gaussian_ply, save_gaussian_ply
from gsjax_torch.model import (
    GaussianAux,
    GaussianParams,
    create_from_pcd,
    pad_gaussian_params,
)


def _take(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t[idx] for a 0-d device index, without a host sync."""
    return t.index_select(0, idx.reshape(1)).squeeze(0)


@dataclasses.dataclass
class CameraBank:
    """Stacked cameras sharing one resolution, resident on one device.

    views/full_projs: [N,4,4]; centers: [N,3]; tan_fovx/y: [N];
    gt_rgb: [N,3,H,W] u8; alpha: [N,1,H,W] u8 (255 = opaque).
    """

    views: torch.Tensor
    full_projs: torch.Tensor
    centers: torch.Tensor
    tan_fovx: torch.Tensor
    tan_fovy: torch.Tensor
    gt_rgb: torch.Tensor
    alpha: torch.Tensor
    width: int
    height: int

    @property
    def count(self) -> int:
        return self.views.shape[0]

    @property
    def device(self) -> torch.device:
        return self.views.device

    def pick(self, idx: torch.Tensor | int) -> tuple[Camera, torch.Tensor]:
        """Select camera idx (a 0-d device tensor, or an int). Returns
        (Camera, gt [3,H,W] f32), with GT premultiplied by its alpha mask
        (reference: scene/cameras.py:39-44)."""
        idx = torch.as_tensor(idx, dtype=torch.int64, device=self.device)
        cam = Camera(
            view=_take(self.views, idx),
            full_proj=_take(self.full_projs, idx),
            cam_center=_take(self.centers, idx),
            tan_fovx=_take(self.tan_fovx, idx),
            tan_fovy=_take(self.tan_fovy, idx),
            width=self.width,
            height=self.height,
        )
        gt = _take(self.gt_rgb, idx).to(torch.float32) / 255.0
        alpha = _take(self.alpha, idx).to(torch.float32) / 255.0
        return cam, torch.clamp(gt, 0.0, 1.0) * alpha

    @classmethod
    def from_cameras(
        cls, cams: list[Camera], rgbs: list[np.ndarray], alphas: list[np.ndarray]
    ) -> "CameraBank":
        dev = cams[0].device
        return cls(
            views=torch.stack([c.view for c in cams]),
            full_projs=torch.stack([c.full_proj for c in cams]),
            centers=torch.stack([c.cam_center for c in cams]),
            tan_fovx=torch.stack([c.tan_fovx for c in cams]),
            tan_fovy=torch.stack([c.tan_fovy for c in cams]),
            gt_rgb=torch.as_tensor(np.stack(rgbs), device=dev),
            alpha=torch.as_tensor(np.stack(alphas), device=dev),
            width=cams[0].width,
            height=cams[0].height,
        )


def build_camera_banks(
    infos: list[CameraInfo],
    resolution: int,
    resolution_scale: float = 1.0,
    device: torch.device | str | None = None,
) -> list[CameraBank]:
    """Group loaded cameras by resolution and stack each group, largest
    group first."""
    dev = resolve_device(device)
    groups: dict[tuple[int, int], list] = {}
    for uid, info in enumerate(infos):
        cam, rgb, alpha = load_camera(info, uid, resolution, resolution_scale, dev)
        groups.setdefault((cam.width, cam.height), []).append((cam, rgb, alpha))
    banks = []
    for (w, h), items in sorted(groups.items(), key=lambda kv: -len(kv[1])):
        cams, rgbs, alphas = zip(*items)
        banks.append(CameraBank.from_cameras(list(cams), list(rgbs), list(alphas)))
    return banks


class Scene:
    """Host-side scene container (reference: scene/__init__.py:25-93); the
    banks and the model live on `device` (default CUDA)."""

    def __init__(
        self,
        cfg: ModelConfig,
        load_iteration: int | None = None,
        shuffle: bool = True,
        resolution_scales: tuple[float, ...] = (1.0,),
        capacity: int | None = None,
        device: torch.device | str | None = None,
    ):
        dev = resolve_device(device)
        self.model_path = cfg.model_path
        self.loaded_iter = None

        if load_iteration is not None:
            if load_iteration == -1:
                self.loaded_iter = searchForMaxIteration(
                    os.path.join(self.model_path, "point_cloud")
                )
            else:
                self.loaded_iter = load_iteration
            print(f"Loading trained model at iteration {self.loaded_iter}")

        info: SceneInfo = load_scene_info(
            cfg.source_path,
            images=cfg.images,
            white_background=cfg.white_background,
            eval_split=cfg.eval,
        )

        if not self.loaded_iter and self.model_path:
            os.makedirs(self.model_path, exist_ok=True)
            if os.path.exists(info.ply_path):
                shutil.copyfile(
                    info.ply_path, os.path.join(self.model_path, "input.ply")
                )
            cam_json = [
                camera_to_json(i, c)
                for i, c in enumerate(info.train_cameras + info.test_cameras)
            ]
            with open(os.path.join(self.model_path, "cameras.json"), "w") as f:
                json.dump(cam_json, f)

        if shuffle:
            # A per-Scene fixed seed, as gsjax's: the reference shuffles with
            # the process-global RNG (scene/__init__.py:77-79), which makes
            # the order depend on the Scenes built before; checkpoint resume
            # needs the fresh-process order every time.
            srng = random.Random(0)
            srng.shuffle(info.train_cameras)
            srng.shuffle(info.test_cameras)

        self.cameras_extent: float = info.nerf_normalization["radius"]
        # NeRF++-norm scene center (the skysphere shell and the unbounded
        # prune threshold are both anchored here).
        self.scene_center = -np.asarray(
            info.nerf_normalization["translate"], np.float32
        )
        self.info = info

        self.train_banks: dict[float, list[CameraBank]] = {}
        self.test_banks: dict[float, list[CameraBank]] = {}
        for scale in resolution_scales:
            self.train_banks[scale] = build_camera_banks(
                info.train_cameras, cfg.resolution, scale, dev
            )
            if info.test_cameras:
                self.test_banks[scale] = build_camera_banks(
                    info.test_cameras, cfg.resolution, scale, dev
                )
            else:
                self.test_banks[scale] = []

        if self.loaded_iter:
            self.params, self.aux = load_ply_model(
                os.path.join(
                    self.model_path,
                    "point_cloud",
                    f"iteration_{self.loaded_iter}",
                    "point_cloud.ply",
                ),
                capacity,
                dev,
            )
        else:
            if info.point_cloud is None:
                raise ValueError("no seed point cloud found for scene init")
            self.params, self.aux = create_from_pcd(
                info.point_cloud.points,
                info.point_cloud.colors,
                cfg.sh_degree,
                capacity=capacity,
                device=dev,
            )
            if cfg.sky_gaussians > 0:
                from gsjax_torch.sky import add_sky_shell

                self.params, self.aux = add_sky_shell(
                    self.params,
                    self.aux,
                    cfg.sky_gaussians,
                    self.scene_center,
                    cfg.sky_radius_scale * self.cameras_extent,
                )

    def get_train_banks(self, scale: float = 1.0) -> list[CameraBank]:
        return self.train_banks[scale]

    def get_test_banks(self, scale: float = 1.0) -> list[CameraBank]:
        return self.test_banks[scale]

    def save(self, iteration: int, params: GaussianParams, alive) -> None:
        """PLY snapshot (reference: scene/__init__.py:85-87)."""
        path = os.path.join(
            self.model_path, "point_cloud", f"iteration_{iteration}", "point_cloud.ply"
        )
        save_gaussian_ply(path, params, alive)


def load_ply_model(
    path: str,
    capacity: int | None = None,
    device: torch.device | str | None = None,
) -> tuple[GaussianParams, GaussianAux]:
    """A model PLY's Gaussians, alive in the first slots of `capacity`
    (default max(next power of two, 1024)), on `device` (default CUDA)."""
    dev = resolve_device(device)
    data = load_gaussian_ply(path)
    n = data["xyz"].shape[0]
    cap = capacity or max(1 << (n - 1).bit_length(), 1024)
    params = pad_gaussian_params(
        **{k: torch.as_tensor(v, device=dev) for k, v in data.items()}, capacity=cap
    )
    return params, GaussianAux.create(cap, n, dev)


def searchForMaxIteration(folder: str) -> int:
    """(reference: utils/system_utils.py usage in scene/__init__.py:36)"""
    iters = [
        int(name.split("_")[-1])
        for name in os.listdir(folder)
        if name.startswith("iteration_")
    ]
    return max(iters)
