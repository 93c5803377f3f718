"""Scene ingestion: COLMAP and Blender/NeRF-synthetic readers.

The port's copy of `gsjax.data.dataset` (numpy on the host; the tensors
are made by data.camera_utils and scene).

Behavioral parity with the reference readers
(reference: scene/dataset_readers.py): PINHOLE/SIMPLE_PINHOLE only,
every-8th-image test split under --eval, NeRF++-style normalization
(camera-centroid radius * 1.1), alpha compositing onto the background for
Blender scenes, random 100k-point init when no seed cloud exists.
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path

import numpy as np

from gsjax_torch.core.cameras import focal2fov, fov2focal, world_to_view
from gsjax_torch.core.sh import SH2RGB
from gsjax_torch.data import colmap
from gsjax_torch.data.ply import fetch_points_ply, store_points_ply


@dataclasses.dataclass
class CameraInfo:
    """(reference: scene/dataset_readers.py:26-36). `image` is lazy: a path
    plus optional preloaded array, so huge scenes don't hold all pixels."""

    uid: int
    R: np.ndarray  # stored transposed (camera-to-world rotation)
    T: np.ndarray
    fov_y: float
    fov_x: float
    image_path: str
    image_name: str
    width: int
    height: int
    image: np.ndarray | None = None  # [H,W,3|4] uint8 if preloaded

    def load_image(self) -> np.ndarray:
        if self.image is not None:
            return self.image
        from PIL import Image

        return np.asarray(Image.open(self.image_path))


@dataclasses.dataclass
class PointCloud:
    points: np.ndarray
    colors: np.ndarray
    normals: np.ndarray


@dataclasses.dataclass
class SceneInfo:
    point_cloud: PointCloud | None
    train_cameras: list[CameraInfo]
    test_cameras: list[CameraInfo]
    nerf_normalization: dict
    ply_path: str


def get_nerfpp_norm(cam_infos: list[CameraInfo]) -> dict:
    """Scene extent from camera centers (reference:
    scene/dataset_readers.py:45-66): radius = 1.1 * max distance from the
    centroid of camera centers; translate recenters to that centroid."""
    centers = []
    for cam in cam_infos:
        w2c = world_to_view(cam.R, cam.T)
        c2w = np.linalg.inv(w2c)
        centers.append(c2w[:3, 3])
    centers = np.stack(centers, axis=0)
    avg = centers.mean(axis=0)
    diagonal = float(np.linalg.norm(centers - avg, axis=1).max())
    return {"translate": -avg, "radius": diagonal * 1.1}


def read_colmap_cameras(
    extrinsics: dict, intrinsics: dict, images_folder: str
) -> list[CameraInfo]:
    """(reference: scene/dataset_readers.py:68-105)"""
    infos = []
    for key in extrinsics:
        extr = extrinsics[key]
        intr = intrinsics[extr.camera_id]
        height, width = intr.height, intr.width
        R = np.transpose(colmap.qvec2rotmat(extr.qvec))
        T = np.array(extr.tvec)
        if intr.model == "SIMPLE_PINHOLE":
            fx = intr.params[0]
            fov_y = focal2fov(fx, height)
            fov_x = focal2fov(fx, width)
        elif intr.model == "PINHOLE":
            fov_y = focal2fov(intr.params[1], height)
            fov_x = focal2fov(intr.params[0], width)
        else:
            raise ValueError(
                "Colmap camera model not handled: only undistorted datasets "
                "(PINHOLE or SIMPLE_PINHOLE cameras) supported!"
            )
        image_path = os.path.join(images_folder, os.path.basename(extr.name))
        infos.append(
            CameraInfo(
                uid=intr.id,
                R=R,
                T=T,
                fov_y=fov_y,
                fov_x=fov_x,
                image_path=image_path,
                image_name=os.path.basename(image_path).split(".")[0],
                width=width,
                height=height,
            )
        )
    return infos


def read_colmap_scene_info(
    path: str, images: str | None, eval_split: bool, llffhold: int = 8
) -> SceneInfo:
    """(reference: scene/dataset_readers.py:132-177)"""
    sparse = os.path.join(path, "sparse/0")
    try:
        extr = colmap.read_images_binary(os.path.join(sparse, "images.bin"))
        intr = colmap.read_cameras_binary(os.path.join(sparse, "cameras.bin"))
    except (FileNotFoundError, ValueError):
        extr = colmap.read_images_text(os.path.join(sparse, "images.txt"))
        intr = colmap.read_cameras_text(os.path.join(sparse, "cameras.txt"))

    reading_dir = images if images else "images"
    infos = read_colmap_cameras(extr, intr, os.path.join(path, reading_dir))
    infos = sorted(infos, key=lambda c: c.image_name)

    if eval_split:
        train = [c for i, c in enumerate(infos) if i % llffhold != 0]
        test = [c for i, c in enumerate(infos) if i % llffhold == 0]
    else:
        train, test = infos, []

    norm = get_nerfpp_norm(train)

    ply_path = os.path.join(sparse, "points3D.ply")
    if not os.path.exists(ply_path):
        try:
            xyz, rgb, _ = colmap.read_points3d_binary(
                os.path.join(sparse, "points3D.bin")
            )
        except FileNotFoundError:
            xyz, rgb, _ = colmap.read_points3d_text(
                os.path.join(sparse, "points3D.txt")
            )
        store_points_ply(ply_path, xyz, rgb)
    try:
        pts, colors, normals = fetch_points_ply(ply_path)
        pcd = PointCloud(points=pts, colors=colors, normals=normals)
    except (FileNotFoundError, ValueError):
        pcd = None

    return SceneInfo(
        point_cloud=pcd,
        train_cameras=train,
        test_cameras=test,
        nerf_normalization=norm,
        ply_path=ply_path,
    )


def read_cameras_from_transforms(
    path: str, transforms_file: str, white_background: bool, extension: str = ".png"
) -> list[CameraInfo]:
    """Blender/NeRF-synthetic reader (reference:
    scene/dataset_readers.py:179-219): OpenGL->COLMAP axis flip, RGBA
    alpha-composited onto the background color."""
    from PIL import Image

    infos = []
    with open(os.path.join(path, transforms_file)) as f:
        contents = json.load(f)
    fov_x = contents["camera_angle_x"]
    for idx, frame in enumerate(contents["frames"]):
        file_path = frame["file_path"]
        cam_name = os.path.join(path, file_path + extension)
        if not os.path.exists(cam_name) and os.path.exists(os.path.join(path, file_path)):
            cam_name = os.path.join(path, file_path)
        c2w = np.array(frame["transform_matrix"], dtype=np.float64)
        c2w[:3, 1:3] *= -1  # OpenGL (y up, z back) -> COLMAP (y down, z fwd)
        w2c = np.linalg.inv(c2w)
        R = np.transpose(w2c[:3, :3])
        T = w2c[:3, 3]

        im = np.asarray(Image.open(cam_name).convert("RGBA"), dtype=np.float64) / 255.0
        bg = np.ones(3) if white_background else np.zeros(3)
        rgb = im[:, :, :3] * im[:, :, 3:4] + bg * (1.0 - im[:, :, 3:4])
        img_u8 = np.asarray(np.clip(rgb * 255.0, 0, 255), dtype=np.uint8)

        h, w = img_u8.shape[:2]
        fov_y = focal2fov(fov2focal(fov_x, w), h)
        infos.append(
            CameraInfo(
                uid=idx,
                R=R,
                T=T,
                fov_y=fov_y,
                fov_x=fov_x,
                image_path=cam_name,
                image_name=Path(cam_name).stem,
                width=w,
                height=h,
                image=img_u8,
            )
        )
    return infos


def read_nerf_synthetic_info(
    path: str, white_background: bool, eval_split: bool, extension: str = ".png"
) -> SceneInfo:
    """(reference: scene/dataset_readers.py:221-255)"""
    train = read_cameras_from_transforms(
        path, "transforms_train.json", white_background, extension
    )
    test = read_cameras_from_transforms(
        path, "transforms_test.json", white_background, extension
    )
    if not eval_split:
        train = train + test
        test = []

    norm = get_nerfpp_norm(train)
    ply_path = os.path.join(path, "points3d.ply")
    if not os.path.exists(ply_path):
        num_pts = 100_000
        rng = np.random.default_rng(0)
        xyz = rng.random((num_pts, 3)) * 2.6 - 1.3
        shs = rng.random((num_pts, 3)) / 255.0
        # In float32, as the JAX package's SH2RGB computes it.
        store_points_ply(ply_path, xyz, SH2RGB(shs.astype(np.float32)) * 255)
    try:
        pts, colors, normals = fetch_points_ply(ply_path)
        pcd = PointCloud(points=pts, colors=colors, normals=normals)
    except (FileNotFoundError, ValueError):
        pcd = None
    return SceneInfo(
        point_cloud=pcd,
        train_cameras=train,
        test_cameras=test,
        nerf_normalization=norm,
        ply_path=ply_path,
    )


scene_load_type_callbacks = {
    "Colmap": read_colmap_scene_info,
    "Blender": read_nerf_synthetic_info,
}


def load_scene_info(
    source_path: str,
    images: str | None = None,
    white_background: bool = False,
    eval_split: bool = False,
) -> SceneInfo:
    """Type dispatch (reference: scene/__init__.py:43-49)."""
    if os.path.exists(os.path.join(source_path, "sparse")):
        return read_colmap_scene_info(source_path, images, eval_split)
    if os.path.exists(os.path.join(source_path, "transforms_train.json")):
        return read_nerf_synthetic_info(source_path, white_background, eval_split)
    raise ValueError(f"Could not recognize scene type at {source_path}")
