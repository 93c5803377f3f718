"""COLMAP sparse-reconstruction parsers (binary and text).

The port's copy of `gsjax.data.colmap`: the same readers and writers, the
same arrays and bytes.

Implemented from the public COLMAP file-format specification
(https://colmap.github.io/format.html); behavioral contract pinned by the
reference's loader (reference: scene/colmap_loader.py). Parsing is
numpy-vectorized where the format allows (points3D), streaming struct reads
elsewhere (variable-length image records).
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

# (model_id, name, num_params) — reference: scene/colmap_loader.py:24-36.
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
MODEL_NAME_TO_ID = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


@dataclasses.dataclass
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclasses.dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray  # (w, x, y, z)
    tvec: np.ndarray
    camera_id: int
    name: str


def qvec2rotmat(qvec: np.ndarray) -> np.ndarray:
    """(w,x,y,z) quaternion -> rotation matrix
    (reference: scene/colmap_loader.py:43-53)."""
    w, x, y, z = qvec
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def rotmat2qvec(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> (w,x,y,z) quaternion via the symmetric eigenvector
    method (reference: scene/colmap_loader.py:55-66)."""
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = R.flat
    K = (
        np.array(
            [
                [Rxx - Ryy - Rzz, 0, 0, 0],
                [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
                [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
                [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz],
            ]
        )
        / 3.0
    )
    eigvals, eigvecs = np.linalg.eigh(K)
    qvec = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    if qvec[0] < 0:
        qvec *= -1
    return qvec


# --------------------------------------------------------------------------
# binary readers
# --------------------------------------------------------------------------


def read_cameras_binary(path: str) -> dict[int, ColmapCamera]:
    cameras = {}
    with open(path, "rb") as f:
        data = f.read()
    off = 0
    (num,) = struct.unpack_from("<Q", data, off)
    off += 8
    for _ in range(num):
        cam_id, model_id, width, height = struct.unpack_from("<iiQQ", data, off)
        off += 24
        name, n_params = CAMERA_MODELS[model_id]
        params = np.frombuffer(data, dtype="<f8", count=n_params, offset=off)
        off += 8 * n_params
        cameras[cam_id] = ColmapCamera(
            id=cam_id, model=name, width=int(width), height=int(height),
            params=np.array(params),
        )
    return cameras


def read_images_binary(path: str) -> dict[int, ColmapImage]:
    images = {}
    with open(path, "rb") as f:
        data = f.read()
    off = 0
    (num,) = struct.unpack_from("<Q", data, off)
    off += 8
    for _ in range(num):
        vals = struct.unpack_from("<idddddddi", data, off)
        off += 64
        image_id, camera_id = vals[0], vals[8]
        qvec = np.array(vals[1:5])
        tvec = np.array(vals[5:8])
        end = data.index(b"\x00", off)
        name = data[off:end].decode("utf-8")
        off = end + 1
        (n_pts,) = struct.unpack_from("<Q", data, off)
        off += 8 + 24 * n_pts  # skip (x, y, point3D_id) triples
        images[image_id] = ColmapImage(
            id=image_id, qvec=qvec, tvec=tvec, camera_id=camera_id, name=name
        )
    return images


def read_points3d_binary(path: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (xyz [N,3] f64, rgb [N,3] u8, error [N] f64).

    Uses the native C++ parser when available (native/colmap_reader.cpp) —
    the pure-Python loop below is the portable fallback/oracle."""
    from gsjax_torch.native import read_points3d_binary_native

    native = read_points3d_binary_native(path)
    if native is not None:
        return native
    with open(path, "rb") as f:
        data = f.read()
    off = 0
    (num,) = struct.unpack_from("<Q", data, off)
    off += 8
    xyz = np.empty((num, 3), np.float64)
    rgb = np.empty((num, 3), np.uint8)
    err = np.empty(num, np.float64)
    for i in range(num):
        vals = struct.unpack_from("<QdddBBBd", data, off)
        off += 43
        xyz[i] = vals[1:4]
        rgb[i] = vals[4:7]
        err[i] = vals[7]
        (track_len,) = struct.unpack_from("<Q", data, off)
        off += 8 + 8 * track_len
    return xyz, rgb, err


# --------------------------------------------------------------------------
# text readers
# --------------------------------------------------------------------------


def _data_lines(path: str):
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                yield line


def read_cameras_text(path: str) -> dict[int, ColmapCamera]:
    cameras = {}
    for line in _data_lines(path):
        parts = line.split()
        cam_id = int(parts[0])
        cameras[cam_id] = ColmapCamera(
            id=cam_id,
            model=parts[1],
            width=int(parts[2]),
            height=int(parts[3]),
            params=np.array([float(p) for p in parts[4:]]),
        )
    return cameras


def read_images_text(path: str) -> dict[int, ColmapImage]:
    """Each image record is an image line followed by a POINTS2D line; the
    POINTS2D line may be EMPTY (zero observations), so records are paired on
    RAW lines, not by parity over non-blank lines (reference reads the next
    line unconditionally, scene/colmap_loader.py:254-268)."""
    images = {}
    with open(path, "r") as f:
        expect_points = False
        for raw in f:
            line = raw.strip()
            if line.startswith("#"):
                continue
            if expect_points:
                expect_points = False  # points2D line (possibly empty)
                continue
            if not line:
                continue
            parts = line.split()
            image_id = int(parts[0])
            images[image_id] = ColmapImage(
                id=image_id,
                qvec=np.array([float(p) for p in parts[1:5]]),
                tvec=np.array([float(p) for p in parts[5:8]]),
                camera_id=int(parts[8]),
                name=parts[9],
            )
            expect_points = True
    return images


def read_points3d_text(path: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    xyzs, rgbs, errs = [], [], []
    for line in _data_lines(path):
        parts = line.split()
        xyzs.append([float(p) for p in parts[1:4]])
        rgbs.append([int(p) for p in parts[4:7]])
        errs.append(float(parts[7]))
    return (
        np.array(xyzs, np.float64).reshape(-1, 3),
        np.array(rgbs, np.uint8).reshape(-1, 3),
        np.array(errs, np.float64),
    )


# --------------------------------------------------------------------------
# binary writers (fixtures/tests; also lets convert.py round-trip)
# --------------------------------------------------------------------------


def write_cameras_binary(cameras: dict[int, ColmapCamera], path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for cam in cameras.values():
            mid = MODEL_NAME_TO_ID[cam.model]
            f.write(struct.pack("<iiQQ", cam.id, mid, cam.width, cam.height))
            f.write(np.asarray(cam.params, "<f8").tobytes())


def write_images_binary(images: dict[int, ColmapImage], path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(
                struct.pack(
                    "<idddddddi",
                    im.id,
                    *[float(v) for v in im.qvec],
                    *[float(v) for v in im.tvec],
                    im.camera_id,
                )
            )
            f.write(im.name.encode("utf-8") + b"\x00")
            f.write(struct.pack("<Q", 0))


_POINT3D_RECORD = np.dtype([
    ("id", "<u8"), ("xyz", "<f8", (3,)), ("rgb", "u1", (3,)), ("err", "<f8"),
    ("track_len", "<u8"),
])


def write_points3d_binary(
    xyz: np.ndarray, rgb: np.ndarray, err: np.ndarray, path: str
) -> None:
    """Point i gets id i and an empty track; the records are written as one
    packed array (the bytes of `struct.pack("<QdddBBBd")` + `"<Q"` each)."""
    rgb = np.asarray(rgb)
    if rgb.size and (rgb.min() < 0 or rgb.max() > 255):
        raise ValueError("rgb values must lie in [0, 255]")
    rec = np.zeros(xyz.shape[0], dtype=_POINT3D_RECORD)
    rec["id"] = np.arange(xyz.shape[0])
    rec["xyz"] = xyz
    rec["rgb"] = rgb.astype(np.int64)
    rec["err"] = err
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", xyz.shape[0]))
        f.write(rec.tobytes())
