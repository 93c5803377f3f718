"""PLY I/O — the interop contract with existing 3DGS viewers and tools.

The port's copy of `gsjax.data.ply`: both packages write the same bytes
for the same model. Self-contained (no plyfile dependency): a minimal
binary/ascii PLY codec plus the exact Gaussian attribute schema of the
reference: x,y,z,nx,ny,nz,f_dc_0..2,f_rest_0..{3K-4},opacity,scale_0..2,
rot_0..3, all float32, binary little-endian (reference:
scene/gaussian_model.py:177-256), and the seed point-cloud schema
x,y,z,nx,ny,nz,red,green,blue (reference: scene/dataset_readers.py:107-130).
"""

from __future__ import annotations

import os

import numpy as np
import torch

_PLY_TO_NP = {
    "float": "<f4",
    "float32": "<f4",
    "double": "<f8",
    "float64": "<f8",
    "uchar": "u1",
    "uint8": "u1",
    "char": "i1",
    "int8": "i1",
    "ushort": "<u2",
    "uint16": "<u2",
    "short": "<i2",
    "int16": "<i2",
    "uint": "<u4",
    "uint32": "<u4",
    "int": "<i4",
    "int32": "<i4",
}
_NP_TO_PLY = {"f4": "float", "f8": "double", "u1": "uchar", "i4": "int"}


def read_ply(path: str) -> dict[str, np.ndarray]:
    """Read the 'vertex' element of a PLY file into {property: array}."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        count = 0
        props: list[tuple[str, str]] = []
        in_vertex = False
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unexpected EOF in header")
            tok = line.decode("ascii").strip().split()
            if not tok:
                continue
            if tok[0] == "format":
                fmt = tok[1]
            elif tok[0] == "element":
                in_vertex = tok[1] == "vertex"
                if in_vertex:
                    count = int(tok[2])
            elif tok[0] == "property" and in_vertex:
                if tok[1] == "list":
                    raise ValueError("list properties unsupported for vertex")
                props.append((tok[2], _PLY_TO_NP[tok[1]]))
            elif tok[0] == "end_header":
                break
        if fmt == "ascii":
            rows = np.loadtxt(f, max_rows=count, ndmin=2)
            return {
                name: rows[:, i].astype(dt) for i, (name, dt) in enumerate(props)
            }
        if fmt == "binary_big_endian":
            props = [(n, d.replace("<", ">")) for n, d in props]
        dtype = np.dtype([(n, d) for n, d in props])
        data = np.frombuffer(f.read(dtype.itemsize * count), dtype=dtype, count=count)
        return {name: np.ascontiguousarray(data[name]) for name, _ in props}


def write_ply(path: str, columns: list[tuple[str, np.ndarray]]) -> None:
    """Write a binary little-endian PLY with a single vertex element."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    n = len(columns[0][1])
    dtype = np.dtype([(name, arr.dtype.str) for name, arr in columns])
    rec = np.empty(n, dtype=dtype)
    for name, arr in columns:
        rec[name] = arr
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    for name, arr in columns:
        header.append(f"property {_NP_TO_PLY[arr.dtype.str.lstrip('<>|')]} {name}")
    header.append("end_header\n")
    with open(path, "wb") as f:
        f.write("\n".join(header).encode("ascii"))
        f.write(rec.tobytes())


# --------------------------------------------------------------------------
# Gaussian model snapshots (reference: scene/gaussian_model.py:191-256)
# --------------------------------------------------------------------------


def _numpy(x, dtype=None) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def save_gaussian_ply(path: str, params, alive=None) -> None:
    """Write the trained model in the reference PLY schema.

    params: GaussianParams (tensors on any device); alive: optional [C]
    bool mask, tensor or array (only alive rows are written — the
    reference has no dead rows).
    """
    xyz = _numpy(params.xyz, np.float32)
    f_dc = _numpy(params.features_dc, np.float32)  # [C,1,3]
    f_rest = _numpy(params.features_rest, np.float32)  # [C,K-1,3]
    opacity = _numpy(params.opacity, np.float32)
    scaling = _numpy(params.scaling, np.float32)
    rotation = _numpy(params.rotation, np.float32)
    if alive is not None:
        mask = _numpy(alive, bool)
        xyz, f_dc, f_rest = xyz[mask], f_dc[mask], f_rest[mask]
        opacity, scaling, rotation = opacity[mask], scaling[mask], rotation[mask]
    n = xyz.shape[0]
    # Feature flattening is channel-major ((transpose(1,2).flatten) in the
    # reference: f_dc_i indexes channels; f_rest flattened as [3, K-1]).
    f_dc_flat = f_dc.transpose(0, 2, 1).reshape(n, -1)
    f_rest_flat = f_rest.transpose(0, 2, 1).reshape(n, -1)

    cols: list[tuple[str, np.ndarray]] = []
    for i, name in enumerate("xyz"):
        cols.append((name, xyz[:, i]))
    for name in ("nx", "ny", "nz"):
        cols.append((name, np.zeros(n, np.float32)))
    for i in range(f_dc_flat.shape[1]):
        cols.append((f"f_dc_{i}", f_dc_flat[:, i]))
    for i in range(f_rest_flat.shape[1]):
        cols.append((f"f_rest_{i}", f_rest_flat[:, i]))
    cols.append(("opacity", opacity[:, 0]))
    for i in range(3):
        cols.append((f"scale_{i}", scaling[:, i]))
    for i in range(4):
        cols.append((f"rot_{i}", rotation[:, i]))
    write_ply(path, cols)


def load_gaussian_ply(path: str) -> dict[str, np.ndarray]:
    """Load a reference-schema model PLY.

    Returns dict with xyz [N,3], features_dc [N,1,3], features_rest
    [N,K-1,3], opacity [N,1], scaling [N,3], rotation [N,4] (raw values).
    """
    v = read_ply(path)
    n = v["x"].shape[0]
    xyz = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float32)
    f_dc = np.stack([v[f"f_dc_{i}"] for i in range(3)], axis=1).astype(np.float32)
    rest_names = sorted(
        (k for k in v if k.startswith("f_rest_")), key=lambda s: int(s.split("_")[-1])
    )
    n_rest = len(rest_names)
    k_rest = n_rest // 3
    f_rest = np.stack([v[k] for k in rest_names], axis=1).astype(np.float32)
    # stored channel-major [3, K-1] -> [K-1, 3]
    f_rest = f_rest.reshape(n, 3, k_rest).transpose(0, 2, 1)
    scale_names = sorted(
        (k for k in v if k.startswith("scale_")), key=lambda s: int(s.split("_")[-1])
    )
    rot_names = sorted(
        (k for k in v if k.startswith("rot_")), key=lambda s: int(s.split("_")[-1])
    )
    return {
        "xyz": xyz,
        "features_dc": f_dc.reshape(n, 1, 3),
        "features_rest": f_rest.astype(np.float32),
        "opacity": v["opacity"].astype(np.float32).reshape(n, 1),
        "scaling": np.stack([v[k] for k in scale_names], axis=1).astype(np.float32),
        "rotation": np.stack([v[k] for k in rot_names], axis=1).astype(np.float32),
    }


# --------------------------------------------------------------------------
# seed point clouds (reference: scene/dataset_readers.py:107-130)
# --------------------------------------------------------------------------


def store_points_ply(path: str, xyz: np.ndarray, rgb: np.ndarray) -> None:
    """rgb in [0,255]."""
    n = xyz.shape[0]
    cols: list[tuple[str, np.ndarray]] = []
    for i, name in enumerate("xyz"):
        cols.append((name, xyz[:, i].astype(np.float32)))
    for name in ("nx", "ny", "nz"):
        cols.append((name, np.zeros(n, np.float32)))
    for i, name in enumerate(("red", "green", "blue")):
        cols.append((name, rgb[:, i].astype(np.uint8)))
    write_ply(path, cols)


def fetch_points_ply(path: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (points [N,3], colors [N,3] in [0,1], normals [N,3])."""
    v = read_ply(path)
    pts = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float64)
    colors = (
        np.stack([v["red"], v["green"], v["blue"]], axis=1).astype(np.float64) / 255.0
    )
    if "nx" in v:
        normals = np.stack([v["nx"], v["ny"], v["nz"]], axis=1).astype(np.float64)
    else:
        normals = np.zeros_like(pts)
    return pts, colors, normals
