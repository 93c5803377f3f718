"""ctypes bindings to the repository's native (C++) host library.

The port's own copy of `gsjax.native`'s loader: the Morton-sorted,
box-pruned exact 3-NN (scale init, as simple-knn) and the COLMAP
points3D.bin parser, both in native/ (simple_knn.cpp, colmap_reader.cpp).

The library is built on demand with native/Makefile into this package's
own directory, build/gsjax_torch/native-<hash of the sources>/, never into
native/build/: the JAX package builds there, and two builds into one file
could race. Each build goes to a temporary directory and is renamed into
place. The compiler is the environment's CXX, else (or when that one
cannot build the library, e.g. a toolchain without OpenMP) the g++ on
PATH. Every caller handles `load_native() is None` (no compiler, a failed
build, or GSJAX_NO_NATIVE set) and falls back to the torch path;
`unavailable_reason` then says why.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

import numpy as np

NATIVE_DIR = pathlib.Path(__file__).resolve().parents[1] / "native"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[1] / "build" / "gsjax_torch"
LIB_NAME = "libgsjax_native.so"

_lib: ctypes.CDLL | None = None
_tried = False
# Why the library is unavailable, once load_native() has failed.
unavailable_reason: str | None = None


def _lib_path() -> pathlib.Path:
    h = hashlib.sha256()
    for name in ("Makefile", "simple_knn.cpp", "colmap_reader.cpp"):
        h.update(name.encode() + (NATIVE_DIR / name).read_bytes())
    return BUILD_ROOT / f"native-{h.hexdigest()[:16]}" / LIB_NAME


def _compilers() -> list[str]:
    """The environment's CXX, then the g++ on PATH."""
    found = [os.environ.get("CXX"), shutil.which("g++")]
    return [c for i, c in enumerate(found) if c and c not in found[:i]]


def build() -> pathlib.Path:
    """Build the library if this source set has none yet; returns its path.
    Raises RuntimeError with each compiler's error when none builds it."""
    path = _lib_path()
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    errors = []
    for cxx in _compilers():
        tmp = tempfile.mkdtemp(dir=path.parent)
        try:
            done = subprocess.run(
                ["make", "-C", str(NATIVE_DIR), f"BUILD={tmp}", f"CXX={cxx}"],
                capture_output=True, text=True, timeout=300,
            )
            if done.returncode == 0:
                os.replace(os.path.join(tmp, LIB_NAME), path)
                return path
            errors.append(f"{cxx}: {done.stderr.strip()[-300:]}")
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    raise RuntimeError("; ".join(errors) or "no C++ compiler found")


def load_native() -> ctypes.CDLL | None:
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _tried, unavailable_reason
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if os.environ.get("GSJAX_NO_NATIVE"):
        unavailable_reason = "GSJAX_NO_NATIVE is set"
        return None
    try:
        lib = ctypes.CDLL(str(build()))
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:  # no toolchain, build failed
        unavailable_reason = f"{type(e).__name__}: {e}"
        print(f"[gsjax_torch.native] native library unavailable ({e}); "
              "using the torch path")
        return None
    lib.gsjax_knn_mean_dist2.restype = ctypes.c_int
    lib.gsjax_knn_mean_dist2.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.gsjax_points3d_count.restype = ctypes.c_int64
    lib.gsjax_points3d_count.argtypes = [ctypes.c_char_p]
    lib.gsjax_read_points3d.restype = ctypes.c_int64
    lib.gsjax_read_points3d.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_double),
    ]
    _lib = lib
    return _lib


def mean_knn_dist2_native(points: np.ndarray) -> np.ndarray | None:
    """[N,3] -> [N] mean squared 3-NN distance; None if native unavailable."""
    lib = load_native()
    if lib is None:
        return None
    pts = np.ascontiguousarray(points, dtype=np.float32)
    if pts.ndim != 2 or pts.shape[1] != 3:
        raise ValueError(f"points must be [N, 3], got {pts.shape}")
    out = np.empty(pts.shape[0], dtype=np.float32)
    rc = lib.gsjax_knn_mean_dist2(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        pts.shape[0],
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out if rc == 0 else None


def read_points3d_binary_native(path: str):
    """points3D.bin -> (xyz f64, rgb u8, err f64); None if unavailable."""
    lib = load_native()
    if lib is None:
        return None
    num = lib.gsjax_points3d_count(path.encode())
    if num < 0:
        return None
    xyz = np.empty((num, 3), np.float64)
    rgb = np.empty((num, 3), np.uint8)
    err = np.empty(num, np.float64)
    got = lib.gsjax_read_points3d(
        path.encode(),
        num,
        xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        err.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    if got != num:
        return None
    return xyz, rgb, err
