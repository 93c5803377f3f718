"""The render path's hand-written CUDA kernels, their wrappers and their
plain PyTorch versions.

Five kernels, one per Pallas TPU kernel of the JAX package's render and
its backward (gsjax/render/pallas_kernels.py):

  composite_forward   <- composite_forward_pallas   (csrc/composite_forward.cu)
  row_engine          <- row_engine_pallas          (csrc/row_engine.cu)
  rank_prefix         <- rank_prefix_pallas         (csrc/rank_prefix.cu)
  composite_backward  <- composite_backward_pallas  (csrc/composite_backward.cu)
  segment_sum         <- segment_sum_pallas         (csrc/segment_sum.cu)

and the row gather of the JAX package's profiling tools
(tools/probe_prims.py::pallas_row_gather, csrc/row_gather.cu), which
carries the render path's budget- and capacity-sized row gathers: the
depth permute of the (N, 12) fields and its backward
(binning.permute_rows), the (P, 16) instance stream
(common.build_inst_data) and the backward's owner regroup
(composite.owner_sums). It takes binning's int32 indices as they are.

The two composite kernels take their walks from the same header
(csrc/composite_walk.cuh) and are built with the same flags, so the
backward replays the forward's skip and termination decisions bit for bit.
Each warp of theirs covers a compact block of its tile's pixels and culls
the rows none of its pixels can take (tiled.footprint_box; the forward on
tiles of 512 pixels or more), without changing a bit of the output. The library also holds the profiling tools'
kernels (composite_probes.cu: the probes and the two composite kernels'
reference twins without the cull), whose wrappers are in
gsjax_torch/tools/kernels.py.

Each wrapper dispatches on the device of its tensors: a CUDA tensor
launches the kernel (or raises), a CPU tensor runs the plain version of the
same name with a `_plain` suffix. There is no fallback from one to the
other. Each kernel launch adds one to `launch_counts[name]`.

The sources are compiled at first use with nvcc into one shared library
with a plain C interface, loaded with ctypes. The build lives under
build/gsjax_torch/<hash of sources and flags>/ at the repository root; one
nvcc process per source runs in parallel, then one link.

uint32 values (packed deltas, rank prefixes) travel as int32 tensors
holding the same bits; the plain versions do that arithmetic in int64 and
wrap to 32 bits, exactly as the kernels' uint32 arithmetic wraps.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import torch

from gsjax_torch.render import tiled

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[2] / "build" / "gsjax_torch"
LIB_NAME = "libgsjax_torch_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-prec-div=true", "-prec-sqrt=true",
    "-Xptxas", "-v",
)
# Per-source extra flags. The row engine turns floats into tile indices and
# must agree bit for bit with its plain version: no fused multiply-adds.
SOURCES = {
    "composite_forward.cu": (),
    "composite_backward.cu": (),
    "row_engine.cu": ("--fmad=false",),
    "rank_prefix.cu": (),
    "segment_sum.cu": (),
    "row_gather.cu": (),
    "composite_probes.cu": (),
}

KERNEL_NAMES = (
    "composite_forward", "row_engine", "rank_prefix", "composite_backward",
    "segment_sum", "row_gather",
)
launch_counts = {name: 0 for name in KERNEL_NAMES}

_M32 = 0xFFFFFFFF
_lib: ctypes.CDLL | None = None


def reset_launch_counts() -> None:
    for name in KERNEL_NAMES:
        launch_counts[name] = 0


# --- build ------------------------------------------------------------------


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _build_key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name, extra in sorted(SOURCES.items()):
        h.update(name.encode() + " ".join(extra).encode())
        h.update((CSRC / name).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    return h.hexdigest()[:16]


def build() -> pathlib.Path:
    """Compile the kernels if this source set has no library yet; returns
    the library path. The compiler's report (registers, spills per kernel)
    is kept beside it in build.log."""
    out_dir = BUILD_ROOT / _build_key()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}-{time.monotonic_ns()}"
    objs, procs = [], []
    for name, extra in SOURCES.items():
        obj = out_dir / f"{name}.{tag}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *extra, "-c", str(CSRC / name), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    logs = [p.communicate()[0] for p in procs]
    log = "".join(f"== {n}\n{text}" for n, text in zip(SOURCES, logs))
    failed = [n for n, p in zip(SOURCES, procs) if p.returncode]
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
    tmp = out_dir / f"{LIB_NAME}.{tag}"
    link = subprocess.run(
        [nvcc, *NVCC_FLAGS[:2], "-shared", "-Xcompiler", "-fPIC",
         *map(str, objs), "-o", str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    (out_dir / "build.log").write_text(log + link.stdout)
    os.replace(tmp, lib_path)
    for obj in objs:
        obj.unlink()
    return lib_path


def build_log() -> str:
    return (BUILD_ROOT / _build_key() / "build.log").read_text()


def library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gsjt_composite_forward.argtypes = [p, p, p, p, i, i, i, i, p]
        lib.gsjt_composite_backward.argtypes = [p, p, p, p, i, i, i, i, p]
        lib.gsjt_row_engine.argtypes = [p, i, p, i, i, i, i, i, p, p, p, p, p, p]
        lib.gsjt_row_engine_scratch_words.argtypes = [i, i]
        lib.gsjt_row_engine_scratch_words.restype = ctypes.c_longlong
        lib.gsjt_rank_prefix.argtypes = [p, i, p, i, i, i, p, p]
        lib.gsjt_segment_sum.argtypes = [p, p, p, i, p]
        lib.gsjt_row_gather.argtypes = [p, p, i, p, ctypes.c_longlong, i, p]
        # The profiling tools' kernels (gsjax_torch/tools/kernels.py).
        lib.gsjt_outpath.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
        lib.gsjt_blockout.argtypes = [p, p, p, p, i, i, i, i, p]
        lib.gsjt_variant.argtypes = [p, i, p, p, p, i, i, i, i, i, ctypes.c_float, p]
        lib.gsjt_composite_forward_nocull.argtypes = [p, p, p, p, i, i, i, i, p]
        lib.gsjt_composite_backward_nocull.argtypes = [p, p, p, p, i, i, i, i, p]
        for name in (*KERNEL_NAMES, "outpath", "blockout", "variant",
                     "composite_forward_nocull", "composite_backward_nocull"):
            getattr(lib, f"gsjt_{name}").restype = ctypes.c_int
        _lib = lib
    return _lib


def current_stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _check(name: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    launch_counts[name] += 1


def route(name: str, *tensors: torch.Tensor) -> bool:
    """True for the kernel (all CUDA tensors on one card), False for the
    plain version (all CPU tensors); raises otherwise."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices: {devices}")
    dev = devices.pop()
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev.type == "cuda"


def require(name: str, t: torch.Tensor, dtype: torch.dtype, shape) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


# --- 32-bit integer helpers for the plain versions -------------------------


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the int64 value of its low 32 bits read as int32."""
    return ((x + 2**31) & _M32) - 2**31


def _as_i32(x: torch.Tensor) -> torch.Tensor:
    return _wrap32(x).to(torch.int32)


def _f2i(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int64 holding the int32 conversion as the card's
    cvt.rzi.s32.f32 (and XLA) does it: truncate, saturate, NaN -> 0."""
    x = torch.nan_to_num(x, nan=0.0).clamp(-(2.0**31), 2.0**31)
    return x.to(torch.int64).clamp(-(2**31), 2**31 - 1)


# --- composite_forward -------------------------------------------------------

composite_forward_plain = tiled.composite_tiles

# One block per tile: one thread per pixel up to 1024 pixels, and up to
# four pixels per thread above (csrc/composite_walk.cuh), so 64x64 tiles.
MAX_TILE_PIXELS = 4096


def composite_forward(
    inst: torch.Tensor,
    tile_start: torch.Tensor,
    *,
    n_tiles: int,
    tiles_x: int,
    tile_w: int,
    tile_h: int,
    chunk: int = 128,
    strips: int = 1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Front-to-back compositing of each tile's instance range.

    inst (P, ROWS) f32 instance rows, tile_start (n_tiles + 1,) int32.
    Returns tile_color (n_tiles, PIX, 3) and tile_t (n_tiles, PIX) f32.
    `chunk` and `strips` shape only the plain walk, never the output.
    """
    if not route("composite_forward", inst, tile_start):
        return composite_forward_plain(
            inst, tile_start, n_tiles=n_tiles, tiles_x=tiles_x, tile_w=tile_w,
            tile_h=tile_h, chunk=chunk, strips=strips,
        )
    pix = tile_pixels("composite_forward", tile_w, tile_h)
    require("composite_forward inst", inst, torch.float32, (inst.shape[0], 16))
    require("composite_forward tile_start", tile_start, torch.int32, (n_tiles + 1,))
    tile_color = torch.empty((n_tiles, pix, 3), dtype=torch.float32, device=inst.device)
    tile_t = torch.empty((n_tiles, pix), dtype=torch.float32, device=inst.device)
    if n_tiles == 0:
        return tile_color, tile_t
    err = library().gsjt_composite_forward(
        inst.data_ptr(), tile_start.data_ptr(), tile_color.data_ptr(),
        tile_t.data_ptr(), n_tiles, tiles_x, tile_w, tile_h, current_stream(),
    )
    _check("composite_forward", err)
    return tile_color, tile_t


# --- composite_backward ------------------------------------------------------

composite_backward_plain = tiled.composite_backward_tiles


def composite_backward(
    inst: torch.Tensor,
    tile_start: torch.Tensor,
    cot: torch.Tensor,
    *,
    n_tiles: int,
    tiles_x: int,
    tile_w: int,
    tile_h: int,
    chunk: int = 128,
    strips: int = 1,
) -> torch.Tensor:
    """Per-instance gradients of the composite (see
    tiled.composite_backward_tiles).

    inst (P, ROWS) f32, tile_start (n_tiles + 1,) int32, cot (n_tiles, PIX,
    4) f32 [dC_r, dC_g, dC_b, A'_0]. Returns (P, ROWS) f32 with columns
    [dmx, dmy, dca, dcb, dcc, dr, dg, db, dop, 0...]; rows no tile walk
    reaches are zero. `chunk` and `strips` shape only the plain walk.
    """
    if not route("composite_backward", inst, tile_start, cot):
        return composite_backward_plain(
            inst, tile_start, cot, n_tiles=n_tiles, tiles_x=tiles_x,
            tile_w=tile_w, tile_h=tile_h, chunk=chunk, strips=strips,
        )
    pix = tile_pixels("composite_backward", tile_w, tile_h)
    require("composite_backward inst", inst, torch.float32, (inst.shape[0], 16))
    require("composite_backward tile_start", tile_start, torch.int32, (n_tiles + 1,))
    require("composite_backward cot", cot, torch.float32, (n_tiles, pix, 4))
    # Zero-filled: the kernel writes only the rows its walks reach.
    grads = torch.zeros_like(inst)
    if n_tiles == 0:
        return grads
    err = library().gsjt_composite_backward(
        inst.data_ptr(), tile_start.data_ptr(), cot.data_ptr(),
        grads.data_ptr(), n_tiles, tiles_x, tile_w, tile_h, current_stream(),
    )
    _check("composite_backward", err)
    return grads


def tile_pixels(name: str, tile_w: int, tile_h: int) -> int:
    """Pixels of a tile the composite walks (csrc/composite_walk.cuh)
    take; raises ValueError above MAX_TILE_PIXELS."""
    pix = tile_w * tile_h
    if pix > MAX_TILE_PIXELS:
        raise ValueError(
            f"{name}: tiles of {pix} pixels exceed the kernels' "
            f"{MAX_TILE_PIXELS} (64x64)"
        )
    return pix


# --- segment_sum -------------------------------------------------------------


def segment_sum_plain(vals: torch.Tensor, gm_start: torch.Tensor) -> torch.Tensor:
    """out[o] = sum of rows [gm_start[o], gm_start[o+1]) of vals (P, F),
    for each of the N owners of gm_start (N + 1,) (nondecreasing); an empty
    run sums to 0."""
    n = gm_start.shape[0] - 1
    out = torch.zeros((n, vals.shape[1]), dtype=vals.dtype, device=vals.device)
    if n == 0:
        return out
    lo, hi = int(gm_start[0]), int(gm_start[-1])
    slots = torch.arange(lo, hi, dtype=gm_start.dtype, device=vals.device)
    owner = torch.searchsorted(gm_start[1:].contiguous(), slots, right=True)
    return out.index_add_(0, owner, vals[lo:hi])


def segment_sum(vals: torch.Tensor, gm_start: torch.Tensor) -> torch.Tensor:
    """Per-owner sums of an owner-grouped stream (see segment_sum_plain).

    vals (P, 16) f32 rows grouped into ascending-owner runs; gm_start
    (N + 1,) int32 run boundaries within [0, P]. Returns (N, 16) f32.
    """
    if not route("segment_sum", vals, gm_start):
        return segment_sum_plain(vals, gm_start)
    require("segment_sum vals", vals, torch.float32, (vals.shape[0], 16))
    n = gm_start.shape[0] - 1
    require("segment_sum gm_start", gm_start, torch.int32, (n + 1,))
    out = torch.empty((n, 16), dtype=torch.float32, device=vals.device)
    if n == 0:
        return out
    err = library().gsjt_segment_sum(
        vals.data_ptr(), gm_start.data_ptr(), out.data_ptr(), n, current_stream(),
    )
    _check("segment_sum", err)
    return out


# --- row_gather --------------------------------------------------------------

GATHER_WIDTHS = (1, 8, 12, 16)


def row_gather_plain(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return src.index_select(0, idx.long())


def row_gather(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i] = src[idx[i]]: rows of src (N, W) f32, W in GATHER_WIDTHS, at
    idx (P,) int32 or int64, each in [0, N) (not checked on the card).
    Returns (P, W) f32. Other widths and index types raise on either
    device."""
    n, w = src.shape
    if w not in GATHER_WIDTHS:
        raise ValueError(f"row_gather: width {w} not in {GATHER_WIDTHS}")
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"row_gather: indices must be int32 or int64, got {idx.dtype}")
    if not route("row_gather", src, idx):
        return row_gather_plain(src, idx)
    require("row_gather src", src, torch.float32, (n, w))
    p = idx.shape[0]
    require("row_gather idx", idx, idx.dtype, (p,))
    if w % 4 == 0 and src.data_ptr() % 16:
        raise ValueError("row_gather: src must be 16-byte aligned")
    out = torch.empty((p, w), dtype=torch.float32, device=src.device)
    if p == 0:
        return out
    err = library().gsjt_row_gather(
        src.data_ptr(), idx.data_ptr(), idx.element_size(), out.data_ptr(), p,
        w, current_stream(),
    )
    _check("row_gather", err)
    return out


# --- rank_prefix -------------------------------------------------------------


def rank_prefix_plain(
    start: torch.Tensor,
    delta: torch.Tensor,
    *,
    budget: int,
    plus_iota: bool = False,
    init: int = 0,
    dcum: torch.Tensor | None = None,
) -> torch.Tensor:
    """out[s] = init + (s if plus_iota) + sum_{r: start_r <= s} delta_r,
    mod 2^32, for s in [0, budget); `start` sorted ascending (entries >=
    budget never count). With dcum = cumsum(delta) mod 2^32 given, the sum
    is dcum[k(s) - 1] for k(s) = #{r : start_r <= s}."""
    if dcum is None:
        dcum = torch.cumsum(delta.to(torch.int64) & _M32, dim=0)
    dcum = dcum.to(torch.int64) & _M32
    s = torch.arange(budget, dtype=torch.int32, device=start.device)
    k = torch.searchsorted(start, s, right=True)
    dcum = torch.cat([dcum.new_zeros(1), dcum])  # dcum[0] = empty sum
    out = dcum[k] + init
    if plus_iota:
        out = out + s
    return _as_i32(out)


def rank_prefix(
    start: torch.Tensor,
    delta: torch.Tensor,
    *,
    budget: int,
    plus_iota: bool = False,
    init: int = 0,
    dcum: torch.Tensor | None = None,
) -> torch.Tensor:
    """The sorted-run rank expansion (see rank_prefix_plain).

    start (R,) int32 sorted; delta (R,) int32 holding uint32 bits; dcum
    (R,) optional precomputed cumsum(delta) mod 2^32. Returns (budget,)
    int32 holding the uint32 results.
    """
    extra = () if dcum is None else (dcum,)
    if not route("rank_prefix", start, delta, *extra):
        return rank_prefix_plain(
            start, delta, budget=budget, plus_iota=plus_iota, init=init,
            dcum=dcum,
        )
    r = start.shape[0]
    require("rank_prefix start", start, torch.int32, (r,))
    require("rank_prefix delta", delta, torch.int32, (r,))
    if dcum is None:
        # R-rate, outside the kernel, as the reference wrapper does.
        dcum = torch.cumsum(delta.to(torch.int64) & _M32, dim=0)
        dcum = _as_i32(dcum)
    require("rank_prefix dcum", dcum, torch.int32, (r,))
    out = torch.empty(budget, dtype=torch.int32, device=start.device)
    if budget == 0:
        return out
    if budget + r >= 2**31:
        raise ValueError(f"rank_prefix: budget + R = {budget + r} must stay below 2^31")
    err = library().gsjt_rank_prefix(
        start.data_ptr(), r, dcum.data_ptr(), budget, init, int(plus_iota),
        out.data_ptr(), current_stream(),
    )
    _check("rank_prefix", err)
    return out


# --- row_engine --------------------------------------------------------------

# The row-engine table's columns (a (16, N) int32 array; floats travel as
# their bits).
TAB_RSTART, TAB_REND, TAB_Y0, TAB_X0, TAB_X1 = 0, 1, 2, 3, 4
TAB_MX, TAB_MY, TAB_CA, TAB_CB, TAB_CC, TAB_QMAX, TAB_G = 5, 6, 7, 8, 9, 10, 11


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root, as IEEE and the card's
    sqrt.rn.f32 give it. torch's vectorised CPU sqrt of float32 is one ulp
    off for some inputs (about 0.6 % of uniform ones), so on the CPU this
    takes the float64 root rounded to float32, which is exact (53 >= 2 *
    24 + 2 bits); on the card torch.sqrt is already exact."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def row_x_interval(y0s, y1s, ca, cb, cc, qmax):
    """Exact x-extent of {d : q(d) <= qmax} clipped to the strip dy in
    [y0s, y1s] (all relative to the Gaussian center): the ellipse's global
    x-extremes (dy* = -cb x / cc) or the strip edges, in closed form.
    Returns (x_lo, x_hi, nonempty)."""
    eps = 1e-12

    def clip(v, lo, hi):
        return torch.minimum(torch.maximum(v, lo), hi)

    safe_ca = torch.clamp(ca, min=eps)
    safe_cc = torch.clamp(cc, min=eps)
    det = torch.clamp(ca * cc - cb * cb, min=eps)
    y_span = sqrt_rn(torch.clamp(qmax * safe_ca / det, min=0.0))
    lo_y = torch.maximum(y0s, -y_span)
    hi_y = torch.minimum(y1s, y_span)
    nonempty = lo_y <= hi_y
    x_star = sqrt_rn(torch.clamp(qmax * safe_cc / det, min=0.0))
    ys_hi = clip(-cb * x_star / safe_cc, lo_y, hi_y)
    ys_lo = clip(cb * x_star / safe_cc, lo_y, hi_y)
    disc_hi = qmax * safe_ca - det * ys_hi * ys_hi
    disc_lo = qmax * safe_ca - det * ys_lo * ys_lo
    x_hi = (-cb * ys_hi + sqrt_rn(torch.clamp(disc_hi, min=0.0))) / safe_ca
    x_lo = (-cb * ys_lo - sqrt_rn(torch.clamp(disc_lo, min=0.0))) / safe_ca
    return x_lo, x_hi, nonempty


def row_tiles(ty, mx, my, ca, cb, cc, qmax, x0, x1, valid, *,
              tiles_x: int, tile_w: int, tile_h: int):
    """Instances of the tile rows ty (int64) of Gaussians at (mx, my):
    the tiles tx whose pixel span [tx*tile_w, tx*tile_w + tile_w-1] meets
    the row's exact x-interval, clamped to the rect's [x0, x1). Returns
    (counts, tile_base = ty * tiles_x + first tx) as int64 holding the
    int32 results (with int32 wraparound, as on the card); counts are 0
    where `valid` is false."""
    tsx, tsy = float(tile_w), float(tile_h)
    y0s = ty.to(torch.float32) * tsy - my
    x_lo, x_hi, nonempty = row_x_interval(y0s, y0s + (tsy - 1.0), ca, cb, cc, qmax)
    rx0 = _f2i(torch.ceil((mx + x_lo - (tsx - 1.0)) / tsx))
    rx1 = _wrap32(_f2i(torch.floor((mx + x_hi) / tsx)) + 1)
    rx0 = torch.maximum(rx0, x0.long())
    rx1 = torch.minimum(rx1, x1.long())
    counts = torch.where(
        valid & nonempty, _wrap32(rx1 - rx0).clamp(min=0), torch.zeros_like(rx0)
    )
    return counts, _wrap32(ty * tiles_x + rx0)


def row_engine_plain(
    table: torch.Tensor,
    total_rows: torch.Tensor,
    *,
    budget: int,
    tiles_x: int,
    tile_w: int,
    tile_h: int,
    bits_tile: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused binning level 1.

    Row j in [0, budget) belongs to the Gaussian g with rstart_g <= j <
    rend_g (none when j >= total_rows: its table columns read as zero).
    For each row: its tile row ty, the exact tile x-interval [rx0, rx1) of
    the alpha >= 1/255 ellipse in that pixel strip, the instance count
    (0 past min(total_rows, budget)), istart = exclusive cumsum of the
    counts, u = ((g << bits_tile) | (ty * tiles_x + rx0)) - istart and
    delta = u - u_prev, both mod 2^32 (u_prev = 0 before row 0), so that
    u = cumsum(delta). Returns (istart, delta, u) (budget,) int32 and the
    total instance count [] int32.
    """
    n = table.shape[1]
    j = torch.arange(budget, dtype=torch.int32, device=table.device)
    g = torch.searchsorted(table[TAB_RSTART].contiguous(), j, right=True) - 1
    cols = table[:, g.clamp(0, n - 1)]
    owned = (cols[TAB_RSTART] <= j) & (j < cols[TAB_REND])
    cols = torch.where(owned, cols, torch.zeros_like(cols))

    def f32(c):
        return cols[c].view(torch.float32)

    ty = cols[TAB_Y0].long() + (j.long() - cols[TAB_RSTART].long())
    counts, tile_base = row_tiles(
        ty, f32(TAB_MX), f32(TAB_MY), f32(TAB_CA), f32(TAB_CB), f32(TAB_CC),
        f32(TAB_QMAX), cols[TAB_X0], cols[TAB_X1],
        j < torch.clamp(total_rows, max=budget),
        tiles_x=tiles_x, tile_w=tile_w, tile_h=tile_h,
    )
    icum = torch.cumsum(counts, dim=0)
    istart = icum - counts
    packed = ((cols[TAB_G].long() << bits_tile) | tile_base) & _M32
    u = (packed - istart) & _M32
    u_prev = torch.cat([u.new_zeros(1), u[:-1]])
    delta = (u - u_prev) & _M32
    total = icum[-1] if budget else icum.new_zeros(())
    return _as_i32(istart), _as_i32(delta), _as_i32(u), _as_i32(total)


def row_engine(
    table: torch.Tensor,
    total_rows: torch.Tensor,
    *,
    budget: int,
    tiles_x: int,
    tile_w: int,
    tile_h: int,
    bits_tile: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused binning level 1 (see row_engine_plain).

    table (16, N) int32 with the TAB_* columns; total_rows [] int32, the
    true (unclamped) row count.
    """
    if not route("row_engine", table, total_rows):
        return row_engine_plain(
            table, total_rows, budget=budget, tiles_x=tiles_x, tile_w=tile_w,
            tile_h=tile_h, bits_tile=bits_tile,
        )
    n = table.shape[1]
    require("row_engine table", table, torch.int32, (16, n))
    require("row_engine total_rows", total_rows, torch.int32, ())
    dev = table.device
    if budget == 0:
        istart, delta, u = torch.empty((3, 0), dtype=torch.int32, device=dev)
        return istart, delta, u, torch.zeros((), dtype=torch.int32, device=dev)
    if budget + n >= 2**31:
        raise ValueError(f"row_engine: budget + N = {budget + n} must stay below 2^31")
    # One allocation: the kernel's look-back status words and ticket (8-byte
    # words, cleared by the C call), then istart, delta and u. The total has
    # its own: binning returns it as num_instances, which outlives the step,
    # and a view of the buffer would hold all 3 * budget words alive.
    lib = library()
    words = 2 * lib.gsjt_row_engine_scratch_words(budget, n)
    buf = torch.empty(words + 3 * budget, dtype=torch.int32, device=dev)
    istart, delta, u = buf[words:].view(3, budget).unbind(0)
    total = torch.empty((), dtype=torch.int32, device=dev)
    err = lib.gsjt_row_engine(
        table.data_ptr(), n, total_rows.data_ptr(), budget, tiles_x, tile_w,
        tile_h, bits_tile, buf.data_ptr(), istart.data_ptr(), delta.data_ptr(),
        u.data_ptr(), total.data_ptr(), current_stream(),
    )
    _check("row_engine", err)
    return istart, delta, u, total
