"""The profiling tools' hand-written CUDA kernels, their wrappers and their
plain PyTorch versions.

Four kernels, one per Pallas TPU kernel of the JAX package's profiling
tools:

  row_gather  <- tools/probe_prims.py::pallas_row_gather  (csrc/row_gather.cu)
  outpath     <- tools/probe_outpath.py::run              (csrc/composite_probes.cu)
  blockout    <- tools/ablate_kernels.py::run_blockout    (csrc/composite_probes.cu)
  variant     <- tools/ablate_kernels.py::run_variant     (csrc/composite_probes.cu)

and the main composite kernels' reference twins, which have no TPU
counterpart (csrc/composite_probes.cu):

  composite_forward_nocull, composite_backward_nocull
      render/kernels.py's composite_forward and composite_backward with the
      cull off: the same arguments, outputs and warp map, every staged row
      walked by every warp. The main kernels equal them bit for bit; their
      plain versions are the main kernels'.

The three composite probes are the main path's walks (csrc/composite_walk.cuh)
with one part taken out, so each is held to its plain version here and
times its part on the card. They launch as the kernels that ship (the
forward's warp map, strips and cull; the backward's four pixels per
thread, warp map and cull), so each takes apart the kernel the render path
runs: outpath "ship" holds the forward's colour and T bit for bit,
blockout is the forward bit for bit, replay_fwd its red at pixel 0 bit
for bit.
Notation: tile t has the stream range
[i0, i1) = [tile_start[t], tile_start[t+1]); its chunks are the 128-row
blocks c0 = i0 // 128 ... c0 + n - 1 that meet the range (n = 0 for an
empty range); pixel 0 is the tile's top-left pixel.

As in render/kernels.py, each wrapper dispatches on the device of its
tensors (CUDA: the kernel or an error; CPU: the plain version of the same
name with a `_plain` suffix) and each launch adds one to
`launch_counts[name]`. The kernels live in the render path's library.
row_gather carries the render path's row gathers too, so its wrapper,
plain version and launch counter are render/kernels.py's, named here.
"""

from __future__ import annotations

import torch

from gsjax_torch.render import kernels as render_kernels
from gsjax_torch.render import tiled
from gsjax_torch.render.common import ROW_MX, ROW_R
from gsjax_torch.render.kernels import (  # noqa: F401  (the tools' names)
    GATHER_WIDTHS,
    current_stream,
    library,
    require,
    route,
    row_gather,
    row_gather_plain,
)

KERNEL_NAMES = ("outpath", "blockout", "variant",
                "composite_forward_nocull", "composite_backward_nocull")
launch_counts = {name: 0 for name in KERNEL_NAMES}

OUTPATH_VARIANTS = ("ship", "notrans")
# The forward's most strips a tile (csrc/composite_walk.cuh kMaxStrips):
# outpath "notrans" keeps a partial sum per strip.
MAX_STRIPS = 4
SEMANTICS = ("arbitrary", "parallel")
# The ablation tool's variants and the port's bwd_noshfl; any other name
# is the backward without its write, as in the tool's fall-through
# (ablate_kernels.py:221-236).
TOOL_VARIANTS = ("dma_only", "fwd_nodep", "fwd_nocond", "replay_fwd", "bwd_nowrite")
VARIANTS = (*TOOL_VARIANTS, "bwd_noshfl")
_VARIANT_IDS = {"dma_only": 0, "fwd_nodep": 1, "fwd_nocond": 2, "replay_fwd": 3,
                "bwd_noshfl": 5}
_BWD_NOWRITE, _BWD_NOSHFL = 4, 5
# The backward variant's cotangent, the tool's d_color and suffix seed:
# cot[..., 0:3] = 1e-6 and cot[..., 3] = 1e-3 (the port's [dC, A'_0]).
BWD_D_COLOR, BWD_SUFFIX = 1e-6, 1e-3
CHUNK = 128


def reset_launch_counts() -> None:
    for name in KERNEL_NAMES:
        launch_counts[name] = 0


def _check(name: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    launch_counts[name] += 1


def _geometry(n_tiles, tiles_x, tile_w, tile_h) -> dict:
    return dict(n_tiles=n_tiles, tiles_x=tiles_x, tile_w=tile_w, tile_h=tile_h)


def _stream_args(name, inst, tile_start, n_tiles):
    require(f"{name} inst", inst, torch.float32, (inst.shape[0], 16))
    require(f"{name} tile_start", tile_start, torch.int32, (n_tiles + 1,))


# --- outpath and blockout: the forward with other outputs ----------------------


def outpath_plain(inst, tile_start, variant, *, n_tiles, tiles_x, tile_w, tile_h):
    color, trans = tiled.composite_tiles(
        inst, tile_start, **_geometry(n_tiles, tiles_x, tile_w, tile_h))
    out = torch.zeros((n_tiles, 8, tile_w * tile_h), dtype=torch.float32,
                      device=inst.device)
    if variant == "ship":
        out[:, 0:3] = color.transpose(1, 2)
        out[:, 3] = trans
    else:
        out[:, 0, 0] = color.sum(dim=(1, 2)) + trans.sum(dim=1)
    return out


def outpath(
    inst: torch.Tensor,
    tile_start: torch.Tensor,
    variant: str = "ship",
    *,
    n_tiles: int,
    tiles_x: int,
    tile_w: int,
    tile_h: int,
) -> torch.Tensor:
    """The exact forward of each tile written into a (T, 8, PIX) f32
    block, the TPU forward's transposed output layout. "ship": rows 0-2 the
    premultiplied color, row 3 the transmittance, rows 4-7 zero.
    "notrans": the block is zero but [t, 0, 0] = sum_pix (r + g + b) +
    sum_pix T, the same writes without the layout work; on the card the
    tile's strips' sums add in strip order, the same bits on every call."""
    if variant not in OUTPATH_VARIANTS:
        raise ValueError(f"outpath: variant {variant!r} not in {OUTPATH_VARIANTS}")
    geo = _geometry(n_tiles, tiles_x, tile_w, tile_h)
    if not route("outpath", inst, tile_start):
        return outpath_plain(inst, tile_start, variant, **geo)
    pix = render_kernels.tile_pixels("outpath", tile_w, tile_h)
    _stream_args("outpath", inst, tile_start, n_tiles)
    out = torch.empty((n_tiles, 8, pix), dtype=torch.float32, device=inst.device)
    if n_tiles == 0:
        return out
    scratch = (0, 0)  # null: "ship" takes no scratch
    if variant == "notrans":
        partials = torch.empty(n_tiles * MAX_STRIPS, dtype=torch.float32,
                               device=inst.device)
        arrivals = torch.zeros(n_tiles, dtype=torch.int32, device=inst.device)
        scratch = (partials.data_ptr(), arrivals.data_ptr())
    err = library().gsjt_outpath(
        inst.data_ptr(), tile_start.data_ptr(), out.data_ptr(), *scratch, n_tiles,
        tiles_x, tile_w, tile_h, int(variant == "notrans"), current_stream(),
    )
    _check("outpath", err)
    return out


def blockout_plain(inst, tile_start, semantics="arbitrary", *, n_tiles,
                   tiles_x, tile_w, tile_h):
    color, trans = tiled.composite_tiles(
        inst, tile_start, **_geometry(n_tiles, tiles_x, tile_w, tile_h))
    return color, trans[..., None]


def blockout(
    inst: torch.Tensor,
    tile_start: torch.Tensor,
    semantics: str = "arbitrary",
    *,
    n_tiles: int,
    tiles_x: int,
    tile_w: int,
    tile_h: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The exact forward with pixel-major outputs: color (T, PIX, 3) and
    transmittance (T, PIX, 1) f32. `semantics` is the TPU grid's dimension
    semantics, "arbitrary" or "parallel"; a CUDA grid has no such setting,
    so it is accepted and ignored."""
    if semantics not in SEMANTICS:
        raise ValueError(f"blockout: semantics {semantics!r} not in {SEMANTICS}")
    geo = _geometry(n_tiles, tiles_x, tile_w, tile_h)
    if not route("blockout", inst, tile_start):
        return blockout_plain(inst, tile_start, semantics, **geo)
    pix = render_kernels.tile_pixels("blockout", tile_w, tile_h)
    _stream_args("blockout", inst, tile_start, n_tiles)
    color = torch.empty((n_tiles, pix, 3), dtype=torch.float32, device=inst.device)
    trans = torch.empty((n_tiles, pix, 1), dtype=torch.float32, device=inst.device)
    if n_tiles == 0:
        return color, trans
    err = library().gsjt_blockout(
        inst.data_ptr(), tile_start.data_ptr(), color.data_ptr(),
        trans.data_ptr(), n_tiles, tiles_x, tile_w, tile_h, current_stream(),
    )
    _check("blockout", err)
    return color, trans


# --- variant: the ablations ------------------------------------------------------


def bwd_nowrite_cot(n_tiles: int, pix: int, device) -> torch.Tensor:
    """The backward variant's cotangent (n_tiles, PIX, 4)."""
    seed = torch.tensor([BWD_D_COLOR] * 3 + [BWD_SUFFIX], dtype=torch.float32,
                        device=device)
    return seed.expand(n_tiles, pix, 4).contiguous()


def _chunk_heads(tile_start, n_tiles):
    """Per tile, the stream position of each chunk's first row (T, J) and
    the mask of the tile's chunks j < n."""
    i0, i1 = tile_start[:-1].long(), tile_start[1:].long()
    c0 = i0 // CHUNK
    n = torch.where(i1 > i0, (i1 + CHUNK - 1) // CHUNK - c0, 0)
    steps = int(n.max()) if n_tiles else 0
    j = torch.arange(steps, device=tile_start.device)
    return (c0[:, None] + j) * CHUNK, j < n[:, None]


def _nodep_plain(inst, tile_start, geo):
    """fwd_nodep: sum over chunks j of red_j + 1e-20 T_j at pixel 0, each
    chunk's in-range instances walked from T = 1, done = 0."""
    out = torch.zeros(geo["n_tiles"], dtype=torch.float32, device=inst.device)
    for t0, t1, px, py, chunks in tiled._tile_batches(inst, tile_start, chunk=CHUNK,
                                                       **geo):
        px0, py0 = px[:, :1], py[:, :1]
        ones = torch.ones((t1 - t0, 1, 1), dtype=torch.float32, device=inst.device)
        for _, mask, f in chunks:
            *_, alpha = tiled._chunk_falloff(f, px0, py0, mask)
            e_excl, _, live, t_next = tiled.exact_step(ones, ones < 0, alpha)
            red = (alpha * e_excl * live * f[:, None, :, ROW_R]).sum(-1)[:, 0]
            out[t0:t1] += torch.where(mask.any(dim=-1), red + 1e-20 * t_next[:, 0, 0], 0.0)
    return out


def _chunk_head_sums(grads, tile_start, n_tiles):
    """Per tile, the sum of grads[k, ROW_MX] over its stream positions k in
    [i0, i1) with k % 128 == 0, (T,) f32."""
    k = torch.arange(0, grads.shape[0], CHUNK, device=grads.device)
    tile = torch.searchsorted(tile_start, k.to(torch.int32), right=True) - 1
    valid = (k >= tile_start[0]) & (k < tile_start[-1]) & (tile < n_tiles)
    out = torch.zeros(n_tiles, dtype=torch.float32, device=grads.device)
    return out.index_add_(0, tile[valid], grads[k[valid], ROW_MX])


def lane0_cot(n_tiles: int, tile_w: int, tile_h: int, device) -> torch.Tensor:
    """bwd_noshfl's cotangent in plain form: the backward variant's, zero
    but at the pixels that lane 0 of a warp holds under the main kernels'
    warp map. A pixel with a zero cotangent adds nothing to any gradient,
    so the plain backward on it is the sum of the lane-0 pixels' terms."""
    cot = bwd_nowrite_cot(n_tiles, tile_w * tile_h, device)
    lane0 = tiled.warp_pixels(tile_w, tile_h, device=device)[:, 0]
    keep = torch.zeros(tile_w * tile_h, dtype=torch.bool, device=device)
    keep[lane0[lane0 >= 0]] = True
    return torch.where(keep[None, :, None], cot, 0.0)


def variant_plain(inst, tile_start, name, *, n_tiles, tiles_x, tile_w, tile_h):
    geo = _geometry(n_tiles, tiles_x, tile_w, tile_h)
    if name == "dma_only":
        heads, mask = _chunk_heads(tile_start, n_tiles)
        x = inst[heads.clamp(max=max(inst.shape[0] - 1, 0)), ROW_MX]
        out = 1e-20 * torch.where(mask, x, 0.0).sum(dim=1)
    elif name == "fwd_nodep":
        out = _nodep_plain(inst, tile_start, geo)
    elif name in ("fwd_nocond", "replay_fwd"):
        out = tiled.composite_tiles(inst, tile_start, **geo)[0][:, 0, 0]
    else:
        cot = (lane0_cot(n_tiles, tile_w, tile_h, inst.device) if name == "bwd_noshfl"
               else bwd_nowrite_cot(n_tiles, tile_w * tile_h, inst.device))
        grads = tiled.composite_backward_tiles(inst, tile_start, cot, **geo)
        out = _chunk_head_sums(grads, tile_start, n_tiles)
    return out.reshape(n_tiles, 1, 1)


def variant(
    inst: torch.Tensor,
    tile_start: torch.Tensor,
    name: str,
    *,
    n_tiles: int,
    tiles_x: int,
    tile_w: int,
    tile_h: int,
) -> torch.Tensor:
    """One f32 per tile from an ablated walk, (T, 1, 1):

      dma_only    1e-20 * sum_{j<n} inst[(c0 + j) * 128, ROW_MX] (unmasked:
                  a chunk's first row counts even before i0)
      fwd_nodep   sum_j (red_j + 1e-20 T_j) at pixel 0, chunk j's in-range
                  instances composited from T = 1, done = 0, each chunk
                  independently
      fwd_nocond  the exact forward's red at pixel 0, walked with no stop
                  (each pixel visits the whole range; done masks)
      replay_fwd  the exact forward's red at pixel 0, with its stops
      bwd_noshfl  as bwd_nowrite, G the gradients of the pixels at lane 0
                  of each warp of the main kernels' warp map: the main
                  backward without its warp butterflies. The kernel writes
                  G whole; the wrapper reduces it.
      any other   (bwd_nowrite) sum over k in [i0, i1), k % 128 == 0, of
                  G[k, 0], G = composite_backward with cot = [1e-6, 1e-6,
                  1e-6, 1e-3] per pixel, no gradient written
    """
    geo = _geometry(n_tiles, tiles_x, tile_w, tile_h)
    if not route("variant", inst, tile_start):
        return variant_plain(inst, tile_start, name, **geo)
    pix = render_kernels.tile_pixels("variant", tile_w, tile_h)
    _stream_args("variant", inst, tile_start, n_tiles)
    vid = _VARIANT_IDS.get(name, _BWD_NOWRITE)
    cot = (bwd_nowrite_cot(n_tiles, pix, inst.device)
           if vid in (_BWD_NOWRITE, _BWD_NOSHFL) else None)
    out = torch.empty((n_tiles, 1, 1), dtype=torch.float32, device=inst.device)
    if n_tiles == 0:
        return out
    # bwd_noshfl writes the whole (P, 16) gradient rows, zero-filled here.
    dest = torch.zeros_like(inst) if vid == _BWD_NOSHFL else out
    err = library().gsjt_variant(
        inst.data_ptr(), inst.shape[0], tile_start.data_ptr(),
        None if cot is None else cot.data_ptr(), dest.data_ptr(), n_tiles,
        tiles_x, tile_w, tile_h, vid, 0.0, current_stream(),
    )
    _check("variant", err)
    if vid == _BWD_NOSHFL:
        return _chunk_head_sums(dest, tile_start, n_tiles).reshape(n_tiles, 1, 1)
    return out


# --- the main composite kernels' twins without the cull -------------------------

composite_forward_nocull_plain = render_kernels.composite_forward_plain
composite_backward_nocull_plain = render_kernels.composite_backward_plain


def composite_forward_nocull(
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
    """render/kernels.py's composite_forward with the cull off; the same
    arguments and outputs, the same bits."""
    if not route("composite_forward_nocull", inst, tile_start):
        return composite_forward_nocull_plain(
            inst, tile_start, n_tiles=n_tiles, tiles_x=tiles_x, tile_w=tile_w,
            tile_h=tile_h, chunk=chunk, strips=strips,
        )
    pix = render_kernels.tile_pixels("composite_forward_nocull", tile_w, tile_h)
    _stream_args("composite_forward_nocull", inst, tile_start, n_tiles)
    color = torch.empty((n_tiles, pix, 3), dtype=torch.float32, device=inst.device)
    trans = torch.empty((n_tiles, pix), dtype=torch.float32, device=inst.device)
    if n_tiles == 0:
        return color, trans
    err = library().gsjt_composite_forward_nocull(
        inst.data_ptr(), tile_start.data_ptr(), color.data_ptr(),
        trans.data_ptr(), n_tiles, tiles_x, tile_w, tile_h, current_stream(),
    )
    _check("composite_forward_nocull", err)
    return color, trans


def composite_backward_nocull(
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
    """render/kernels.py's composite_backward with the cull off; the same
    arguments and outputs, the same gradients (up to the sign of a zero)."""
    if not route("composite_backward_nocull", inst, tile_start, cot):
        return composite_backward_nocull_plain(
            inst, tile_start, cot, n_tiles=n_tiles, tiles_x=tiles_x,
            tile_w=tile_w, tile_h=tile_h, chunk=chunk, strips=strips,
        )
    pix = render_kernels.tile_pixels("composite_backward_nocull", tile_w, tile_h)
    _stream_args("composite_backward_nocull", inst, tile_start, n_tiles)
    require("composite_backward_nocull cot", cot, torch.float32, (n_tiles, pix, 4))
    grads = torch.zeros_like(inst)
    if n_tiles == 0:
        return grads
    err = library().gsjt_composite_backward_nocull(
        inst.data_ptr(), tile_start.data_ptr(), cot.data_ptr(),
        grads.data_ptr(), n_tiles, tiles_x, tile_w, tile_h, current_stream(),
    )
    _check("composite_backward_nocull", err)
    return grads
