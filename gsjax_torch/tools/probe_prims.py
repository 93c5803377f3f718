"""Micro-benchmarks of the instance-rate primitives on the card, at the
bench path's sizes (P = 1,179,648 instances, R = 524,288 rows, N = 500,000
Gaussians). The counterpart of the JAX package's tools/probe_prims.py:

  - row gathers of (N,16), (N,8) and (N,1) rows at P and of (N,16) rows
    at R: the library's index_select and the hand-written row_gather,
    each with int32 and int64 indices, and the int32 -> int64 index
    conversion the port's gathers pay (index_select(idx.long()));
  - scatter-adds (index_add_): one column N -> R and R -> P, (R, 2) rows
    -> P;
  - cumsums: int32 at P, uint32 bits at P (in int64, wrapped to 32 bits,
    as the port's rank prefix does), an (R, 10) array along axis 0;
  - sorts at P: one key; one key and one or two riders (stable sort and
    gathers); an f32 key and one rider at N;
  - both composite kernels on an all-empty tile_start (2040 tiles, 60
    across, 32x32): the fixed cost per tile.

    python -m gsjax_torch.tools.probe_prims

Inputs are made on the card from a seeded generator. One JSON line per
probe: device ms (profiler, all of its device work) and event ms (CUDA
events), mean of REPS, and for the gathers the bytes they must move.
"""

from __future__ import annotations

import json

import torch

from gsjax_torch.render import kernels
from gsjax_torch.tools import kernels as tool_kernels
from gsjax_torch.tools.common import cuda_ms, device_ms, require_card

P = 1_179_648
R = 524_288
N = 500_000
REPS = 30
_M32 = 0xFFFFFFFF


def gather_bytes(idx, width: int) -> int:
    """Bytes a row gather at indices idx must move: each index read once,
    each distinct source row it names read once (a row below 8 floats still
    costs its 32-byte sector) and each output row written once."""
    rows_read = int(torch.unique(idx).numel())
    return idx.numel() * (idx.element_size() + width * 4) + rows_read * max(width * 4, 32)


def probe(device="cuda", reps: int = REPS) -> list[dict]:
    gen = torch.Generator(device=device).manual_seed(0)

    def randint(hi, n):
        return torch.randint(0, hi, (n,), generator=gen, device=device,
                             dtype=torch.int32)

    idx_p, idx_r = randint(N, P), randint(N, R)
    perm_p = torch.randperm(P, generator=gen, device=device).to(torch.int32)
    f16 = torch.randn((N, 16), generator=gen, device=device)
    f8, f1 = f16[:, :8].contiguous(), f16[:, :1].contiguous()
    starts = torch.sort(randint(P, R)).values
    starts_n = torch.sort(randint(R, N)).values
    vals_n = torch.randn(N, generator=gen, device=device)
    u32 = torch.arange(P, dtype=torch.int32, device=device)
    keys_p = randint(2**30, P)
    ones_p = torch.ones(P, dtype=torch.int32, device=device)
    i32r10 = torch.zeros((R, 10), dtype=torch.int32, device=device)

    rows = []

    def timed(name, fn, **extra):
        with torch.no_grad():
            rows.append(dict({"tool": "probe_prims", "probe": name,
                              "ms": device_ms(fn, None, reps),
                              "event_ms": cuda_ms(fn, reps, warmup=2)}, **extra))

    for label, src, idx in (("(N,16)@P", f16, idx_p), ("(N,8)@P", f8, idx_p),
                            ("(N,1)@P", f1, idx_p), ("(N,16)@R", f16, idx_r)):
        for ix in (idx, idx.long()):
            kind = "int32" if ix.dtype == torch.int32 else "int64"
            nbytes = gather_bytes(ix, src.shape[1])
            timed(f"index_select {label} {kind}",
                  lambda s=src, i=ix: torch.index_select(s, 0, i), bytes=nbytes)
            timed(f"row_gather {label} {kind}",
                  lambda s=src, i=ix: tool_kernels.row_gather(s, i), bytes=nbytes)
        timed(f"index_select(idx.long()) {label}",
              lambda s=src, i=idx: s.index_select(0, i.long()))
    timed("int32 -> int64 indices @P", lambda: idx_p.long())

    timed("scatter-add 1col N->R", lambda: torch.zeros(
        R, dtype=torch.int32, device=device).index_add_(0, starts_n, ones_p[:N]))
    timed("scatter-add 1col R->P", lambda: torch.zeros(
        P, dtype=torch.int32, device=device).index_add_(0, starts, ones_p[:R]))
    ones_r2 = torch.ones((R, 2), dtype=torch.int32, device=device)
    timed("scatter-add (R,2)rows->P", lambda: torch.zeros(
        (P, 2), dtype=torch.int32, device=device).index_add_(0, starts, ones_r2))

    timed("cumsum int32 P", lambda: torch.cumsum(ones_p, 0, dtype=torch.int32))
    timed("cumsum uint32 P", lambda: kernels._as_i32(
        torch.cumsum(u32.to(torch.int64) & _M32, 0)))
    timed("cumsum (R,10) axis0", lambda: torch.cumsum(i32r10, 0, dtype=torch.int32))

    timed("sort 1 key @P", lambda: torch.sort(keys_p))

    def sort_riders(keys, *riders):
        order = torch.sort(keys, stable=True).indices
        return [r.index_select(0, order) for r in riders]

    timed("sort 1key+1rider @P", lambda: sort_riders(keys_p, perm_p))
    timed("sort 1key+2riders @P", lambda: sort_riders(keys_p, perm_p, perm_p))
    timed("sort f32key+1rider @N", lambda: sort_riders(vals_n, perm_p[:N]))

    # The fixed cost per tile of the composite kernels: an all-empty
    # tile_start walks no instance, so the run is block scheduling, state
    # set-up and the output writes. 1080p in 32x32 tiles is 2040 tiles.
    geo = dict(n_tiles=2040, tiles_x=60, tile_w=32, tile_h=32)
    inst = torch.zeros((1024, 16), device=device)
    empty = torch.zeros(geo["n_tiles"] + 1, dtype=torch.int32, device=device)
    cot = torch.zeros((geo["n_tiles"], 1024, 4), device=device)
    timed("fwd kernel, empty stream (fixed/tile)",
          lambda: kernels.composite_forward(inst, empty, **geo))
    timed("bwd kernel, empty stream (fixed/tile)",
          lambda: kernels.composite_backward(inst, empty, cot, **geo))
    return rows


def main() -> None:
    require_card("probe_prims")
    print(json.dumps({"device": torch.cuda.get_device_name(0)}), flush=True)
    for row in probe():
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
