"""The backward's grad reduction taken apart on the card: the counterpart
of the repository's tools/probe_gradreduce.py, on the port's own pieces.

The port's reduction (render/composite.py::owner_sums) turns the
composite backward's per-instance gradients (P, 16), in tile order, into
per-Gaussian sums (N, 9):
  a. the inverse of the tile sort's permutation: one scatter;
  c. the regroup of the (P, 16) rows by owner: a row gather, by the
     library's index_select and by the hand-written row_gather kernel;
  g. the per-owner sums: the segment_sum kernel, and the library's
     segment_reduce computing the same sums;
  h. owner_sums end to end (a at int32 + the row_gather kernel +
     segment_sum).
The JAX package's pieces b, d, e and f are transposes between its
(16, P) layout and the gather's (P, 16) rows; the port keeps its rows
(P, 16) throughout, so they have no counterpart and are not timed.

At the bench scale (tools/common.bench_scene: P = 1,179,648 budget
slots, N = 500,000), on the binning of the origin view and seeded
normal gradients.

    python -m gsjax_torch.tools.probe_gradreduce

One JSON line per piece: device ms (torch.profiler) and event ms (CUDA
events), mean of ITERS; then one line naming the pieces not ported.
"""

from __future__ import annotations

import json

import torch

from gsjax_torch.render import kernels
from gsjax_torch.render.common import N_FIELDS, ROWS
from gsjax_torch.render.composite import owner_sums
from gsjax_torch.tools import kernels as tool_kernels

ITERS = 30
NOT_PORTED = {
    "b. transpose (16,P)->(P,16)": "the port's instance rows are (P, 16) already",
    "d. transpose back": "the port's instance rows are (P, 16) already",
    "e. take(inst_grads.T).T": "no transposed form: index_select of (P, 16) rows is c",
    "f. lane gather take(axis=1)": "no (16, P) layout to gather along",
}


def inverse_permutation(sorted_slot: torch.Tensor) -> torch.Tensor:
    """Piece a: the inverse of a permutation, by one collision-free scatter."""
    slot = sorted_slot.long()
    inverse = torch.empty_like(slot)
    inverse[slot] = torch.arange(slot.shape[0], device=slot.device)
    return inverse


def pieces(inst_grads, sorted_slot, gm_start) -> dict:
    """{piece: callable} on these inputs, each piece fed the one before's
    output (computed once here)."""
    inverse = inverse_permutation(sorted_slot)
    inverse32 = inverse.to(torch.int32)
    vals = inst_grads.index_select(0, inverse)
    lo, hi = int(gm_start[0]), int(gm_start[-1])
    lengths = gm_start.diff()
    return {
        "a. inverse permutation (scatter)": lambda: inverse_permutation(sorted_slot),
        "c. regroup (P,16) index_select": lambda: inst_grads.index_select(0, inverse),
        "c. regroup (P,16) row_gather kernel": lambda: tool_kernels.row_gather(
            inst_grads, inverse32),
        "g. segment_sum kernel": lambda: kernels.segment_sum(vals, gm_start),
        "g. segment_reduce (library)": lambda: torch.segment_reduce(
            vals[lo:hi], "sum", lengths=lengths),
        "h. owner_sums end to end": lambda: owner_sums(inst_grads, sorted_slot, gm_start),
    }


def run(binning, generator: torch.Generator, iters: int = ITERS) -> list[dict]:
    """The pieces timed on `binning` and seeded (P, ROWS) gradients."""
    from gsjax_torch.tools.common import cuda_ms, device_ms, with_refused

    p = binning.sorted_slot.shape[0]
    inst_grads = torch.randn((p, ROWS), generator=generator, device=generator.device)
    rows = []
    with torch.no_grad():
        for name, fn in pieces(inst_grads, binning.sorted_slot, binning.gm_start).items():
            rows.append(with_refused({"tool": "probe_gradreduce", "piece": name,
                                      "ms": device_ms(fn, None, iters),
                                      "event_ms": cuda_ms(fn, iters, warmup=2)}))
    rows.append({"tool": "probe_gradreduce", "instances": p,
                 "gaussians": binning.gm_start.shape[0] - 1, "fields": N_FIELDS,
                 "not_ported": NOT_PORTED})
    return rows


def main(argv=None) -> None:
    import argparse

    from gsjax_torch.render.api import depth_sorted_bins
    from gsjax_torch.render.preprocess import preprocess
    from gsjax_torch.tools.common import SH_DEGREE, bench_scene, require_card

    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    require_card("probe_gradreduce")
    params, aux, camera, cfg = bench_scene()
    with torch.no_grad():
        proj = preprocess(
            xyz=params.xyz, sh=params.get_features(), opacity=params.get_opacity(),
            scaling=params.get_scaling(), rotation=params.rotation, camera=camera,
            active_sh_degree=SH_DEGREE, alive=aux.alive)
        _, binning = depth_sorted_bins(proj, camera, cfg)
    print(json.dumps({"tool": "probe_gradreduce", "device": torch.cuda.get_device_name(0)}),
          flush=True)
    for row in run(binning, torch.Generator(device="cuda").manual_seed(0)):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
