"""What the drivers share: the device record, the starting budgets, the
reference's view of a camera, the norm gaps of the output check, and the
port's counters."""

from __future__ import annotations

import statistics
import sys

import torch

from gsbench import scene
from gsbench.reference import render as ref_render


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def device_record(dev: torch.device, peak: int) -> dict:
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1,
                "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": int(peak)}


def synchronize(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def raster_config(cfg: dict):
    """The port's default RasterConfig at the configuration's tile size:
    the budgets a run starts from, before the port's rule grows them."""
    from gsjax_torch.config import RasterConfig

    return RasterConfig(tile_size=cfg["tile_size"])


def ref_cam(views: scene.Views, i: int) -> ref_render.Cam:
    return ref_render.Cam(view=views.views[i], full_proj=views.full_projs[i],
                          center=views.centers[i], tan_fovx=views.tan_fovx[i],
                          tan_fovy=views.tan_fovy[i], width=views.width, height=views.height)


def launches() -> dict[str, int]:
    """The port's kernel launches executed so far (graph replays included)."""
    from gsjax_torch.render.graph import executed_launches

    return executed_launches()


def norm_gap(prog: dict[str, torch.Tensor], ref: dict[str, torch.Tensor]) -> tuple[float, dict]:
    """Worst leaf of |‖prog‖ - ‖ref‖| / max(‖ref‖, the median leaf's ‖ref‖),
    over the leaves whose reference norm is at least a thousandth of the
    median leaf's (a leaf below that moves by rounding alone)."""
    rn = {k: float(torch.linalg.vector_norm(v.double())) for k, v in ref.items()}
    pn = {k: float(torch.linalg.vector_norm(prog[k].double())) for k in ref}
    med = statistics.median(rn.values())
    gaps = {k: abs(pn[k] - rn[k]) / max(rn[k], med) for k in ref if rn[k] >= 1e-3 * med}
    return max(gaps.values()), {"gaps": gaps, "prog": pn, "ref": rn}


def pair_counts(params: dict, views: scene.Views, indices, degree: int) -> list[dict]:
    """The reference's pair counts of views `indices` at these parameters
    (the work model's inputs)."""
    bg = torch.zeros(3, device=views.views.device)
    out = []
    for i in indices:
        f = ref_render.render(params, ref_cam(views, i), bg, degree)
        out.append({"live_pairs": f.live_pairs, "tile_pairs": f.tile_pairs,
                    "visible": f.visible, "pixels": views.width * views.height})
    if out:
        mean = {k: sum(v[k] for v in out) / len(out) for k in out[0]}
        log(f"profiled views: {len(out)}, mean " + ", ".join(
            f"{k} {v:.0f}" for k, v in mean.items()))
    return out
