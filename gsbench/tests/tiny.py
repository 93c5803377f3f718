"""A cell's path at a size the CPU holds: the configuration's shapes with
fewer Gaussians (its sky shell kept), 16 images of 64x48; the traffic's
windows and warm-up shortened. The tests start the budgets small
(BUDGETS): the port's defaults make a plain CPU step take seconds."""

from __future__ import annotations

from gsbench import spec


def config(name: str) -> dict:
    cfg = spec.config(name)
    assumed = dict(cfg["assumed"], focal_px=60.0)
    return {"gaussians": 3000, "images": 16, "width": 64, "height": 48, "assumed": assumed}


TRAFFIC = {"warmup_window": 2, "max_window": 4, "check_frames": 3, "profiled_requests": 3,
           "warmup_seconds": 0.5}
BUDGETS = {"max_instances": 8192, "max_rows": 8192}
