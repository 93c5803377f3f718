"""What the per-layer readers (metrics/<metric>.py) share. Each takes the
record of a traced run and returns its metric, or None where the run
holds nothing to read (a share of a roofline or a peak is never 0 for
want of a reading)."""

from __future__ import annotations

from gsbench import workmodel
from gsbench.session import port_kernel


def kernel_roofline(record: dict, kernel: str, work) -> float | None:
    """% of the kernel's device time in the profiled session that its
    roofline bound over the profiled views takes. work(view) gives the
    (FLOPs, bytes) one view needs."""
    ops = [op for op in record.get("ops", ()) if port_kernel(op.name) == kernel]
    views = record.get("views")
    if not ops or not views:
        return None
    bound = sum(workmodel.roofline_s(*work(v)) for v in views)
    return 100.0 * bound / sum(op.seconds for op in ops)


def library_ms(record: dict, per: str) -> float | None:
    """Device ms, per profiled step or request, of every operation that is
    not one of the port's own kernels."""
    ops = record.get("ops")
    n = record.get(per)
    if not ops or not n:
        return None
    return 1e3 * sum(op.seconds for op in ops if port_kernel(op.name) is None) / n


def mfu(record: dict, flops) -> float | None:
    """% of the chip's float32 peak that the profiled steps' or requests'
    work, by the work model, takes of the host-clock time each took
    (`item_s`). flops(view) per view."""
    views = record.get("views")
    item_s = record.get("item_s")
    if not views or not item_s or not record.get("ops"):
        return None
    mean = sum(flops(v) for v in views) / len(views)
    return 100.0 * mean / (item_s * workmodel.F32_FLOP_PER_S)


def idle_share(record: dict) -> float | None:
    """% of the profiled stretch's host-clock time in which no operation
    ran on the device."""
    window = record.get("session_window_s")
    if not window or not record.get("ops"):
        return None
    return 100.0 * (1.0 - record["busy_s"] / window)


def fill(record: dict) -> float | None:
    """Mean % of the instance budget that the profiled steps' or
    requests' exact (Gaussian, tile) pairs took."""
    fills = record.get("fills")
    return 100.0 * sum(fills) / len(fills) if fills else None
