"""Profiler sessions that record every kernel the card runs in them, and
what the benchmark reads from them.

A copy of the port's session logic (gsjax_torch/utils/profiler.py and
tools/common.whole_session), frozen here so that a later change to the
program cannot change how it is measured:

* a session opens with the profiler's warm-up step (schedule warm-up 1,
  active 1) in which LEAD_IN short kernels run traced but unrecorded
  (torch.profiler loses a session's first launches after a training run
  in the same process), and the host idles PAUSE_S after the recorded
  step starts and before it ends (the profiler keeps only device records
  whose times, moved onto the host's clock, fall inside the window);
* a session is whole when the device events of each of the port's
  kernels number the launches the port counted while it recorded
  (`executed_launches`, graph replays included); a session that is not
  whole is refused and the work profiled again, at most TRIES sessions.
"""

from __future__ import annotations

import dataclasses
import time

LEAD_IN = 64
LEAD_IN_KERNEL = "spin_kernel"  # torch.cuda._sleep's kernel
PAUSE_S = 0.02
TRIES = 3
# A range's span on the device timeline, not an operation of the work.
MARKERS = ("ProfilerStep", "gsjt:")

# The port's kernels by its launch counters' names, and a substring of the
# CUDA kernel names the profiler gives each (gsjax_torch/csrc/*.cu).
PORT_KERNELS = {
    "composite_forward": "composite_forward_kernel",
    "row_engine": "row_engine_",
    "rank_prefix": "rank_prefix_kernel",
    "composite_backward": "composite_backward_kernel",
    "segment_sum": "segment_sum_kernel",
}


class IncompleteSession(RuntimeError):
    pass


@dataclasses.dataclass(frozen=True)
class DeviceOp:
    name: str
    start_s: float
    end_s: float

    @property
    def seconds(self) -> float:
        return self.end_s - self.start_s


def is_marker(name: str) -> bool:
    return name.startswith(MARKERS) or LEAD_IN_KERNEL in name


def port_kernel(name: str) -> str | None:
    """The port's kernel a device operation of this name is, or None."""
    for k, sub in PORT_KERNELS.items():
        if sub in name:
            return k
    return None


def _start():
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    prof = profile(activities=[ProfilerActivity.CUDA],
                   schedule=schedule(wait=0, warmup=1, active=1, repeat=1))
    prof.start()
    for _ in range(LEAD_IN):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    prof.step()
    time.sleep(PAUSE_S)
    return prof


def _stop(prof) -> None:
    import torch

    torch.cuda.synchronize()
    time.sleep(PAUSE_S)
    prof.step()
    prof.stop()


def device_ops(prof) -> list[DeviceOp]:
    from torch.autograd import DeviceType

    out = []
    for r in prof.profiler.kineto_results.events():
        if r.device_type() != DeviceType.CUDA or is_marker(r.name()):
            continue
        s = r.start_ns() / 1e9
        out.append(DeviceOp(r.name(), s, s + r.duration_ns() / 1e9))
    return out


def _gaps(ops: list[DeviceOp], launched: dict[str, int]) -> dict[str, tuple[int, int]]:
    seen = {k: 0 for k in PORT_KERNELS}
    for op in ops:
        k = port_kernel(op.name)
        if k is not None:
            seen[k] += 1
    return {k: (seen[k], launched.get(k, 0)) for k in PORT_KERNELS
            if seen[k] != launched.get(k, 0)}


@dataclasses.dataclass
class Session:
    ops: list[DeviceOp]
    window_s: float  # host clock over the work, the card synchronized
    launched: dict[str, int]
    refused: list[str]


def profile(body, launches) -> Session:
    """Profile body() in a whole session. `launches()` reads the port's
    launch counters. Each refused session is kept in `refused`; after
    TRIES refusals IncompleteSession is raised."""
    import torch

    refused: list[str] = []
    for _ in range(TRIES):
        prof = _start()
        before = launches()
        t0 = time.perf_counter()
        try:
            body()
            torch.cuda.synchronize()
            window = time.perf_counter() - t0
        finally:
            _stop(prof)
        launched = {k: n - before.get(k, 0) for k, n in launches().items()}
        ops = device_ops(prof)
        gaps = _gaps(ops, launched)
        if not gaps and ops:
            return Session(ops, window, launched, refused)
        refused.append("; ".join(f"{k}: {s} events, {n} launches" for k, (s, n) in gaps.items())
                       or "no device event")
    raise IncompleteSession(" | ".join(refused))


def busy_s(ops: list[DeviceOp]) -> float:
    """Seconds in which some operation ran: the union of the intervals."""
    total, end = 0.0, None
    for op in sorted(ops, key=lambda o: o.start_s):
        if end is None or op.start_s > end:
            total += op.seconds
            end = op.end_s
        elif op.end_s > end:
            total += op.end_s - end
            end = op.end_s
    return total


def idle_gaps(ops: list[DeviceOp], top: int = 10) -> list[list]:
    """The longest idle stretches between operations, each named by the
    operations on either side of it."""
    ops = sorted(ops, key=lambda o: o.start_s)
    gaps, end, last = [], None, None
    for op in ops:
        if end is not None and op.start_s > end:
            gaps.append((op.start_s - end, f"after {last[:60]} / before {op.name[:60]}"))
        if end is None or op.end_s > end:
            end, last = op.end_s, op.name
    return [[name, g] for g, name in sorted(gaps, reverse=True)[:top]]


def top_ops(ops: list[DeviceOp], top: int = 10) -> list[list]:
    """Device seconds by operation name, the largest first."""
    acc: dict[str, float] = {}
    for op in ops:
        acc[op.name] = acc.get(op.name, 0.0) + op.seconds
    return [[k[:120], v] for k, v in sorted(acc.items(), key=lambda kv: -kv[1])[:top]]
