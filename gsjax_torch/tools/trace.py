"""What trace_step and trace_binning share: torch.profiler traces read as
device operations with the CPU-side call chain that launched each, their
grouping by name and by op family, idle gaps and makespans.

A family is named by a `gsjt:<family>` range (torch.profiler's
record_function) that the tool opens around a function of the traced
path by wrapping it (`marked`): the path's own code is not instrumented.
A device operation belongs to the family of the innermost range on its
launch chain; one launched by the autograd engine belongs to the family
of the forward operation that made its graph node (the same sequence
number on the forward thread). Two families go by what ran instead of
where: the port's own composite kernels, and the gathers (the launching
op is a gather: index_select, index, gather, take).

    ops = device_ops(prof)        # on the card, after a profiled session
    chrome_trace_kernels(path)    # the kernels of an exported Chrome trace
    by_family(ops), by_name(ops), idle_gaps(intervals), makespan(intervals)
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json

from gsjax_torch.utils.profiler import is_lead_in

RANGE_PREFIX = "gsjt:"
# The range torch.profiler opens around each step of a schedule (the port's
# sessions have one: utils/profiler.start_session).
STEP_RANGE = "ProfilerStep"
BACKWARD_PREFIX = "autograd::engine::evaluate_function"
COMPOSITE_KERNELS = ("composite_forward_kernel", "composite_backward_kernel",
                     "segment_sum_kernel")
BINNING_KERNELS = ("row_engine_", "rank_prefix_kernel")
GATHER_OPS = ("aten::index_select", "aten::index", "aten::gather", "aten::take")
OTHER = "other"


@dataclasses.dataclass(frozen=True)
class DeviceOp:
    """One device operation: its name, its device interval (us) and the
    names of the CPU events that launched it, innermost first (for the
    autograd engine's, followed by the chain of the forward operation)."""

    name: str
    start_us: float
    end_us: float
    chain: tuple[str, ...] = ()

    @property
    def us(self) -> float:
        return self.end_us - self.start_us


def is_marker(name: str) -> bool:
    """Whether a device event of this name is not an operation of the work
    profiled: a range's span on the device timeline (a tool's family range,
    the profiler's step) or a kernel of the session's lead-in
    (utils/profiler)."""
    return name.startswith((RANGE_PREFIX, STEP_RANGE)) or is_lead_in(name)


def family(op: DeviceOp) -> str:
    """The op family of one device operation (see the module doc)."""
    if any(k in op.name for k in COMPOSITE_KERNELS):
        return "composite kernels"
    if any(k in op.name for k in BINNING_KERNELS):
        return "binning"
    aten = [c for c in op.chain if c.startswith("aten::")]
    if aten and aten[0] in GATHER_OPS:
        return "gathers"
    for c in op.chain:
        if c.startswith(RANGE_PREFIX):
            return c[len(RANGE_PREFIX):]
    return OTHER


def by_family(ops, per: int = 1) -> dict[str, float]:
    """Device ms by family, divided by `per` (the traced repetitions),
    largest first."""
    acc = collections.Counter()
    for op in ops:
        acc[family(op)] += op.us
    return {k: v / 1e3 / per for k, v in acc.most_common()}


def by_name(ops, per: int = 1, top: int | None = None) -> list[dict]:
    """Device ms and count of each operation name, divided by `per`,
    largest first."""
    ms, count = collections.Counter(), collections.Counter()
    for op in ops:
        ms[op.name] += op.us
        count[op.name] += 1
    return [{"name": k[:120], "ms": v / 1e3 / per, "count": count[k] / per}
            for k, v in ms.most_common(top)]


def busy_intervals(intervals) -> list[tuple[float, float]]:
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def makespan(intervals) -> float:
    """First start to last end of (start, end) intervals; 0 for none."""
    intervals = list(intervals)
    if not intervals:
        return 0.0
    return max(e for _, e in intervals) - min(s for s, _ in intervals)


def idle_gaps(intervals, top: int = 10) -> dict:
    """The device's idle time between the first start and the last end:
    the busy union, the total idle, the idle share of the makespan, the
    number of gaps and the largest `top` gaps, in the intervals' unit."""
    busy = busy_intervals(intervals)
    gaps = [(b[0] - a[1], a[1]) for a, b in zip(busy, busy[1:])]
    span = makespan(busy)
    idle = sum(g for g, _ in gaps)
    return {"makespan": span, "busy": span - idle, "idle": idle,
            "idle_share": idle / span if span else 0.0, "gaps": len(gaps),
            "largest": [{"gap": g, "after": at} for g, at in sorted(gaps, reverse=True)[:top]]}


def split_calls(ops, calls: int) -> list[list[DeviceOp]]:
    """The operations of `calls` calls that ran one after another with the
    device idle between them, split at the calls - 1 largest idle gaps
    (the caller makes those gaps longer than any inside a call)."""
    ops = sorted(ops, key=lambda op: op.start_us)
    busy = busy_intervals((op.start_us, op.end_us) for op in ops)
    gaps = sorted(range(len(busy) - 1), key=lambda i: busy[i + 1][0] - busy[i][1])
    cuts = sorted(busy[i + 1][0] for i in gaps[len(gaps) - (calls - 1):]) if calls > 1 else []
    out: list[list[DeviceOp]] = [[] for _ in range(len(cuts) + 1)]
    for op in ops:
        out[sum(op.start_us >= c for c in cuts)].append(op)
    return out


# --- marking a path's functions, and reading a profile (card) ----------------------


@contextlib.contextmanager
def marked(targets):
    """Wrap each (module, attribute, family) function in a
    `gsjt:<family>` record_function range while the context is open."""
    from torch.profiler import record_function

    saved = []

    def wrap(fn, name):
        def call(*args, **kwargs):
            with record_function(RANGE_PREFIX + name):
                return fn(*args, **kwargs)
        return call

    try:
        for module, attr, name in targets:
            fn = getattr(module, attr)
            saved.append((module, attr, fn))
            setattr(module, attr, wrap(fn, name))
        yield
    finally:
        for module, attr, fn in reversed(saved):
            setattr(module, attr, fn)


def _chain(evt) -> list[str]:
    out = []
    while evt is not None:
        out.append(evt.name)
        evt = evt.cpu_parent
    return out


def device_ops(prof) -> list[DeviceOp]:
    """The device operations of a finished torch.profiler session (CPU and
    CUDA activities), each with its launch chain. The device events and
    their links to the framework operations that launched them are read
    from the profiler's raw (Kineto) events; the chains from its event
    tree."""
    from torch.autograd import DeviceType

    cpu = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    # Forward operations by (sequence number, thread): the chain a backward
    # node's operations inherit.
    forward = {}
    for e in cpu:
        if e.sequence_nr >= 0 and not e.name.startswith(BACKWARD_PREFIX):
            chain = _chain(e)
            if any(c.startswith(RANGE_PREFIX) for c in chain):
                forward[(e.sequence_nr, e.thread)] = chain
    raw = prof.profiler.kineto_results.events()
    # The framework operations (not runtime calls), by correlation id: a
    # device event's linked correlation id names the one that launched it.
    frontend = {r.correlation_id() for r in raw
                if r.device_type() == DeviceType.CPU and r.linked_correlation_id() == 0}
    launcher = {}
    for e in cpu:
        if e.id in frontend:
            launcher.setdefault(e.id, e)
    ops = []
    for r in raw:
        # The ranges' spans on the device timeline are not operations.
        if r.device_type() != DeviceType.CUDA or is_marker(r.name()):
            continue
        chain: list[str] = []
        src = launcher.get(r.linked_correlation_id())
        if src is not None:
            chain = _chain(src)
            for c_evt in _ancestors(src):
                if c_evt.name.startswith(BACKWARD_PREFIX):
                    chain += forward.get((c_evt.sequence_nr, c_evt.fwd_thread), [])
                    break
        start = r.start_ns() / 1e3
        ops.append(DeviceOp(r.name(), start, start + r.duration_ns() / 1e3, tuple(chain)))
    return ops


def _ancestors(evt):
    while evt is not None:
        yield evt
        evt = evt.cpu_parent


def chrome_trace_kernels(path: str) -> list[str]:
    """The names of the kernel events (category "kernel") of a Chrome trace
    that torch.profiler exported, e.g. the trainer's --profile_dir trace,
    its session's lead-in left out."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e["name"] for e in events
            if e.get("cat") == "kernel" and not is_lead_in(e["name"])]
