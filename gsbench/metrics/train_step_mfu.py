"""The profiled steps' work (workmodel.step_flops) over their host-clock
time per step at the chip's float32 peak, in %."""

from gsbench import workmodel
from gsbench.readers import mfu


def read(record: dict) -> float | None:
    return mfu(record, lambda v: workmodel.step_flops(
        record["gaussians"], v["live_pairs"], v["pixels"]))
