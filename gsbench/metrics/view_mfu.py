"""The profiled requests' work (workmodel.view_flops) over each
request's host-clock time from issue to frame bytes, at the chip's
float32 peak, in %."""

from gsbench import workmodel
from gsbench.readers import mfu


def read(record: dict) -> float | None:
    return mfu(record, lambda v: workmodel.view_flops(
        record["gaussians"], v["live_pairs"], v["pixels"]))
