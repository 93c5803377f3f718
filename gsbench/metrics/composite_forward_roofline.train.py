"""composite_forward's share of its roofline over the profiled steps."""

from gsbench import workmodel
from gsbench.readers import kernel_roofline


def read(record: dict) -> float | None:
    return kernel_roofline(record, "composite_forward", lambda v: workmodel.composite_forward(
        v["tile_pairs"], v["live_pairs"], v["pixels"]))
