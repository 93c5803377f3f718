"""composite_backward's share of its roofline over the profiled steps."""

from gsbench import workmodel
from gsbench.readers import kernel_roofline


def read(record: dict) -> float | None:
    return kernel_roofline(record, "composite_backward", lambda v: workmodel.composite_backward(
        v["tile_pairs"], v["live_pairs"], v["pixels"], v["visible"]))
