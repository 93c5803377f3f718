"""Mean % of the instance budget the profiled requests' exact pairs
take (RenderOutput.num_instances over max_instances)."""

from gsbench.readers import fill


def read(record: dict) -> float | None:
    return fill(record)
