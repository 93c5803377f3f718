"""Mean % of the instance budget the profiled steps' exact pairs take
(the step metrics' num_instances over the Trainer's max_instances)."""

from gsbench.readers import fill


def read(record: dict) -> float | None:
    return fill(record)
