"""% of the profiled steps' host-clock time with no operation on the
device."""

from gsbench.readers import idle_share


def read(record: dict) -> float | None:
    return idle_share(record)
