"""Device ms per profiled step of every operation that is not one of the
port's kernels: SSIM, L1, Adam, preprocess, gathers, sorts, fills."""

from gsbench.readers import library_ms


def read(record: dict) -> float | None:
    return library_ms(record, "profiled_steps")
