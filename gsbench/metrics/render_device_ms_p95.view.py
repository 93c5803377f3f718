"""95th percentile over the window's requests of the replayed render's
device time, between a CUDA event recorded before `render_replayed` and
one after it: the render alone, without the camera's upload and the
frame's copy to the host that `view_ms_p95` holds too."""

import numpy as np


def read(record: dict) -> float | None:
    ms = record.get("render_ms")
    return float(np.percentile(ms, 95)) if ms else None
