"""Process-level utilities (reference: utils/general_utils.py:112-133)."""

from __future__ import annotations

import random
import sys
from datetime import datetime

import numpy as np
import torch


class _TimestampedStdout:
    """stdout wrapper stamping each line (reference:
    utils/general_utils.py:114-127)."""

    def __init__(self, old, silent: bool):
        self.old = old
        self.silent = silent

    def write(self, x: str) -> None:
        if self.silent:
            return
        if x.endswith("\n"):
            stamp = datetime.now().strftime("%d/%m %H:%M:%S")
            self.old.write(x.replace("\n", f" [{stamp}]\n"))
        else:
            self.old.write(x)

    def flush(self) -> None:
        self.old.flush()


def safe_state(silent: bool = False, seed: int = 0) -> None:
    """Seed the host RNGs (random, numpy) and torch's, and optionally
    silence or timestamp stdout. The reference also pins cuda:0 here
    (utils/general_utils.py:133); the port's entry points take the
    current CUDA device."""
    sys.stdout = _TimestampedStdout(sys.stdout, silent)
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
