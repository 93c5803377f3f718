"""The benchmark's own tests: `python -m pytest -q gsbench/tests` from the
repository root (CPU; the `cuda` ones skip without a card and run on it:
`python -m pytest -q -m cuda gsbench/tests`). Nothing here imports JAX."""

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU and nvcc; skipped without one")
