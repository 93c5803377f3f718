"""The benchmark stands apart: no module under gsbench/ imports JAX,
flax or gsjax (top-level names compared whole, so gsjax_torch passes),
and the plain reference imports nothing of gsjax_torch either."""

from __future__ import annotations

import ast
import pathlib

import pytest

HERE = pathlib.Path(__file__).resolve().parents[1]
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "gsjax"}


def imported(path: pathlib.Path) -> set[str]:
    """Top-level names of every module a file imports."""
    return imported_names(path.read_text())


def imported_names(source: str) -> set[str]:
    out = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


FILES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_flax_or_gsjax(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_reference_imports_nothing_of_the_port(path):
    assert not imported(path) & (FORBIDDEN | {"gsjax_torch"})


def test_names_are_compared_whole():
    src = "import gsjax_torch.render\nfrom gsjax_torch import RasterConfig\n"
    assert "gsjax_torch" in imported_names(src) and not imported_names(src) & FORBIDDEN
    assert imported_names("import gsjax.render\n") & FORBIDDEN
    assert imported_names("from jax import numpy\n") & FORBIDDEN


def test_harness_refuses_loaded_jax_names(monkeypatch):
    import sys
    import types

    from gsbench import harness

    monkeypatch.setitem(sys.modules, "gsjax_torch_probe", types.ModuleType("gsjax_torch_probe"))
    assert harness.forbidden_modules() == sorted(
        {m.split(".")[0] for m in sys.modules} & FORBIDDEN)
    monkeypatch.setitem(sys.modules, "flax.linen", types.ModuleType("flax.linen"))
    assert "flax" in harness.forbidden_modules()
