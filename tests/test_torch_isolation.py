"""gsjax_torch stands alone: no file of it (nor chip_smoke.py) imports
jax, flax or gsjax; it imports, renders and takes a training step with JAX
made unimportable; and
its entry points default to CUDA and raise without it rather than fall
back to the CPU. Its packages re-export gsjax's package-level names, and
importing them builds and loads no kernel library and imports neither the
mesh, the viewer nor the tools."""

from __future__ import annotations

import ast
import importlib
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from gsjax_torch.core.cameras import Camera
from gsjax_torch.interop import densify_stats_from_numpy, params_from_numpy
from gsjax_torch.model import create_from_pcd
from gsjax_torch.synthetic import look_at_origin_camera, orbit_camera, random_scene

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "gsjax")


def _port_files():
    return sorted((ROOT / "gsjax_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize(
    "path", _port_files(), ids=lambda p: str(p.relative_to(ROOT))
)
def test_no_jax_imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}: imports {name}"


def test_renders_on_cpu_with_jax_unimportable():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'gsjax'): sys.modules[m] = None\n"
        "import torch\n"
        "from gsjax_torch.config import RasterConfig\n"
        "from gsjax_torch.render.api import render\n"
        "from gsjax_torch.synthetic import look_at_origin_camera, random_scene\n"
        "p, a = random_scene(100, seed=1, device='cpu')\n"
        "cam = look_at_origin_camera(32, 32, device='cpu')\n"
        "with torch.no_grad():\n"
        "    out = render(p, cam, active_sh_degree=3, bg_color=torch.zeros(3),\n"
        "                 cfg=RasterConfig(max_instances=4096, max_rows=4096),\n"
        "                 alive=a.alive)\n"
        "assert out.image.shape == (3, 32, 32) and bool(torch.isfinite(out.image).all())\n"
        "from gsjax_torch.config import OptimizationConfig\n"
        "from gsjax_torch.train.optimizer import adam_init\n"
        "from gsjax_torch.train.step import TrainState, train_step\n"
        "st = TrainState(p, adam_init(p), a, torch.tensor(1, dtype=torch.int32))\n"
        "st, m = train_step(st, cam, out.image.detach(), torch.zeros(3),\n"
        "                   active_sh_degree=3, opt_cfg=OptimizationConfig(),\n"
        "                   raster_cfg=RasterConfig(max_instances=4096, max_rows=4096),\n"
        "                   spatial_lr_scale=1.0)\n"
        "assert bool(torch.isfinite(m.loss)) and int(st.step) == 2\n"
        "assert not any(k.split('.')[0] in ('jax', 'flax', 'gsjax')\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=120,
    )
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def _gsjax_exports(package: str) -> list[str]:
    """The names gsjax's package file exports, read from its source: its
    `__all__`, or with none (gsjax.train) the names it imports."""
    tree = ast.parse((ROOT / "gsjax" / package / "__init__.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and [t.id for t in node.targets] == ["__all__"]:
            return ast.literal_eval(node.value)
    return [a.asname or a.name for node in tree.body if isinstance(node, ast.ImportFrom)
            for a in node.names]


@pytest.mark.parametrize("package", ["", "core", "render", "train"])
def test_packages_export_gsjax_names(package):
    """Every name of gsjax's package `__all__` (and `__version__`) resolves
    in the port's package to the port's own object, under the same
    `__all__`."""
    mod = importlib.import_module(".".join(filter(None, ("gsjax_torch", package))))
    names = _gsjax_exports(package)
    assert len(names) >= 4 and mod.__all__ == names
    for name in names:
        assert getattr(mod, name).__module__.startswith("gsjax_torch."), name
    if not package:
        gsjax_init = (ROOT / "gsjax" / "__init__.py").read_text()
        assert f'__version__ = "{mod.__version__}"' in gsjax_init


def test_package_imports_load_no_kernels():
    """Importing the four packages (with JAX unimportable) builds and loads
    no CUDA library and imports no mesh, viewer or tools module."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'gsjax'): sys.modules[m] = None\n"
        "import gsjax_torch, gsjax_torch.core, gsjax_torch.render, gsjax_torch.train\n"
        "from gsjax_torch import RasterConfig\n"
        "from gsjax_torch.render import kernels\n"
        "assert kernels._lib is None\n"
        "maps = open('/proc/self/maps').read()\n"
        "assert kernels.LIB_NAME not in maps and 'libcuda' not in maps\n"
        "bad = sorted(k for k in sys.modules if k.startswith(tuple(\n"
        "    'gsjax_torch.' + p for p in ('parallel', 'viewer', 'tools'))))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=120,
    )
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def _checkpoint_to_ply(**kw):
    """tools.ckpt_to_ply.export of a checkpoint written on the CPU."""
    import tempfile

    from gsjax_torch.tools.ckpt_to_ply import export
    from gsjax_torch.train.checkpoint import save_checkpoint
    from gsjax_torch.train.optimizer import adam_init
    from gsjax_torch.train.step import TrainState

    params, aux = random_scene(10, device="cpu")
    state = TrainState(params, adam_init(params), aux, torch.tensor(1, dtype=torch.int32))
    with tempfile.TemporaryDirectory() as root:
        ckpt = os.path.join(root, "chkpnt1.npz")
        save_checkpoint(ckpt, state, 0, 1.0)
        return export(ckpt, root, **kw)


ENTRY_POINTS = {
    "random_scene": lambda **kw: random_scene(10, **kw),
    "look_at_origin_camera": lambda **kw: look_at_origin_camera(**kw),
    "orbit_camera": lambda **kw: orbit_camera(0.3, **kw),
    "Camera.create": lambda **kw: Camera.create(
        np.eye(3, dtype=np.float32), np.zeros(3, np.float32), 0.9, 0.7, 16, 16, **kw),
    "params_from_numpy": lambda **kw: params_from_numpy(
        {k: np.zeros((2, 3), np.float32) for k in (
            "xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity")},
        **kw),
    "create_from_pcd": lambda **kw: create_from_pcd(
        np.random.default_rng(0).uniform(-1, 1, (8, 3)), np.full((8, 3), 0.5), 1,
        knn_dist2=np.ones(8, np.float32), **kw),
    "densify_stats_from_numpy": lambda **kw: densify_stats_from_numpy(
        dict.fromkeys(("n_alive", "n_cloned", "n_split", "n_pruned", "n_dropped"), 0),
        **kw),
    "ckpt_to_ply.export": _checkpoint_to_ply,
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_points_default_to_cuda(name):
    make = ENTRY_POINTS[name]
    if torch.cuda.is_available():
        out = make()
        tensor = out[0].xyz if isinstance(out, tuple) else getattr(out, "view", None)
        assert tensor is None or tensor.is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    assert make(device="cpu") is not None
