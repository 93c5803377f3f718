"""gsjax_torch stands alone: no file of it (nor chip_smoke.py) imports
jax, flax or gsjax; it imports, renders and takes a training step with JAX
made unimportable; and
its entry points default to CUDA and raise without it rather than fall
back to the CPU."""

from __future__ import annotations

import ast
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
