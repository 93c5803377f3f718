"""The port's mesh across processes on the CPU: one process per rank,
joined over gloo by gsjax's launch protocol (COORDINATOR_ADDRESS,
NUM_PROCESSES, PROCESS_ID) or by torchrun's.

In the shape of tests/test_multihost.py: two worker processes
(tests/torch_mesh_worker.py) run two sharded steps on the (1,2) and the
(2,1) mesh and the same two as one looped window; the loss agrees across
ranks and with two single-process train_step calls, and the window with
the sequential steps. A Trainer on the (1,2) mesh runs through a densify
and an opacity reset with both replicas equal bit for bit, rank 0 alone
writing the model. The Trainer's mesh-path window schedule is held to
gsjax's with both packages' steps replaced by recorders, and cli.train
runs under torchrun with --tile_parallel 2.
"""

from __future__ import annotations

import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import gsjax.train.step as jstep
import gsjax.train.trainer as jtrainer
from gsjax.config import ModelConfig as JModelConfig
from gsjax.config import OptimizationConfig as JOptimizationConfig
from gsjax.scene import Scene as JScene
from gsjax.train.densify import DensifyStats as JDensifyStats
from gsjax_torch.config import ModelConfig, OptimizationConfig
from gsjax_torch.parallel.multihost import host_local_views, maybe_init_distributed
from gsjax_torch.scene import Scene
from gsjax_torch.train import step as steps
from gsjax_torch.train import trainer as trainer_mod
from gsjax_torch.train.densify import DensifyStats
from tests import torch_mesh_worker as worker
from tests.test_torch_trainer import SCHEDULE, Recorder, write_blender_dataset

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return write_blender_dataset(str(tmp_path_factory.mktemp("blender_scene")))


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("mesh_model") / "model")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, dataset, model_dir):
    return worker.launch("multihost", 2, str(tmp_path_factory.mktemp("multihost")),
                         dataset, model_dir)


def test_process_group_topology(ranks):
    assert [(r["rank"], r["world"]) for r in ranks] == [(0, 2), (1, 2)]
    # Round-robin camera indices per process (gsjax's host_local_views).
    assert ranks[0]["host_views"] == [0, 2, 4]
    assert ranks[1]["host_views"] == [1, 3]


def test_no_group_in_a_single_process():
    assert maybe_init_distributed("cpu") is False
    assert list(host_local_views(3)) == [0, 1, 2]


@pytest.mark.parametrize("shape", ["1x2", "2x1"])
def test_losses_agree_across_ranks_and_match_single_process(ranks, shape):
    a, b = (r[f"losses_{shape}"] for r in ranks)
    np.testing.assert_allclose(a, b, rtol=1e-6)
    assert a[1] < a[0]  # the optimizer moved
    params, aux = worker.multihost_scene()
    cam = worker.look_at_origin_camera(worker.MH_SIZE, worker.MH_SIZE, device="cpu")
    gt = worker.ramp_gt(worker.MH_SIZE, worker.MH_SIZE)
    state, want = worker.fresh_state(params, aux), []
    for _ in range(2):
        state, m = steps.train_step(state, cam, gt, torch.zeros(3),
                                    active_sh_degree=worker.SH_DEG,
                                    opt_cfg=OptimizationConfig(), raster_cfg=worker.CFG,
                                    spatial_lr_scale=1.0)
        want.append(float(m.loss))
    np.testing.assert_allclose(a, want, rtol=1e-5)


def test_looped_window_matches_sequential(ranks):
    """make_sharded_train_steps' window of two steps across the process
    boundary equals the two sequential sharded steps."""
    a, b = ranks
    np.testing.assert_allclose(a["window_losses"], b["window_losses"], rtol=1e-6)
    np.testing.assert_allclose(a["window_losses"], a["losses_1x2"], rtol=1e-5)


def test_trainer_replicas_equal_through_densify(ranks):
    """8 iterations on the (1,2) mesh with random backgrounds, a densify at
    4 (clones and splits drawn from the generator) and an opacity reset at
    6: both ranks end with the same state, bit for bit."""
    a, b = (r["trainer"] for r in ranks)
    densify = [e for e in a["events"] if "densify" in e]
    assert len(densify) == 1 and densify[0]["n_split"] + densify[0]["n_cloned"] > 0
    assert a["n_alive"] == b["n_alive"] == densify[0]["n_alive"]
    assert len(a["state"]) == len(b["state"])
    for x, y in zip(a["state"], b["state"]):
        assert x.dtype == y.dtype and x.numpy().tobytes() == y.numpy().tobytes()
    assert int(a["state"][-1]) == 8


def test_trainer_rank0_alone_writes(ranks, model_dir):
    a, b = (r["trainer"] for r in ranks)
    assert (a["is_main"], b["is_main"]) == (True, False)
    assert [e["eval"] for e in a["events"] if "eval" in e] == ["train"]
    assert not any("eval" in e for e in b["events"])
    for f in ("chkpnt8.npz", "cameras.json",
              os.path.join("point_cloud", "iteration_8", "point_cloud.ply")):
        assert os.path.exists(os.path.join(model_dir, f)), f


# --- the mesh path's window schedule against gsjax's, with recorded steps ----------


def views_to_cams(views: np.ndarray, bank_views: np.ndarray) -> list[int]:
    """The bank index of each camera of a [w, b, 4, 4] window."""
    flat = views.reshape(-1, 16)
    dist = np.abs(flat[:, None, :] - bank_views.reshape(1, -1, 16)).sum(-1)
    assert (dist.min(1) == 0).all()
    return dist.argmin(1).tolist()


def record_mesh_window(rec, bank_views, state_capacity, views, gt, bgs, sh, raster_cfg):
    w, b = views.shape[:2]
    loss, l1, inst, rows = rec.window(state_capacity, views_to_cams(views, bank_views),
                                      bgs, sh, raster_cfg)
    rec.log[-1] += (w, b, np.asarray(gt, np.float64).sum(axis=(2, 3, 4)).round(3).tolist())
    return loss, l1, inst, rows


def jax_mesh_schedule(dataset, tmp, data, monkeypatch):
    rec = Recorder()
    holder = {}

    def sharded_steps_for(self, bank):
        def steps_fn(state, views, projs, centers, tanx, tany, gt, bgs, sh):
            m = record_mesh_window(rec, holder["views"], state.params.capacity,
                                   np.asarray(views), gt, bgs, sh, self.raster_cfg)
            return state, jstep.StepMetrics(*m)
        return steps_fn

    def densify_fn(params, aux, opt, key, **kw):
        alive, dropped = rec.densify()
        z = np.int32(0)
        return params, aux, opt, JDensifyStats(np.int32(alive), z, z, z, np.int32(dropped))

    monkeypatch.setattr(jtrainer.Trainer, "_sharded_steps_for", sharded_steps_for)
    monkeypatch.setattr(jtrainer, "_densify_jit", densify_fn)
    monkeypatch.setattr(jtrainer, "_reset_opacity_jit",
                        lambda params, opt: rec.event("reset") or (params, opt))
    monkeypatch.setattr(jtrainer.Trainer, "_report_test",
                        lambda self, it, first_test=False: rec.event("test"))
    monkeypatch.setattr(jtrainer.Trainer, "_save_checkpoint",
                        lambda self, path: rec.event("checkpoint"))
    cfg = JModelConfig(source_path=dataset, model_path=str(tmp / "jax"))
    scene = JScene(cfg)
    scene.save = lambda it, params, alive: rec.event("save")
    mesh = types.SimpleNamespace(shape={"data": data, "tile": 3 - data})
    t = jtrainer.Trainer(scene, cfg, JOptimizationConfig(**SCHEDULE, random_background=True),
                         quiet=True, mesh=mesh)
    holder["views"] = np.asarray(t.banks[0].views)
    t.train(test_iterations=(700, 3200), save_iterations=(1500, 3200),
            checkpoint_iterations=(1000, 2500), max_window=20)
    return rec.log


def port_mesh_schedule(dataset, tmp, data, monkeypatch):
    rec = Recorder()
    holder = {}

    def sharded_steps_for(self, bank):
        def steps_fn(state, views, projs, centers, tanx, tany, gt, bgs, sh):
            m = record_mesh_window(rec, holder["views"], state.params.capacity,
                                   views.numpy(), gt.numpy(), bgs.numpy(), sh,
                                   self.raster_cfg)
            return state, steps.StepMetrics(*map(torch.from_numpy, m))
        return steps_fn

    def densify_fn(params, aux, opt, generator, **kw):
        alive, dropped = rec.densify()
        z = torch.zeros((), dtype=torch.int32)
        return params, aux, opt, DensifyStats(
            torch.tensor(alive, dtype=torch.int32), z, z, z,
            torch.tensor(dropped, dtype=torch.int32))

    monkeypatch.setattr(trainer_mod.Trainer, "_sharded_steps_for", sharded_steps_for)
    monkeypatch.setattr(trainer_mod, "densify_and_prune", densify_fn)
    monkeypatch.setattr(trainer_mod, "reset_opacity",
                        lambda params, opt: rec.event("reset") or (params, opt))
    monkeypatch.setattr(trainer_mod.Trainer, "_report_test",
                        lambda self, it, first_test=False: rec.event("test"))
    monkeypatch.setattr(trainer_mod.Trainer, "_save_checkpoint",
                        lambda self, path: rec.event("checkpoint"))
    cfg = ModelConfig(source_path=dataset, model_path=str(tmp / "torch"))
    scene = Scene(cfg, device="cpu")
    scene.save = lambda it, params, alive: rec.event("save")
    mesh = types.SimpleNamespace(device_type="cpu", get_rank=lambda: 0,
                                 size=lambda dim: (data, 3 - data)[dim])
    t = trainer_mod.Trainer(scene, cfg, OptimizationConfig(**SCHEDULE, random_background=True),
                            quiet=True, mesh=mesh)
    holder["views"] = t.banks[0].views.numpy()
    t.train(test_iterations=(700, 3200), save_iterations=(1500, 3200),
            checkpoint_iterations=(1000, 2500), max_window=20)
    return rec.log


@pytest.mark.parametrize("data", [1, 2])
def test_mesh_window_schedule_matches_gsjax(dataset, tmp_path, monkeypatch, data):
    """gsjax/train/trainer.py:510-555: windows rounded down to powers of
    two, w*b cameras from one bank with a short epoch tail cycle-padded,
    one background per step, gt = clip(rgb/255)*alpha/255 in [w, b] order;
    the same densify, growth, reset, eval, save and checkpoint events."""
    want = jax_mesh_schedule(dataset, tmp_path, data, monkeypatch)
    got = port_mesh_schedule(dataset, tmp_path, data, monkeypatch)
    assert got == want
    windows = [e for e in got if e[0] == "window"]
    assert {e[-2] for e in windows} == {data}
    lengths = {e[-3] for e in windows}
    assert all(w & (w - 1) == 0 for w in lengths) and max(lengths) == 16
    assert {e[2] for e in windows} == {1024, 2048, 4096}
    assert [e[0] for e in got].count("densify") == 13


# --- cli.train under torchrun -------------------------------------------------------


def test_cli_train_under_torchrun(dataset, tmp_path):
    """torchrun --nproc_per_node 2 cli.train --data_device cpu
    --tile_parallel 2 (through the worker, which sets the tests' tiny
    budgets and stubs TensorBoard): both ranks train 4 steps to the same
    state, rank 0 alone writes the model."""
    model = str(tmp_path / "model")
    env = dict(os.environ, GSJT_OUT=str(tmp_path), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
           "--master_port", str(worker.free_port()), worker.WORKER, "cli",
           "-s", dataset, "-m", model, "--data_device", "cpu", "--tile_parallel", "2",
           "--iterations", "4", "--save_iterations", "4", "--test_iterations", "4",
           "--port", "0", "--quiet", "--eval"]
    run = subprocess.run(cmd, env=env, cwd=worker.REPO, capture_output=True, text=True,
                         timeout=300)
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    a, b = (torch.load(os.path.join(tmp_path, f"rank{r}.pt")) for r in range(2))
    assert (a["rank"], a["is_main"], b["rank"], b["is_main"]) == (0, True, 1, False)
    assert int(a["state"][-1]) == 4
    for x, y in zip(a["state"], b["state"]):
        assert x.numpy().tobytes() == y.numpy().tobytes()
    assert [e["eval"] for e in a["events"] if "eval" in e] == ["test", "train"]
    for f in ("cfg_args", "cameras.json", "input.ply",
              os.path.join("point_cloud", "iteration_4", "point_cloud.ply")):
        assert os.path.exists(os.path.join(model, f)), f
