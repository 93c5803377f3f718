"""The port's Trainer and train_steps on the CPU.

Held to gsjax: the host schedule of a whole run (windows, views,
backgrounds, SH degree, densify, reset, eval, save, checkpoint and budget
events) with both packages' steps, densify, reset and eval replaced by
recorders, so nothing renders or compiles on either side; and the budget
state machine on every case of gsjax's TestBudgetAdaptation. Held to
itself, with real steps on a tiny dataset (8 + 2 views at 64x64, 300 seed
points): train_steps equals train_step calls, power-of-two chunked windows
equal one whole window, a run resumed from a checkpoint equals a straight
run across a densify and an opacity reset, and the capture-safe constants
left a step's outputs as they were, all bit for bit.
"""

from __future__ import annotations

import dataclasses
import json
import os
import types

import numpy as np
import pytest
import torch

import gsjax.train.step as jstep
import gsjax.train.trainer as jtrainer
from gsjax.config import MIN_RASTER_BUDGET
from gsjax.config import ModelConfig as JModelConfig
from gsjax.config import OptimizationConfig as JOptimizationConfig
from gsjax.config import RasterConfig as JRasterConfig
from gsjax.scene import Scene as JScene
from gsjax.train.densify import DensifyStats as JDensifyStats
from gsjax_torch.config import ModelConfig, OptimizationConfig, RasterConfig
from gsjax_torch.data.ply import store_points_ply
from gsjax_torch.render import kernels
from gsjax_torch.scene import Scene
from gsjax_torch.train import step as steps
from gsjax_torch.train import trainer as trainer_mod
from gsjax_torch.train.densify import DensifyStats

torch.set_num_threads(1)
# Budgets for the real steps on the CPU: the tiny scene needs a few
# thousand pairs, and the plain binning's cost grows with the budget.
TINY = RasterConfig(max_instances=1 << 12, max_rows=1 << 10)


def write_blender_dataset(root: str) -> str:
    """8 train + 2 test views of a white disc on black at 64x64, cameras on
    a radius-4 orbit, 300 seed points (the dataset of
    tests/test_e2e_pipeline.py, its PLY written by the port)."""
    from PIL import Image

    rng = np.random.default_rng(0)

    def make_split(name, n, offset):
        frames = []
        os.makedirs(os.path.join(root, name), exist_ok=True)
        for i in range(n):
            angle = (i + offset) * (2 * np.pi / 10)
            pos = 4.0 * np.array([np.sin(angle), 0.0, np.cos(angle)])
            fwd = -pos / np.linalg.norm(pos)
            right = np.cross(fwd, np.array([0.0, 1.0, 0.0]))
            right /= np.linalg.norm(right)
            c2w = np.eye(4)
            c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = (
                right, np.cross(right, fwd), -fwd, pos)
            img = np.zeros((64, 64, 4), np.uint8)
            yy, xx = np.mgrid[:64, :64]
            img[(yy - 32) ** 2 + (xx - 32) ** 2 < (12 + 2 * np.sin(angle)) ** 2] = 255
            img[..., 3] = 255
            Image.fromarray(img).save(os.path.join(root, name, f"r_{i}.png"))
            frames.append({"file_path": f"./{name}/r_{i}",
                           "transform_matrix": c2w.tolist()})
        with open(os.path.join(root, f"transforms_{name}.json"), "w") as f:
            json.dump({"camera_angle_x": 0.9, "frames": frames}, f)

    make_split("train", 8, 0)
    make_split("test", 2, 0.5)
    pts = rng.uniform(-0.5, 0.5, (300, 3))
    store_points_ply(os.path.join(root, "points3d.ply"), pts, rng.uniform(0, 255, (300, 3)))
    return root


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return write_blender_dataset(str(tmp_path_factory.mktemp("blender_scene")))


def port_trainer(dataset, path, opt_cfg, **kw):
    cfg = ModelConfig(source_path=dataset, model_path=str(path))
    scene = Scene(cfg, device="cpu")
    return trainer_mod.Trainer(scene, cfg, opt_cfg, raster_cfg=TINY, quiet=True, **kw)


def assert_states_equal(a, b):
    for x, y in zip(steps.state_tensors(a), steps.state_tensors(b)):
        assert x.dtype == y.dtype and torch.equal(x, y)


# --- the host schedule, both packages with recorded steps ----------------------

SCHEDULE = dict(
    iterations=3200, densify_from_iter=100, densification_interval=100,
    opacity_reset_interval=1000, densify_until_iter=1500,
)
# Densify outcomes the recorder returns, in call order: the third grows
# the capacity by occupancy (> 0.75 of 1024), the fourth by a dropped row.
DENSIFY_ALIVE = (320, 700, 800, 900, 950)


class Recorder:
    """Stands in for a package's step window, densify, reset, eval and
    saves: logs what the trainer asks for, and returns metrics that make
    the budgets grow while densifying and shrink after a quiet stretch."""

    def __init__(self):
        self.log = []
        self.it = 0
        self.densifies = 0

    def window(self, capacity, cams, bgs, sh, raster_cfg):
        self.log.append(("window", self.it, capacity, [int(c) for c in cams],
                         np.asarray(bgs, np.float32).tolist(), int(sh),
                         raster_cfg.max_instances, raster_cfg.max_rows))
        its = np.arange(self.it + 1, self.it + 1 + len(cams))
        self.it += len(cams)
        busy = its <= SCHEDULE["densify_until_iter"]
        inst = np.where(busy, 900 * its, 5000).astype(np.int32)
        rows = np.where(busy, 300 * its, 3000).astype(np.int32)
        loss = np.full(len(cams), 0.5, np.float32)
        return loss, loss, inst, rows

    def densify(self):
        k = self.densifies
        self.densifies += 1
        self.log.append(("densify", self.it))
        return DENSIFY_ALIVE[min(k, len(DENSIFY_ALIVE) - 1)], int(k == 3)

    def event(self, name, *args):
        self.log.append((name, self.it, *args))


def jax_schedule(dataset, tmp, model_kw, monkeypatch):
    rec = Recorder()

    def steps_fn(state, bank, cam_indices, bgs, *, active_sh_degree, opt_cfg,
                 raster_cfg, spatial_lr_scale):
        m = rec.window(state.params.capacity, np.asarray(cam_indices), bgs,
                       active_sh_degree, raster_cfg)
        return state, jstep.StepMetrics(*m)

    def densify_fn(params, aux, opt, key, **kw):
        alive, dropped = rec.densify()
        z = np.int32(0)
        return params, aux, opt, JDensifyStats(np.int32(alive), z, z, z, np.int32(dropped))

    def reset_fn(params, opt):
        rec.event("reset")
        return params, opt

    monkeypatch.setattr(jtrainer, "train_steps", steps_fn)
    monkeypatch.setattr(jtrainer, "_densify_jit", densify_fn)
    monkeypatch.setattr(jtrainer, "_reset_opacity_jit", reset_fn)
    monkeypatch.setattr(jtrainer.Trainer, "_report_test",
                        lambda self, it, first_test=False: rec.event("test", first_test))
    monkeypatch.setattr(jtrainer.Trainer, "_save_checkpoint",
                        lambda self, path: rec.event("checkpoint", os.path.basename(path)))
    cfg = JModelConfig(source_path=dataset, model_path=str(tmp / "jax"), **model_kw)
    scene = JScene(cfg)
    scene.save = lambda it, params, alive: rec.event("save")
    t = jtrainer.Trainer(scene, cfg, JOptimizationConfig(**SCHEDULE, random_background=True),
                         quiet=True)
    t.train(test_iterations=(700, 3200), save_iterations=(1500, 3200),
            checkpoint_iterations=(1000, 2500), max_window=20)
    rec.event("end", t.raster_cfg.max_instances, t.raster_cfg.max_rows,
              t.state.params.capacity, t.active_sh_degree)
    return rec.log


def port_schedule(dataset, tmp, model_kw, monkeypatch):
    rec = Recorder()

    def steps_fn(state, bank, cam_indices, bgs, *, active_sh_degree, opt_cfg,
                 raster_cfg, spatial_lr_scale):
        m = rec.window(state.params.capacity, cam_indices.numpy(), bgs.numpy(),
                       active_sh_degree, raster_cfg)
        return state, steps.StepMetrics(*map(torch.from_numpy, m))

    def densify_fn(params, aux, opt, generator, **kw):
        alive, dropped = rec.densify()
        z = torch.zeros((), dtype=torch.int32)
        return params, aux, opt, DensifyStats(
            torch.tensor(alive, dtype=torch.int32), z, z, z,
            torch.tensor(dropped, dtype=torch.int32))

    def reset_fn(params, opt):
        rec.event("reset")
        return params, opt

    monkeypatch.setattr(trainer_mod, "train_steps", steps_fn)
    monkeypatch.setattr(trainer_mod, "densify_and_prune", densify_fn)
    monkeypatch.setattr(trainer_mod, "reset_opacity", reset_fn)
    monkeypatch.setattr(trainer_mod.Trainer, "_report_test",
                        lambda self, it, first_test=False: rec.event("test", first_test))
    monkeypatch.setattr(trainer_mod.Trainer, "_save_checkpoint",
                        lambda self, path: rec.event("checkpoint", os.path.basename(path)))
    cfg = ModelConfig(source_path=dataset, model_path=str(tmp / "torch"), **model_kw)
    scene = Scene(cfg, device="cpu")
    scene.save = lambda it, params, alive: rec.event("save")
    t = trainer_mod.Trainer(scene, cfg, OptimizationConfig(**SCHEDULE, random_background=True),
                            quiet=True)
    t.train(test_iterations=(700, 3200), save_iterations=(1500, 3200),
            checkpoint_iterations=(1000, 2500), max_window=20)
    rec.event("end", t.raster_cfg.max_instances, t.raster_cfg.max_rows,
              t.state.params.capacity, t.active_sh_degree)
    return rec.log


@pytest.mark.parametrize("model_kw", [{}, {"white_background": True}],
                         ids=["black", "white"])
def test_host_schedule_matches_gsjax(dataset, tmp_path, monkeypatch, model_kw):
    want = jax_schedule(dataset, tmp_path, model_kw, monkeypatch)
    got = port_schedule(dataset, tmp_path, model_kw, monkeypatch)
    assert got == want
    # The run exercised every event: budget growth and the quiet-stretch
    # shrink, both capacity growths, the SH ramp, resets, evals, saves and
    # checkpoints.
    budgets = {(e[6], e[7]) for e in got if e[0] == "window"}
    assert len(budgets) >= 3
    assert {e[2] for e in got if e[0] == "window"} == {1024, 2048, 4096}
    assert {e[5] for e in got if e[0] == "window"} == {0, 1, 2, 3}
    kinds = [e[0] for e in got]
    for kind, count in (("reset", 2 if model_kw else 1), ("test", 2), ("save", 2),
                        ("checkpoint", 2), ("densify", 13)):
        assert kinds.count(kind) == count, kind


# --- the budget state machine: gsjax's TestBudgetAdaptation cases ---------------

BUDGET_CASES = {
    "grows_immediately_on_overflow": ({}, [(1, (1 << 20) + 5, 100)]),
    "row_overflow_grows_rows": ({}, [(1, 100, (1 << 20) + 1)]),
    "shrinks_after_quiet_stretch_both_axes": (
        {}, [(i, 1 << 17, 1 << 16) for i in range(50)]),
    "shrink_sizes_from_stretch_max_not_last_window": (
        {"inst": 1 << 22, "rows": 1 << 22},
        [(i, 1 << 18, 1 << 17) for i in range(49)] + [(49, 1 << 14, 1 << 14)]),
    "no_shrink_below_floor": (
        {"inst": MIN_RASTER_BUDGET, "rows": MIN_RASTER_BUDGET},
        [(i, 10, 10) for i in range(60)]),
    "no_shrink_when_half_used": ({}, [(i, 1 << 19, 1 << 19) for i in range(60)]),
    "no_shrink_while_densifying": (
        {"densify_until": 10_000}, [(i, 10, 10) for i in range(60)]),
}


def budget_host(trainer_cls, raster_cls, opt_cls, inst=1 << 20, rows=1 << 20,
                densify_until=0):
    host = types.SimpleNamespace(
        raster_cfg=raster_cls(max_instances=inst, max_rows=rows),
        opt_cfg=opt_cls(densify_until_iter=densify_until),
        adapt_budgets=True, _budget_quiet_windows=0, _budget_quiet_peaks=(0, 0),
        _last_peaks=(0, 0), _last_alive=0, _render_cache={}, _sharded_cache={},
        events=[],
    )
    for name in ("_maybe_adapt_budgets", "_apply_budgets", "_post_densify_budget_check"):
        setattr(host, name, types.MethodType(getattr(trainer_cls, name), host))
    return host


def budget_trace(host, calls):
    trace = []
    for it, inst, rows in calls:
        host._maybe_adapt_budgets(it, peak_inst=inst, peak_rows=rows)
        trace.append((host.raster_cfg.max_instances, host.raster_cfg.max_rows,
                      host._budget_quiet_windows, host._budget_quiet_peaks))
    # Then a densify that doubles the alive count, as _densify reports it.
    host._last_alive = 1000
    host._post_densify_budget_check(len(calls), 2000)
    trace.append((host.raster_cfg.max_instances, host.raster_cfg.max_rows))
    return trace


@pytest.mark.parametrize("case", list(BUDGET_CASES))
def test_budget_state_machine_matches_gsjax(case):
    kw, calls = BUDGET_CASES[case]
    want = budget_trace(budget_host(jtrainer.Trainer, JRasterConfig, JOptimizationConfig,
                                    **kw), calls)
    got = budget_trace(budget_host(trainer_mod.Trainer, RasterConfig, OptimizationConfig,
                                   **kw), calls)
    assert got == want


# --- the port against itself, with real steps ----------------------------------


def test_train_steps_equals_train_step_calls(dataset, tmp_path):
    t = port_trainer(dataset, tmp_path / "m", OptimizationConfig())
    bank = t.banks[0]
    kw = dict(active_sh_degree=1, opt_cfg=t.opt_cfg, raster_cfg=TINY,
              spatial_lr_scale=t.spatial_lr_scale)
    cams, bgs = [3, 5], torch.tensor([[0.0, 0.0, 0.0], [0.2, 0.5, 1.0]])
    start = steps.clone_state(t.state)
    a, ma = steps.train_steps(steps.clone_state(start), bank, torch.tensor(cams), bgs, **kw)
    b = steps.clone_state(start)
    for i, c in enumerate(cams):
        cam, gt = bank.pick(c)
        b, mb = steps.train_step(b, cam, gt, bgs[i], **kw)
        assert torch.equal(ma.loss[i], mb.loss) and torch.equal(ma.l1[i], mb.l1)
        assert int(ma.num_instances[i]) == int(mb.num_instances)
    assert ma.loss.shape == (2,) and ma.num_rows.dtype == torch.int32
    assert_states_equal(a, b)
    assert int(a.step) == 2


def test_chunked_windows_match_single_window(dataset, tmp_path, monkeypatch):
    """13 steps in power-of-two chunks and as whole windows: an epoch of
    the 10 views ends the first window, so [8, 2] + [2, 1] against [10] +
    [3]."""
    opt_cfg = OptimizationConfig(iterations=13, densify_from_iter=100,
                                 densify_until_iter=0, opacity_reset_interval=10_000)

    def run(path):
        t = port_trainer(dataset, path, opt_cfg)
        t.train(test_iterations=(), save_iterations=(), checkpoint_iterations=())
        return t

    chunked = run(tmp_path / "chunked")
    monkeypatch.setattr(trainer_mod, "_pow2_chunks", lambda n: [n])
    single = run(tmp_path / "single")
    assert [e["steps"] for e in chunked.events if "window" in e] == [10, 3]
    assert int(chunked.state.step) == 13
    assert_states_equal(chunked.state, single.state)


def test_resume_parity_across_densify_and_reset(dataset, tmp_path):
    """16 straight vs 8 + checkpoint + restore + 8: densifies at 4, 8 and
    12 and an opacity reset at 12, so the resumed half crosses both."""
    opt_cfg = OptimizationConfig(iterations=16, densify_from_iter=2,
                                 densification_interval=4, opacity_reset_interval=12,
                                 densify_until_iter=15, densify_grad_threshold=1e-6,
                                 random_background=True)

    def run(path, start=None):
        t = port_trainer(dataset, path, opt_cfg, start_checkpoint=start)
        t.train(test_iterations=(), save_iterations=(), checkpoint_iterations=(8,))
        return t

    straight = run(tmp_path / "straight")
    resumed = run(tmp_path / "resumed", start=str(tmp_path / "straight" / "chkpnt8.npz"))
    assert int(resumed.state.step) == int(straight.state.step) == 16
    assert resumed.first_iter == 8
    assert resumed.active_sh_degree == straight.active_sh_degree
    assert resumed.raster_cfg == straight.raster_cfg
    assert_states_equal(straight.state, resumed.state)
    assert torch.equal(straight._generator.get_state(), resumed._generator.get_state())
    # The densifies really moved Gaussians.
    assert straight.n_alive() != 300


def test_capture_safe_constants_keep_the_step(dataset, tmp_path, monkeypatch):
    """The step's device-filled constants (preprocess's image size, the
    camera's focal division, Adam's betas, the learning rates, the
    schedule's logs) and binning's expansion without a boolean selection
    give the outputs the host-copied forms gave, bit for bit."""
    import importlib

    from gsjax_torch.core import cameras
    from gsjax_torch.render import binning
    from gsjax_torch.train import optimizer, schedule

    # The module: the package's name `preprocess` is the function, as gsjax's.
    preprocess = importlib.import_module("gsjax_torch.render.preprocess")

    def old_true_div(num, den):
        return torch.div(den.new_tensor(num), den)

    real_pixel = preprocess.ndc_to_pixel
    sizes = []

    def old_ndc_to_pixel(ndc, size):
        sizes.append(size)
        return real_pixel(ndc, torch.tensor(
            [size[0, 0].item(), size[0, 1].item()], dtype=torch.float32)[None, :])

    def old_expon_lr(step, lr_init, lr_final, lr_delay_steps=0, lr_delay_mult=1.0,
                     max_steps=1_000_000):
        step = torch.as_tensor(step).to(torch.float32)
        import math
        if lr_delay_steps > 0:
            delay_rate = lr_delay_mult + (1.0 - lr_delay_mult) * torch.sin(
                0.5 * math.pi * torch.clamp(step / lr_delay_steps, 0.0, 1.0))
        else:
            delay_rate = 1.0
        t = torch.clamp(step / max_steps, 0.0, 1.0)
        log_lerp = torch.exp(torch.log(step.new_tensor(lr_init)) * (1.0 - t)
                             + torch.log(step.new_tensor(lr_final)) * t)
        return torch.where(step < 0, torch.zeros_like(step), delay_rate * log_lerp)

    real_pow = torch.pow

    def old_pow(base, exp):
        # Adam's bias corrections took their betas from new_tensor.
        return real_pow(exp.new_tensor(float(base)), exp)

    t = port_trainer(dataset, tmp_path / "m", OptimizationConfig())
    bank = t.banks[0]
    kw = dict(active_sh_degree=0, opt_cfg=t.opt_cfg, raster_cfg=TINY,
              spatial_lr_scale=t.spatial_lr_scale)
    cams, bgs = torch.tensor([2]), torch.zeros(1, 3)
    new, m_new = steps.train_steps(steps.clone_state(t.state), bank, cams, bgs, **kw)
    monkeypatch.setattr(cameras, "_true_div", old_true_div)
    monkeypatch.setattr(preprocess, "ndc_to_pixel", old_ndc_to_pixel)
    monkeypatch.setattr(optimizer, "expon_lr", old_expon_lr)
    monkeypatch.setattr(optimizer.torch, "pow", old_pow)
    old, m_old = steps.train_steps(steps.clone_state(t.state), bank, cams, bgs, **kw)
    monkeypatch.undo()
    assert sizes, "the old image-size form was not taken"
    assert_states_equal(new, old)
    for k in steps.METRIC_DTYPES:
        assert torch.equal(getattr(m_new, k), getattr(m_old, k))
    lr = optimizer.make_lr_tree(t.opt_cfg, 2.0, torch.tensor(7, dtype=torch.int32))
    assert all(torch.equal(lr[k], torch.tensor(v, dtype=torch.float32)) for k, v in (
        ("features_dc", t.opt_cfg.feature_lr), ("opacity", t.opt_cfg.opacity_lr)))
    assert torch.equal(schedule.expon_lr(torch.tensor(5), 1e-3, 1e-5),
                       old_expon_lr(torch.tensor(5), 1e-3, 1e-5))

    # _expand without a boolean selection: starts past the budget drop out.
    start = torch.tensor([0, 0, 2, 5, 9, 9, 12], dtype=torch.int32)
    owner, s = binning._expand(start, 10)
    marks = torch.zeros(10, dtype=torch.int32)
    keep = start.long() < 10
    marks.index_add_(0, start.long()[keep], torch.ones(int(keep.sum()), dtype=torch.int32))
    assert torch.equal(owner, (torch.cumsum(marks, 0) - 1).to(torch.int32))
    assert torch.equal(s, torch.arange(10, dtype=torch.int32))


def test_profile_dir_writes_a_trace_of_steps_100_to_110(dataset, tmp_path):
    """--profile_dir: a torch.profiler session opens when a window ends in
    [100, 110) and is written as a Chrome trace once one ends at 110; its
    record holds the iterations, the trace and the port's kernel launches
    in between (none on the CPU)."""
    t = port_trainer(dataset, tmp_path / "m", OptimizationConfig(),
                     profile_dir=str(tmp_path / "prof"))
    assert t._next_boundary(95, ()) == 100 and t._next_boundary(100, ()) == 110
    t._profile_at(99)
    assert t._profiler is None
    t._profile_at(100)
    torch.zeros(4).add_(1)
    t._profile_at(110)
    assert t._profiler is None
    assert os.listdir(tmp_path / "prof") == ["trace_100_110.json"]
    rec = [e for e in t.events if "profile" in e]
    assert rec == [{"profile": [100, 110],
                    "trace": str(tmp_path / "prof" / "trace_100_110.json"),
                    "launches": dict.fromkeys(kernels.KERNEL_NAMES, 0)}]


def test_profile_dir_closes_the_session_of_a_run_ending_inside_it(dataset, tmp_path,
                                                                  monkeypatch):
    """A run that ends inside [100, 110) closes its profiler session and
    writes the trace of the windows it ran (the steps stubbed)."""
    def steps_fn(state, bank, cam_indices, bgs, **kw):
        n = len(cam_indices)
        zero = torch.zeros(n, dtype=torch.int32)
        return state, steps.StepMetrics(torch.full((n,), 0.5), torch.full((n,), 0.5),
                                        zero, zero)

    monkeypatch.setattr(trainer_mod, "train_steps", steps_fn)
    t = port_trainer(dataset, tmp_path / "m", OptimizationConfig(iterations=105),
                     profile_dir=str(tmp_path / "prof"))
    t.train(test_iterations=(), save_iterations=(), checkpoint_iterations=())
    assert t._profiler is None
    assert [e["profile"] for e in t.events if "profile" in e] == [[100, 105]]
    assert os.listdir(tmp_path / "prof") == ["trace_100_110.json"]


def test_split_seed_seeds_the_densify_generator(dataset, tmp_path, monkeypatch):
    """The split noise's generator starts at gsjax's seed 0 unless the
    Trainer is given another; cli.train.main hands its `split_seed` on."""
    import sys

    from gsjax_torch.cli import train as train_cli

    state = {seed: port_trainer(dataset, tmp_path / str(seed), OptimizationConfig(),
                                **({} if seed is None else {"split_seed": seed}))
             ._generator.get_state() for seed in (None, 0, 1)}
    assert torch.equal(state[None], state[0])
    assert not torch.equal(state[0], state[1])

    seen = {}

    class Stop(Exception):
        pass

    def trainer(*args, **kw):
        seen.update(kw)
        raise Stop

    monkeypatch.setattr(sys, "stdout", sys.stdout)
    monkeypatch.setattr(train_cli, "Trainer", trainer)
    monkeypatch.setattr(train_cli, "prepare_output_and_logger", lambda cfg: (cfg, None))
    with pytest.raises(Stop):
        train_cli.main(["-s", dataset, "-m", str(tmp_path / "cli"), "--port", "0",
                        "--data_device", "cpu", "--quiet"], split_seed=2)
    assert seen["split_seed"] == 2
