"""The port's CLIs, image metrics and process utilities on the CPU.

Held to gsjax: the train parser's flags (names, shorthands, defaults;
`--data_device` defaults to cuda, gsjax's to tpu; the port's own 3DGS-MCMC
flags, config.MCMC_FIELDS, apart, and `--densify_until_iter` without a
default, which OptimizationConfig resolves by strategy), the config groups render
parses, MSE and PSNR on the same numpy images, the convert and full_eval
command lines (full_eval launching the port's CLIs), and the synthetic
quality scene's files. Then the port's own train -> render -> metrics
through each CLI's main(argv) on a tiny dataset, writing results.json
with SSIM and PSNR and LPIPS null.
"""

from __future__ import annotations

import json
import os
import random
import sys
from argparse import ArgumentParser

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsjax.cli.args as jargs
import gsjax.cli.convert as jconvert
import gsjax.config as jconfig
import gsjax.image_metrics as jmetrics
from gsjax_torch import config, image_metrics
from gsjax_torch.cli import args, convert, full_eval
from gsjax_torch.cli import metrics as metrics_cli
from gsjax_torch.cli import render as render_cli
from gsjax_torch.cli import train as train_cli
from gsjax_torch.train import trainer as trainer_mod
from gsjax_torch.utils.general import safe_state
from tests.test_torch_trainer import TINY, write_blender_dataset

torch.set_num_threads(1)


def flags(parser: ArgumentParser) -> dict:
    return {a.dest: (tuple(a.option_strings), a.default, a.nargs, type(a).__name__)
            for a in parser._actions}


def mcmc_flags(got: dict) -> dict:
    """Take the port's own 3DGS-MCMC flags out of `got`."""
    return {k: got.pop(k) for k in config.MCMC_FIELDS}


def check_until_flag(got: dict, want: dict) -> None:
    """Take --densify_until_iter out of both: the port's defaults to None
    (OptimizationConfig resolves it by strategy, 15,000 under "adaptive"),
    gsjax's to 15,000 or, filled, None; names, nargs and action alike."""
    g, w = got.pop("densify_until_iter"), want.pop("densify_until_iter")
    assert (g[0], g[2], g[3]) == (w[0], w[2], w[3])
    assert g[1] is None and w[1] in (None, config.OptimizationConfig().densify_until_iter)


def test_train_parser_matches_gsjax():
    got, want = flags(args.make_train_parser()), flags(jargs.make_train_parser())
    assert mcmc_flags(got)["densify_strategy"][:2] == (("--densify_strategy",), "adaptive")
    check_until_flag(got, want)
    assert got.keys() == want.keys()
    assert got.pop("data_device")[1] == "cuda" and want.pop("data_device")[1] == "tpu"
    assert got == want


@pytest.mark.parametrize("fill_none", [False, True])
@pytest.mark.parametrize("group", ["ModelConfig", "OptimizationConfig", "PipelineConfig"])
def test_config_group_flags_match_gsjax(group, fill_none):
    got, want = ArgumentParser(), ArgumentParser()
    args.add_group(got, getattr(config, group), fill_none=fill_none)
    jargs.add_group(want, getattr(jconfig, group), fill_none=fill_none)
    got, want = flags(got), flags(want)
    if group == "OptimizationConfig":
        assert set(mcmc_flags(got)) == set(config.MCMC_FIELDS)
        check_until_flag(got, want)
    if group == "ModelConfig" and not fill_none:
        assert got.pop("data_device")[1] == "cuda" and want.pop("data_device")[1] == "tpu"
    assert got == want


def test_mse_and_psnr_match_gsjax():
    rng = np.random.default_rng(0)
    for shape in ((3, 16, 24), (2, 3, 16, 24)):
        a = rng.uniform(0, 1, shape).astype(np.float32)
        b = np.clip(a + 0.1 * rng.standard_normal(shape), 0, 1).astype(np.float32)
        got_m = image_metrics.mse(torch.from_numpy(a), torch.from_numpy(b)).numpy()
        got_p = image_metrics.psnr(torch.from_numpy(a), torch.from_numpy(b)).numpy()
        want_m = np.asarray(jmetrics.mse(jnp.asarray(a), jnp.asarray(b)))
        want_p = np.asarray(jmetrics.psnr(jnp.asarray(a), jnp.asarray(b)))
        assert got_m.shape == want_m.shape and got_p.shape == want_p.shape
        # f32 means summed in another order: within a few ulps.
        np.testing.assert_allclose(got_m, want_m, rtol=1e-6)
        np.testing.assert_allclose(got_p, want_p, rtol=1e-6)
    assert image_metrics.lpips_available() is False


@pytest.fixture()
def captured_system(monkeypatch):
    cmds: list[str] = []
    monkeypatch.setattr(os, "system", lambda cmd: cmds.append(cmd) or 0)
    return cmds


def test_convert_commands_match_gsjax(captured_system, tmp_path):
    for argv in ([], ["--no_gpu", "--colmap_executable", "/usr/local/bin/colmap"],
                 ["--skip_matching"]):
        runs = []
        for module in (convert, jconvert):
            src = tmp_path / module.__name__ / str(len(argv)) / "scene"
            (src / "sparse").mkdir(parents=True)
            captured_system.clear()
            module.main(["-s", str(src), *argv])
            runs.append([c.replace(str(src), "<src>") for c in captured_system])
            assert (src / "sparse" / "0").is_dir()
        assert runs[0] == runs[1] and runs[0]


def test_full_eval_launches_the_port_clis(captured_system):
    full_eval.main(["-m360", "/data/m360", "-tat", "/data/tat", "-db", "/data/db",
                    "--output_path", "/out"])
    kinds = [c.split()[2] for c in captured_system]
    assert kinds == (["gsjax_torch.cli.train"] * 13 + ["gsjax_torch.cli.render"] * 26
                     + ["gsjax_torch.cli.metrics"])
    assert all(c.split()[1] == "-m" for c in captured_system)
    assert "--quiet --eval --test_iterations -1" in captured_system[0]
    with pytest.raises(SystemExit):
        full_eval.main(["-m360", "/data/m360"])


def test_safe_state_seeds_every_rng(monkeypatch):
    monkeypatch.setattr(sys, "stdout", sys.stdout)
    safe_state(silent=True, seed=3)
    draws = (random.random(), np.random.random(), float(torch.rand(())))
    safe_state(silent=True, seed=3)
    assert draws == (random.random(), np.random.random(), float(torch.rand(())))


def test_train_cli_refuses_what_is_not_ported(tmp_path):
    """--orbax is not ported; a mesh asked for in one process (no torchrun)
    is refused with a message naming torchrun."""
    with pytest.raises(NotImplementedError):
        train_cli.main(["-s", str(tmp_path), "-m", str(tmp_path / "m"), "--orbax"])
    for extra in (["--data_parallel", "2"], ["--tile_parallel", "2"]):
        with pytest.raises(RuntimeError, match="torchrun --nproc_per_node 2"):
            train_cli.main(["-s", str(tmp_path), "-m", str(tmp_path / "m"), *extra])


def test_synthetic_scene_matches_the_gsjax_tool(tmp_path):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from gsjax_torch.tools import synthetic_scene as ours
    from tools import synthetic_scene as theirs

    kw = dict(res=12, n_train=2, n_test=1, n_spheres=3, n_seed_points=40)
    a = ours.generate(str(tmp_path / "a"), **kw)
    b = theirs.generate(str(tmp_path / "b"), **kw)
    files = sorted(os.path.relpath(os.path.join(d, f), a)
                   for d, _, fs in os.walk(a) for f in fs)
    assert len(files) == 6
    for f in files:
        with open(os.path.join(a, f), "rb") as fa, open(os.path.join(b, f), "rb") as fb:
            assert fa.read() == fb.read(), f


class Writer:
    """Stands in for torch.utils.tensorboard.SummaryWriter (whose import
    loads TensorFlow here): records each call's name and tag."""

    calls: list = []

    def __init__(self, log_dir):
        self.calls.clear()

    def __getattr__(self, name):
        return lambda tag=None, *a, **kw: self.calls.append((name, tag))


def test_train_render_metrics(tmp_path, monkeypatch):
    """cli.train -> cli.render -> cli.metrics through main(argv) on the
    CPU, at the tests' tiny budgets (the CLIs' own default is 2^21 pairs,
    which the plain binning would sort on every step)."""
    import types

    monkeypatch.setattr(sys, "stdout", sys.stdout)
    monkeypatch.setattr(trainer_mod, "RasterConfig", lambda: TINY)
    monkeypatch.setattr(render_cli, "RasterConfig", lambda: TINY)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard",
                        types.SimpleNamespace(SummaryWriter=Writer))
    data = write_blender_dataset(str(tmp_path / "data"))
    model = str(tmp_path / "model")
    trainer = train_cli.main([
        "-s", data, "-m", model, "--eval", "--iterations", "4",
        "--save_iterations", "4", "--test_iterations", "4", "--port", "0",
        "--data_device", "cpu", "--quiet",
    ])
    assert int(trainer.state.step) == 4
    assert [e["eval"] for e in trainer.events if "eval" in e] == ["test", "train"]
    # The TensorBoard report (reference: train.py:176-189).
    tags = {tag for _, tag in Writer.calls if tag}
    assert {"train_loss_patches/l1_loss", "test/loss_viewpoint - psnr",
            "scene/opacity_histogram", "total_points"} <= tags
    assert any(t.endswith("/ground_truth") for t in tags)
    assert sum(name == "add_images" and tag.endswith("/render")
               for name, tag in Writer.calls) == 7
    assert ("close", None) in Writer.calls
    for f in ("cfg_args", "cameras.json", "input.ply",
              os.path.join("point_cloud", "iteration_4", "point_cloud.ply")):
        assert os.path.exists(os.path.join(model, f)), f

    render_cli.main(["-m", model, "--iteration", "4", "--skip_train", "--quiet"])
    assert len(os.listdir(os.path.join(model, "test", "ours_4", "renders"))) == 2
    assert not os.path.exists(os.path.join(model, "train"))

    metrics_cli.main(["-m", model, "--device", "cpu"])
    with open(os.path.join(model, "results.json")) as f:
        method = json.load(f)["ours_4"]
    assert set(method) == {"SSIM", "PSNR", "LPIPS"}
    assert 0.0 < method["SSIM"] <= 1.0 and method["PSNR"] > 5.0
    assert method["LPIPS"] is None
    with open(os.path.join(model, "per_view.json")) as f:
        per_view = json.load(f)["ours_4"]
    assert sorted(per_view["PSNR"]) == ["00000.png", "00001.png"]
