"""The port's LPIPS-vgg on the CPU against gsjax's, with the same npz of
random weights (tests/test_lpips.py's: pretrained ones cannot be fetched):
the distance, zero for identical images, the weights check (digest and
violations), and cli.metrics writing a finite LPIPS when
GSJAX_LPIPS_WEIGHTS names the npz."""

from __future__ import annotations

import json
import os

import jax
import numpy as np
import pytest
import torch

import gsjax.image_metrics as jmetrics
from gsjax_torch import image_metrics
from gsjax_torch.cli import metrics as metrics_cli
from tests.test_lpips import SEED, _random_weights

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """tests/test_lpips.py's weights and 48x64 image pair, with gsjax's
    distance computed once (jitted: one compile)."""
    rng = np.random.default_rng(SEED)
    weights = _random_weights(rng)
    path = str(tmp_path_factory.mktemp("lpips") / "weights.npz")
    np.savez(path, **weights)
    x = rng.uniform(0, 1, (1, 3, 48, 64)).astype(np.float32)
    y = np.clip(x + rng.normal(0, 0.08, x.shape).astype(np.float32), 0, 1)
    want = float(np.asarray(jax.jit(lambda a, b: jmetrics.lpips(a, b, weights=path))(
        x[0], y[0]))[0])
    return path, x, y, want


def test_lpips_matches_gsjax(pair):
    path, x, y, want = pair
    got = image_metrics.lpips(torch.from_numpy(x[0]), torch.from_numpy(y[0]), weights=path)
    assert got.shape == (1,) and want > 0
    np.testing.assert_allclose(float(got[0]), want, rtol=2e-4)
    # A batch scores each pair as alone.
    both = image_metrics.lpips(torch.from_numpy(np.concatenate([x, y])),
                               torch.from_numpy(np.concatenate([y, y])), weights=path)
    np.testing.assert_allclose(float(both[0]), want, rtol=2e-4)
    assert abs(float(both[1])) < 1e-7


def test_identical_images_score_zero(pair):
    path, x, _, _ = pair
    d = image_metrics.lpips(torch.from_numpy(x[0]), torch.from_numpy(x[0]), weights=path)
    assert abs(float(d[0])) < 1e-7


def test_lpips_refusals(pair, monkeypatch):
    path, x, y, _ = pair
    a, b = torch.from_numpy(x[0]), torch.from_numpy(y[0])
    with pytest.raises(NotImplementedError):
        image_metrics.lpips(a, b, net_type="alex", weights=path)
    monkeypatch.delenv("GSJAX_LPIPS_WEIGHTS", raising=False)
    assert image_metrics.lpips_available() is False
    with pytest.raises(RuntimeError, match="GSJAX_LPIPS_WEIGHTS"):
        image_metrics.lpips(a, b)
    monkeypatch.setenv("GSJAX_LPIPS_WEIGHTS", path)
    assert image_metrics.lpips_weights_path() == jmetrics.lpips_weights_path() == path
    assert image_metrics.lpips_available()


def test_spec_table_matches_gsjax():
    assert image_metrics.expected_lpips_members() == jmetrics.expected_lpips_members()


def test_check_weights_matches_gsjax(tmp_path, capsys):
    rng = np.random.default_rng(0)
    weights = _random_weights(rng)
    good = str(tmp_path / "good.npz")
    np.savez(good, **weights)
    assert image_metrics.check_lpips_weights(good) == jmetrics.check_lpips_weights(good)
    image_metrics.main(["--check-weights", good])
    out = capsys.readouterr().out
    assert f"sha256: {jmetrics.check_lpips_weights(good)}" in out

    bad = dict(weights)
    bad["conv0.w"] = bad["conv0.w"][:32]
    bad["lin0.w"] = bad["lin0.w"].astype(np.float64)
    bad["conv3.b"] = np.full_like(bad["conv3.b"], np.nan)
    bad["extra"] = np.zeros(2, np.float32)
    del bad["conv12.b"]
    bad_path = str(tmp_path / "bad.npz")
    np.savez(bad_path, **bad)
    messages = []
    for check in (image_metrics.check_lpips_weights, jmetrics.check_lpips_weights):
        with pytest.raises(ValueError) as e:
            check(bad_path)
        messages.append(str(e.value))
    assert messages[0] == messages[1]
    assert all(k in messages[0] for k in ("conv0.w", "lin0.w", "conv3.b", "extra", "conv12.b"))


def test_metrics_cli_writes_lpips(pair, tmp_path, monkeypatch):
    """cli.metrics with GSJAX_LPIPS_WEIGHTS set: results.json and
    per_view.json carry the LPIPS of each view (held to gsjax above), as
    gsjax's CLI writes them (reference: metrics.py:71-74)."""
    from PIL import Image

    path = pair[0]
    monkeypatch.setenv("GSJAX_LPIPS_WEIGHTS", path)
    rng = np.random.default_rng(SEED)
    method = tmp_path / "model" / "test" / "ours_7"
    for sub in ("renders", "gt"):
        os.makedirs(method / sub)
    want = []
    for i in range(2):
        a = rng.integers(0, 255, (32, 48, 3), dtype=np.uint8)
        b = np.clip(a.astype(np.int32) + rng.integers(-20, 20, a.shape), 0, 255).astype(np.uint8)
        Image.fromarray(a).save(method / "renders" / f"{i:05d}.png")
        Image.fromarray(b).save(method / "gt" / f"{i:05d}.png")
        want.append(float(image_metrics.lpips(
            torch.from_numpy(a.transpose(2, 0, 1).astype(np.float32) / 255.0),
            torch.from_numpy(b.transpose(2, 0, 1).astype(np.float32) / 255.0))[0]))
    metrics_cli.main(["-m", str(tmp_path / "model"), "--device", "cpu"])
    with open(tmp_path / "model" / "results.json") as f:
        val = json.load(f)["ours_7"]["LPIPS"]
    assert val is not None and np.isfinite(val) and val > 0.0
    np.testing.assert_allclose(val, np.mean(want), rtol=2e-4)
    with open(tmp_path / "model" / "per_view.json") as f:
        per_view = json.load(f)["ours_7"]["LPIPS"]
    np.testing.assert_allclose([per_view[k] for k in sorted(per_view)], want, rtol=2e-4)
