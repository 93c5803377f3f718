"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU and nvcc: every test is marked `cuda` and skips
without a card. This file imports no JAX, so on a machine without JAX it
runs alone with

    python -m pytest --noconftest -q tests/test_torch_kernels.py

Inputs are real: a synthetic scene goes through the port's own CPU
pipeline, and each kernel's arguments are recorded from that run.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from gsjax_torch.config import RasterConfig
from gsjax_torch.render import kernels
from gsjax_torch.render.api import render
from gsjax_torch.synthetic import look_at_origin_camera, random_scene

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda
W, H = 160, 120
BG = (0.2, 0.3, 0.4)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    kernels.build()
    return torch.device("cuda")


def _record(monkeypatch, name):
    """Record the arguments of every call of kernels.<name>."""
    calls = []
    real = getattr(kernels, name)

    def recorder(*args, **kwargs):
        calls.append((args, kwargs))
        return real(*args, **kwargs)

    monkeypatch.setattr(kernels, name, recorder)
    return calls


def _cpu_render(cfg, n=1500, seed=3):
    params, aux = random_scene(n, seed=seed, spread=1.5, device="cpu")
    cam = look_at_origin_camera(W, H, device="cpu")
    with torch.no_grad():
        return render(
            params, cam, active_sh_degree=3, bg_color=torch.tensor(BG),
            cfg=cfg, alive=aux.alive,
        )


def _to(dev, args, kwargs):
    move = lambda v: v.to(dev) if isinstance(v, torch.Tensor) else v
    return [move(a) for a in args], {k: move(v) for k, v in kwargs.items()}


CFGS = {
    "16x16": RasterConfig(tile_size=16, max_instances=1 << 14, max_rows=1 << 13),
    "32x16": RasterConfig(tile_w=32, tile_h=16, max_instances=1 << 14, max_rows=1 << 13),
    "overflow": RasterConfig(tile_size=16, max_instances=1024, max_rows=512),
}


@pytest.mark.parametrize("cfg", list(CFGS), ids=list(CFGS))
def test_row_engine_and_rank_prefix_match_plain(card, cfg, monkeypatch):
    rows = _record(monkeypatch, "row_engine")
    ranks = _record(monkeypatch, "rank_prefix")
    _cpu_render(CFGS[cfg])
    for calls, name in ((rows, "row_engine"), (ranks, "rank_prefix")):
        args, kwargs = calls[-1]
        want = getattr(kernels, f"{name}_plain")(*args, **kwargs)
        a, kw = _to(card, args, kwargs)
        got = getattr(kernels, name)(*a, **kw)
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.cpu().numpy(), w.numpy(), name)


@pytest.mark.parametrize("plus_iota,init", [(True, 0), (False, -1), (False, 7)])
def test_rank_prefix_wraparound(card, plus_iota, init):
    rng = np.random.default_rng(11)
    counts = rng.integers(0, 4, 3000)
    start = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    delta = rng.integers(2**32 - 64, 2**32, 3000, dtype=np.uint64).astype(np.uint32)
    s, d = torch.from_numpy(start), torch.from_numpy(delta.view(np.int32))
    budget = 4000
    want = kernels.rank_prefix_plain(s, d, budget=budget, plus_iota=plus_iota, init=init)
    got = kernels.rank_prefix(
        s.to(card), d.to(card), budget=budget, plus_iota=plus_iota, init=init,
    )
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
@pytest.mark.parametrize("cfg", ["16x16", "32x16"])
def test_composite_forward_matches_plain(card, cfg, fast, monkeypatch):
    calls = _record(monkeypatch, "composite_forward")
    _cpu_render(CFGS[cfg])
    args, kwargs = calls[-1]
    kwargs = dict(kwargs, fast=fast)
    want_c, want_t = kernels.composite_forward_plain(*args, **kwargs)
    a, kw = _to(card, args, kwargs)
    got_c, got_t = kernels.composite_forward(*a, **kw)
    atol = 4e-3 if fast else 2e-3
    np.testing.assert_allclose(got_c.cpu().numpy(), want_c.numpy(), atol=atol)
    np.testing.assert_allclose(got_t.cpu().numpy(), want_t.numpy(), atol=atol)


def test_render_on_card_matches_cpu(card):
    cfg = CFGS["16x16"]
    cpu = _cpu_render(cfg)
    params, aux = random_scene(1500, seed=3, spread=1.5, device=card)
    cam = look_at_origin_camera(W, H, device=card)
    kernels.reset_launch_counts()
    with torch.no_grad():
        out = render(
            params, cam, active_sh_degree=3,
            bg_color=torch.tensor(BG, device=card), cfg=cfg, alive=aux.alive,
        )
    assert all(kernels.launch_counts[k] == 1 for k in kernels.KERNEL_NAMES)
    assert int(out.num_instances) == int(cpu.num_instances)
    assert int(out.num_rows) == int(cpu.num_rows)
    np.testing.assert_allclose(
        out.image.cpu().numpy(), cpu.image.numpy(), atol=2e-3, rtol=1e-3
    )
