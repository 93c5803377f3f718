"""Renders served, evaluated and timed as replays of captured CUDA graphs
(gsjax_torch/render/graph.py), the port's counterpart of gsjax's jitted
renders.

On the CPU the renders stay eager; the registry, the keys, the bound
input buffers, the output copies, the evaluation's result buffers and the
render CLI's recapture on a budget growth are held here with the capture
stubbed (`stubbed`: a "graph" whose replay runs the captured body again),
against eager renders bit for bit. The `cuda` tests hold the real graphs
to eager renders on the card bit for bit; this file imports no JAX, so
on the card it runs alone with

    python -m pytest --noconftest -q tests/test_torch_render_graph.py

Scene: 200 Gaussians (capacity 256, SH degree 1) at 64x48 in 16x16 tiles
on the CPU; 5,000 at 320x240 on the card.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import pytest
import torch

from gsjax_torch.cli import render as render_cli
from gsjax_torch.config import RasterConfig
from gsjax_torch.model import PARAM_NAMES
from gsjax_torch.render import graph as graph_mod
from gsjax_torch.render.api import render
from gsjax_torch.scene import CameraBank
from gsjax_torch.synthetic import look_at_origin_camera, orbit_camera, random_scene
from gsjax_torch.tools import probe_frame
from gsjax_torch.train import step as steps_mod

torch.set_num_threads(1)
SH = 1
CFG = RasterConfig(tile_size=16, max_instances=4096, max_rows=4096)
ANGLES = (0.15, -0.2, 0.3)


def scene(device, n=200, capacity=256, seed=3):
    return random_scene(n, capacity=capacity, sh_degree=SH, seed=seed, device=device)


def views(device, w=64, h=48):
    return [look_at_origin_camera(w, h, device=device)] + [
        orbit_camera(a, width=w, height=h, device=device) for a in ANGLES]


def eager(params, aux, cam, cfg=CFG, bg=(0.0, 0.0, 0.0), scaling=1.0, **kw):
    with torch.no_grad():
        return render(params, cam, active_sh_degree=SH,
                      bg_color=torch.tensor(bg, device=params.device), cfg=cfg,
                      scaling_modifier=scaling, alive=aux.alive, **kw)


def replayed(params, aux, cam, cfg=CFG, bg=(0.0, 0.0, 0.0), scaling=1.0, **kw):
    return graph_mod.render_replayed(
        params, cam, active_sh_degree=SH, bg_color=torch.tensor(bg, device=params.device),
        cfg=cfg, scaling_modifier=scaling, alive=aux.alive, **kw)


def bank_of(cams, seed=0):
    rng = np.random.default_rng(seed)
    shape = (cams[0].height, cams[0].width)
    rgbs = [rng.integers(0, 256, (3, *shape), dtype=np.uint8) for _ in cams]
    alphas = [np.full((1, *shape), 255, np.uint8) for _ in cams]
    return CameraBank.from_cameras(cams, rgbs, alphas)


def bitwise(a, b) -> bool:
    return a.shape == b.shape and a.numpy().tobytes() == b.numpy().tobytes()


class StubGraph:
    """A captured graph on the CPU: replay() runs the body again."""

    def __init__(self, body):
        self.replay = body


@pytest.fixture
def stubbed(monkeypatch):
    """Graphs on CPU tensors, the capture stubbed: it runs the body once
    (as a capture records it) and returns a StubGraph. Yields the capture
    records."""
    records = []

    def capture(body, device, record, warm_up=None):
        body()
        records.append(record)
        return StubGraph(body), {}

    monkeypatch.setattr(graph_mod, "uses_graphs", lambda device: True)
    monkeypatch.setattr(graph_mod, "capture_graph", capture)
    graph_mod.drop_render_graphs()
    yield records
    graph_mod.drop_render_graphs()


# --- the CPU -----------------------------------------------------------------------


def test_cpu_renders_stay_eager():
    params, aux = scene("cpu")
    graph_mod.drop_render_graphs()
    graph_mod.reset_graph_counts()
    cam = views("cpu")[0]
    assert bitwise(replayed(params, aux, cam).image, eager(params, aux, cam).image)
    assert not graph_mod._GRAPHS and not graph_mod.captures


def test_render_key_holds_gsjax_key():
    """gsjax's render_view key (width, height, SH degree, the SH and
    covariance paths, fast, RasterConfig; gsjax/train/trainer.py:237-240)
    and the bound scene: each field moves the key."""
    params, aux = scene("cpu")
    other, _ = scene("cpu", capacity=512)
    base = dict(width=64, height=48, active_sh_degree=1, cfg=CFG,
                convert_shs_outside=False, compute_cov3d_outside=False)

    def key(p=params, alive=aux.alive, **kw):
        a = {**base, **kw}
        return graph_mod.render_key(p, alive, a.pop("width"), a.pop("height"), **a)

    variants = [key(width=32), key(height=24), key(active_sh_degree=0),
                key(convert_shs_outside=True), key(compute_cov3d_outside=True),
                key(cfg=dataclasses.replace(CFG, fast_fwd=True)),
                key(cfg=dataclasses.replace(CFG, max_instances=8192)),
                key(p=other), key(alive=aux.alive.clone())]
    assert key() == key() and len({key(), *variants}) == len(variants) + 1


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
def test_replays_read_each_calls_inputs(stubbed, fast):
    """One capture serves every view of a key: each replay reads the
    view's camera, the background and the scaling modifier from the bound
    buffers, and the caller's frames are copies (two kept frames differ)."""
    params, aux = scene("cpu")
    cfg = dataclasses.replace(CFG, fast_fwd=fast)
    cams = views("cpu")
    calls = [(cams[0], (0.0, 0.0, 0.0), 1.0), (cams[1], (0.2, 0.5, 0.9), 1.0),
             (cams[2], (1.0, 1.0, 1.0), 0.7), (cams[3], (0.0, 0.3, 0.0), 1.3)]
    frames = [replayed(params, aux, c, cfg, bg, s) for c, bg, s in calls]
    assert len(stubbed) == 1
    for (c, bg, s), got in zip(calls, frames):
        want = eager(params, aux, c, cfg, bg, s)
        assert bitwise(got.image, want.image)
        assert int(got.num_instances) == int(want.num_instances)
    assert not bitwise(frames[0].image, frames[1].image)


def test_outside_paths_replay(stubbed):
    """The standalone SH and covariance paths (compute_cov3D_python,
    convert_SHs_python) under the graph, against eager."""
    params, aux = scene("cpu")
    cam = views("cpu")[1]
    kw = dict(convert_shs_outside=True, compute_cov3d_outside=True)
    for s in (1.0, 0.8):
        assert bitwise(replayed(params, aux, cam, scaling=s, **kw).image,
                       eager(params, aux, cam, scaling=s, **kw).image)


def test_registry_lru_and_drops(stubbed):
    """At most RENDER_GRAPH_CAP live graphs, the least recently used
    dropped first; a hit captures nothing; capturing for another scene
    drops the old scene's graphs; drop_render_graphs drops all."""
    params, aux = scene("cpu")
    sizes = [(16 * (k + 1), 16) for k in range(graph_mod.RENDER_GRAPH_CAP + 1)]
    for w, h in sizes:
        replayed(params, aux, look_at_origin_camera(w, h, device="cpu"))
    assert len(stubbed) == len(sizes)
    assert len(graph_mod._GRAPHS) == graph_mod.RENDER_GRAPH_CAP
    assert {k[0] for k in graph_mod._GRAPHS} == {w for w, _ in sizes[1:]}
    replayed(params, aux, look_at_origin_camera(*sizes[1], device="cpu"))  # a hit
    assert len(stubbed) == len(sizes)
    replayed(params, aux, look_at_origin_camera(*sizes[0], device="cpu"))  # dropped: again
    assert len(stubbed) == len(sizes) + 1
    assert sizes[2][0] not in {k[0] for k in graph_mod._GRAPHS}  # the LRU one went
    other, other_aux = scene("cpu", seed=5)
    replayed(other, other_aux, look_at_origin_camera(*sizes[0], device="cpu"))
    assert len(graph_mod._GRAPHS) == 1
    graph_mod.drop_render_graphs()
    assert not graph_mod._GRAPHS


def test_frames_keep_step_graphs(stubbed):
    """A frame leaves the captured steps' registry as it is; dropping the
    step graphs (growth, budgets, a new Trainer) drops the renders too."""
    params, aux = scene("cpu")
    sentinel = object()
    steps_mod._GRAPHS[("sentinel",)] = sentinel
    try:
        replayed(params, aux, views("cpu")[0])
        assert steps_mod._GRAPHS == {("sentinel",): sentinel}
        assert len(graph_mod._GRAPHS) == 1
        steps_mod.drop_step_graphs()
        assert not steps_mod._GRAPHS and not graph_mod._GRAPHS
    finally:
        steps_mod._GRAPHS.pop(("sentinel",), None)


def test_eval_graph_equals_eager(stubbed, monkeypatch):
    """The evaluation through one captured view (result rows at a cursor,
    EVAL_VIEWS rows a series) against the eager loop, bit for bit."""
    params, aux = scene("cpu")
    bank = bank_of(views("cpu"))
    idxs = [2, 0, 3, 1, 2]
    kw = dict(bg_color=torch.tensor([0.1, 0.2, 0.3]), active_sh_degree=SH, cfg=CFG)
    monkeypatch.setattr(graph_mod, "EVAL_VIEWS", 2)
    got = graph_mod.eval_views(params, aux.alive, bank, idxs, **kw)
    again = graph_mod.eval_views(params, aux.alive, bank, idxs[:2], **kw)
    assert len(stubbed) == 1 and stubbed[0]["graph"] == "eval"
    monkeypatch.setattr(graph_mod, "uses_graphs", lambda device: False)
    want = graph_mod.eval_views(params, aux.alive, bank, idxs, **kw)
    assert got.shape == (2, len(idxs)) and bitwise(got, want)
    assert bitwise(again, want[:, :2])


def test_render_set_grows_and_recaptures(stubbed, monkeypatch, tmp_path):
    """render_set with budgets too small: the frame that overflows drops
    the captured renders and is rendered again at the grown budgets (one
    capture each), and the saved frames equal eager renders at them."""
    params, aux = scene("cpu")
    cams = views("cpu")
    saved = {}
    monkeypatch.setattr(render_cli, "save_png",
                        lambda path, image: saved.__setitem__(path, image.clone()))
    small = RasterConfig(tile_size=16, max_instances=128, max_rows=128)
    bg = torch.zeros(3)
    cfg = render_cli.render_set(str(tmp_path), "test", 7, [bank_of(cams)], params,
                                aux.alive, SH, bg, small)
    assert (cfg.max_instances, cfg.max_rows) != (128, 128)
    assert [r["budgets"] for r in stubbed][0] == [128, 128]
    assert stubbed[-1]["budgets"] == [cfg.max_instances, cfg.max_rows]
    assert len(graph_mod._GRAPHS) == 1
    renders = sorted(p for p in saved if "/renders/" in p)
    assert len(renders) == len(cams)
    for path, cam in zip(renders, cams):
        assert bitwise(saved[path], eager(params, aux, cam, cfg).image)


def test_frame_probe_names_each_differing_tensor():
    """probe_frame's comparison: every state tensor and metric by name,
    bit for bit, each one that differs with its largest difference (NaN
    where no difference is finite)."""
    n = len(probe_frame.STATE_NAMES) + len(steps_mod.METRIC_DTYPES)
    want = [torch.arange(4, dtype=torch.float32) for _ in range(n)]
    got = [t.clone() for t in want]
    assert probe_frame.differences(got, want) == {}
    got[0][1] += 0.25
    got[-4][0] = float("nan")
    got[-1] = torch.tensor([7, 1, 2, 3], dtype=torch.float32)
    diff = probe_frame.differences(got, want)
    assert list(diff) == [f"params.{PARAM_NAMES[0]}", "metrics.loss", "metrics.num_rows"]
    assert diff[f"params.{PARAM_NAMES[0]}"] == 0.25 and diff["metrics.num_rows"] == 7.0
    assert diff["metrics.loss"] == 0.0  # NaN against 0 and equal elsewhere
    with pytest.raises(ValueError):
        probe_frame.differences(got[:-1], want)


# --- the card ----------------------------------------------------------------------

CARD_CFG = RasterConfig(tile_size=16, max_instances=1 << 17, max_rows=1 << 16)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from gsjax_torch.render import kernels

    kernels.build()
    return torch.device("cuda")


def card_scene(card):
    return random_scene(5000, sh_degree=SH, seed=3, spread=1.5, device=card)


@pytest.mark.cuda
def test_replays_equal_eager_on_card(card):
    """The four serving views, exact and fast_fwd, a background and a
    scaling modifier per view, and the standalone SH and covariance paths:
    replays of one graph per key equal eager renders bit for bit; frames
    kept are the caller's."""
    params, aux = card_scene(card)
    cams = views(card, 320, 240)
    graph_mod.drop_render_graphs()
    graph_mod.reset_graph_counts()
    for fast in (False, True):
        cfg = dataclasses.replace(CARD_CFG, fast_fwd=fast)
        frames = [replayed(params, aux, c, cfg, (0.1 * k, 0.2, 0.3), 1.0 - 0.1 * k)
                  for k, c in enumerate(cams)]
        for k, (c, got) in enumerate(zip(cams, frames)):
            want = eager(params, aux, c, cfg, (0.1 * k, 0.2, 0.3), 1.0 - 0.1 * k)
            assert torch.equal(got.image.view(torch.int32), want.image.view(torch.int32))
            assert int(got.num_instances) == int(want.num_instances)
    outside = dict(convert_shs_outside=True, compute_cov3d_outside=True)
    got = replayed(params, aux, cams[1], CARD_CFG, scaling=0.8, **outside).image
    want = eager(params, aux, cams[1], CARD_CFG, scaling=0.8, **outside).image
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert [c["graph"] for c in graph_mod.captures] == ["render"] * 3
    graph_mod.drop_render_graphs()


@pytest.mark.cuda
def test_eval_graph_equals_eager_on_card(card, monkeypatch):
    params, aux = card_scene(card)
    bank = bank_of(views(card, 320, 240))
    kw = dict(bg_color=torch.tensor([0.1, 0.2, 0.3], device=card), active_sh_degree=SH,
              cfg=CARD_CFG)
    graph_mod.drop_render_graphs()
    got = graph_mod.eval_views(params, aux.alive, bank, [3, 1, 0, 2, 1], **kw).cpu()
    monkeypatch.setattr(graph_mod, "uses_graphs", lambda device: False)
    want = graph_mod.eval_views(params, aux.alive, bank, [3, 1, 0, 2, 1], **kw).cpu()
    assert bitwise(got, want)
    graph_mod.drop_render_graphs()


@pytest.mark.cuda
def test_render_set_grows_on_card(card, monkeypatch, tmp_path):
    params, aux = card_scene(card)
    cams = views(card, 320, 240)
    saved = {}
    monkeypatch.setattr(render_cli, "save_png",
                        lambda path, image: saved.__setitem__(path, image.cpu()))
    graph_mod.drop_render_graphs()
    graph_mod.reset_graph_counts()
    small = RasterConfig(tile_size=16, max_instances=1024, max_rows=1024)
    cfg = render_cli.render_set(str(tmp_path), "test", 7, [bank_of(cams)], params,
                                aux.alive, SH, torch.zeros(3, device=card), small)
    budgets = [c["budgets"] for c in graph_mod.captures]
    assert budgets[0] == [1024, 1024] and budgets[-1] == [cfg.max_instances, cfg.max_rows]
    renders = sorted(p for p in saved if "/renders/" in p)
    for path, cam in zip(renders, cams):
        want = eager(params, aux, cam, cfg).image.cpu()
        assert bitwise(saved[path], want)
    graph_mod.drop_render_graphs()


@pytest.mark.cuda
def test_replays_launch_the_row_gather_on_card(card):
    """Counted through executed_launches: a replayed training step launches
    the row gather four times (the fields' depth permute and its backward,
    the instance stream, the owner regroup), a replayed view twice."""
    from gsjax_torch.render import kernels

    windows = probe_frame.Windows(card)
    cams = torch.tensor(probe_frame.WINDOW, dtype=torch.int32)
    bgs = torch.zeros((len(probe_frame.WINDOW), 3))
    steps_mod.drop_step_graphs()
    steps_mod.train_steps(windows.state, windows.bank, cams, bgs, **windows.kw)
    windows.frame()  # the captures
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    graph_mod.reset_graph_counts()
    steps_mod.train_steps(windows.state, windows.bank, cams, bgs, **windows.kw)
    torch.cuda.synchronize()
    assert graph_mod.executed_launches()["row_gather"] == 4 * len(probe_frame.WINDOW)
    kernels.reset_launch_counts()
    graph_mod.reset_graph_counts()
    windows.frame()
    torch.cuda.synchronize()
    assert not graph_mod.captures
    assert graph_mod.executed_launches()["row_gather"] == 2
    steps_mod.drop_step_graphs()


@pytest.mark.cuda
def test_frame_between_windows_on_card(card):
    """A viewer frame (a replayed fast render of the training state)
    between two windows of replayed steps leaves the captured step in its
    registry, and the state after the next window equal bit for bit to that
    of a run without the frame, whether the frame's render graph is
    captured between the windows or already registered; two runs without
    a frame are equal bit for bit too (gsjax_torch/tools/probe_frame.py).
    GSJAX_FRAME_RUNS sets the rounds (1 by default; 30 for the stress)."""
    rounds = probe_frame.frame_rounds(card, int(os.environ.get("GSJAX_FRAME_RUNS", "1")))
    for case, records in rounds.items():
        for i, r in enumerate(records):
            assert r["registry_kept"], f"{case}, round {i}: the frame changed the step registry"
            assert not r["differ"], (
                f"{case}, round {i}: tensors that differ from the run without a frame, "
                f"with their largest difference: {r['differ']}")
    assert not steps_mod._GRAPHS
