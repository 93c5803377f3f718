"""The port's CUDA kernels against their plain PyTorch versions, on the card:
the render path's (render/kernels.py, tiles up to 64x64) and the profiling
tools' (tools/kernels.py); the culled composite kernels against their
twins without the cull, bit for bit; the ablation probes against the
kernels they launch as (blockout and replay_fwd bit for bit).

Needs an NVIDIA GPU and nvcc: every test is marked `cuda` and skips
without a card. This file imports no JAX, so on a machine without JAX it
runs alone with

    python -m pytest --noconftest -q tests/test_torch_kernels.py

Inputs are real: a synthetic scene goes through the port's own CPU
pipeline, and each kernel's arguments are recorded from that run.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from gsjax_torch.config import RasterConfig
from gsjax_torch.model import PARAM_NAMES
from gsjax_torch.render import kernels
from gsjax_torch.render.api import render
from gsjax_torch.synthetic import look_at_origin_camera, random_scene
from gsjax_torch.tools import expand_cases
from gsjax_torch.tools import kernels as tool_kernels
from gsjax_torch.tools.common import instance_stream

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


def _render_grads(dev, cfg, n=1500, seed=3):
    """The image and the raw parameters' gradients of mean(image^2)."""
    params, aux = random_scene(n, seed=seed, spread=1.5, device=dev)
    cam = look_at_origin_camera(W, H, device=dev)
    out = render(
        params, cam, active_sh_degree=3,
        bg_color=torch.tensor(BG, device=dev), cfg=cfg, alive=aux.alive,
    )
    leaves = [getattr(params, k) for k in PARAM_NAMES]
    grads = torch.autograd.grad(torch.mean(out.image ** 2), leaves)
    return out, dict(zip(PARAM_NAMES, grads))


def _scaled_close(got, want, atol=5e-3, what=""):
    scale = max(float(want.abs().max()), 1e-8)
    np.testing.assert_allclose(
        got.cpu().numpy() / scale, want.cpu().numpy() / scale, atol=atol,
        err_msg=what,
    )


def _to(dev, args, kwargs):
    move = lambda v: v.to(dev) if isinstance(v, torch.Tensor) else v
    return [move(a) for a in args], {k: move(v) for k, v in kwargs.items()}


CFGS = {
    "16x16": RasterConfig(tile_size=16, max_instances=1 << 14, max_rows=1 << 13),
    "32x16": RasterConfig(tile_w=32, tile_h=16, max_instances=1 << 14, max_rows=1 << 13),
    "overflow": RasterConfig(tile_size=16, max_instances=1024, max_rows=512),
    "64x32": RasterConfig(tile_w=64, tile_h=32, max_instances=1 << 14, max_rows=1 << 13),
    "64x64": RasterConfig(tile_w=64, tile_h=64, max_instances=1 << 14, max_rows=1 << 13),
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


ROW_EXPAND_CASES = (
    "empty_stretch", "tall_gaussian", "rows_over_budget", "budget_1",
    "budget_513", "budget_1025", "all_empty", "degenerate_conics",
    "clamped_conics", "tile_24x16",
)
RANK_EXPAND_CASES = (
    "long_run", "first_start_above_0", "all_past_budget", "single_run",
    "equal_starts_owner", "equal_starts",
)


@functools.cache
def _expand_cases(kind, scale):
    return getattr(expand_cases, f"{kind}_cases")(scale)


def _expand_pairs(names):
    return [(scale, name) for scale in ("small", "card") for name in names
            if scale == "card" or name != "clamped_conics"]


def test_expand_case_lists_are_complete():
    for kind, names in (("row_engine", ROW_EXPAND_CASES),
                        ("rank_prefix", RANK_EXPAND_CASES)):
        for scale in ("small", "card"):
            want = {n for s, n in _expand_pairs(names) if s == scale}
            assert set(_expand_cases(kind, scale)) == want


@pytest.mark.parametrize("scale,case", _expand_pairs(ROW_EXPAND_CASES))
def test_row_engine_expand_cases_match_plain(card, scale, case):
    """The load-balanced row engine bit for bit on the inputs that break
    load-balanced designs, at the sizes of the CPU tests and at sizes where
    blocks and the look-back between them matter."""
    c = _expand_cases("row_engine", scale)[case]
    kw = {k: c[k] for k in ("budget", "tiles_x", "tile_w", "tile_h", "bits_tile")}
    table, total = torch.from_numpy(c["table"]), torch.from_numpy(c["total_rows"])
    want = kernels.row_engine_plain(table, total, **kw)
    got = kernels.row_engine(table.to(card), total.to(card), **kw)
    for name, g, w in zip(("istart", "delta", "u", "total"), got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy(), name)


@pytest.mark.parametrize("scale,case", _expand_pairs(RANK_EXPAND_CASES))
def test_rank_prefix_expand_cases_match_plain(card, scale, case):
    c = _expand_cases("rank_prefix", scale)[case]
    kw = {k: c[k] for k in ("budget", "plus_iota", "init") if k in c}
    start, delta = torch.from_numpy(c["start"]), torch.from_numpy(c["delta"])
    want = kernels.rank_prefix_plain(start, delta, **kw)
    got = kernels.rank_prefix(start.to(card), delta.to(card), **kw)
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


def test_row_engine_and_rank_prefix_launch_once(card):
    """One row_engine call is one kernel launch and one memset; one
    rank_prefix call with dcum given is one kernel launch."""
    from gsjax_torch.tools.common import device_ops

    c = _expand_cases("row_engine", "card")["empty_stretch"]
    kw = {k: c[k] for k in ("budget", "tiles_x", "tile_w", "tile_h", "bits_tile")}
    table = torch.from_numpy(c["table"]).to(card)
    total = torch.from_numpy(c["total_rows"]).to(card)
    istart, delta, u, _ = kernels.row_engine(table, total, **kw)
    for fn, name in ((lambda: kernels.row_engine(table, total, **kw), "row_engine_"),
                     (lambda: kernels.rank_prefix(istart, delta, budget=1 << 20,
                                                  plus_iota=True, dcum=u),
                      "rank_prefix_kernel")):
        ops = device_ops(fn, name)
        assert ops["kernels"] == ops["named"] == 1 and ops["memsets"] <= 1, ops


@pytest.mark.parametrize("cfg", ["16x16", "32x16", "64x32", "64x64"])
def test_composite_forward_matches_plain(card, cfg, monkeypatch):
    calls = _record(monkeypatch, "composite_forward")
    _cpu_render(CFGS[cfg])
    args, kwargs = calls[-1]
    want_c, want_t = kernels.composite_forward_plain(*args, **kwargs)
    a, kw = _to(card, args, kwargs)
    got_c, got_t = kernels.composite_forward(*a, **kw)
    np.testing.assert_allclose(got_c.cpu().numpy(), want_c.numpy(), atol=2e-3)
    np.testing.assert_allclose(got_t.cpu().numpy(), want_t.numpy(), atol=2e-3)


@pytest.mark.parametrize("cfg", ["16x16", "32x16", "overflow", "64x32", "64x64"])
def test_composite_backward_and_segment_sum_match_plain(card, cfg, monkeypatch):
    backs = _record(monkeypatch, "composite_backward")
    sums = _record(monkeypatch, "segment_sum")
    _render_grads("cpu", CFGS[cfg])
    args, kwargs = backs[-1]
    want = kernels.composite_backward_plain(*args, **kwargs)
    a, kw = _to(card, args, kwargs)
    got = kernels.composite_backward(*a, **kw)
    # Scaled per gradient column at 5e-3: the plain walk forms T and the
    # suffix by log-space cumsums, the kernel by a sequential f32 walk.
    for j in range(16):
        _scaled_close(got[:, j], want[:, j], what=f"column {j}")
    # The kernel's reduction order is fixed: bitwise reproducible.
    assert torch.equal(got, kernels.composite_backward(*a, **kw))

    (vals, gm_start), _ = sums[-1]
    want = kernels.segment_sum_plain(vals, gm_start)
    got = kernels.segment_sum(vals.to(card), gm_start.to(card)).cpu()
    # rtol 1e-5 of each run's sum of magnitudes (sums of the same terms).
    scale = kernels.segment_sum_plain(vals.abs(), gm_start)
    assert bool(((got - want).abs() <= 1e-5 * scale).all())


@pytest.mark.parametrize("cfg", ["16x16", "32x16", "overflow", "64x32", "64x64",
                                 "32x32_dense"])
def test_composite_kernels_equal_nocull_twins(card, cfg, monkeypatch):
    """The culled composite kernels against their twins without the cull:
    the forward bit for bit, the backward's gradients bit for bit but the
    sign of a zero; and the twins against the plain versions. The dense
    case (12,000 Gaussians, 32x32 tiles, where the forward culls too)
    gives tiles of several staging batches, where pixels finish before
    the batch ends."""
    fwds = _record(monkeypatch, "composite_forward")
    backs = _record(monkeypatch, "composite_backward")
    if cfg.endswith("_dense"):
        dense = RasterConfig(tile_size=32, max_instances=1 << 16, max_rows=1 << 15)
        _render_grads("cpu", dense, n=12_000)
    else:
        _render_grads("cpu", CFGS[cfg])
    (f_args, f_kw), (b_args, b_kw) = fwds[-1], backs[-1]
    a, kw = _to(card, f_args, f_kw)
    twin = tool_kernels.composite_forward_nocull(*a, **kw)
    for got, want in zip(kernels.composite_forward(*a, **kw), twin):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    for got, want in zip(twin, kernels.composite_forward_plain(*f_args, **f_kw)):
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=2e-3)
    a, kw = _to(card, b_args, b_kw)
    got = kernels.composite_backward(*a, **kw)
    twin = tool_kernels.composite_backward_nocull(*a, **kw)
    assert torch.equal(got, twin) and bool((got != 0).any())
    want = kernels.composite_backward_plain(*b_args, **b_kw)
    for j in range(16):
        _scaled_close(twin[:, j], want[:, j], what=f"column {j}")


def test_render_on_card_matches_cpu(card):
    """Forward and backward on the card against the CPU's plain versions;
    each of the five composite and binning kernels launches once, the row
    gather four times (the fields' depth permute and its backward, the
    instance stream, the owner regroup)."""
    cfg = CFGS["16x16"]
    cpu, cpu_grads = _render_grads("cpu", cfg)
    kernels.reset_launch_counts()
    out, grads = _render_grads(card, cfg)
    torch.cuda.synchronize()
    assert kernels.launch_counts == {**dict.fromkeys(kernels.KERNEL_NAMES, 1),
                                     "row_gather": 4}
    assert int(out.num_instances) == int(cpu.num_instances)
    assert int(out.num_rows) == int(cpu.num_rows)
    np.testing.assert_allclose(
        out.image.detach().cpu().numpy(), cpu.image.detach().numpy(),
        atol=2e-3, rtol=1e-3,
    )
    for k in PARAM_NAMES:
        _scaled_close(grads[k], cpu_grads[k], what=k)


# --- the profiling tools' kernels ---------------------------------------------


@pytest.fixture(scope="module")
def tool_stream():
    """The composite's inputs for a 1500-Gaussian 160x120 view in 32x32
    tiles, built on the CPU."""
    params, aux = random_scene(1500, seed=3, spread=1.5, device="cpu")
    cam = look_at_origin_camera(W, H, device="cpu")
    cfg = RasterConfig(tile_size=32, max_instances=1 << 14, max_rows=1 << 13)
    return instance_stream(params, cam, cfg, aux.alive)


@pytest.mark.parametrize("name", tool_kernels.VARIANTS)
def test_variant_matches_plain(card, tool_stream, name):
    geo = tool_stream.geometry
    want = tool_kernels.variant_plain(tool_stream.inst, tool_stream.tile_start,
                                      name, **geo)
    got = tool_kernels.variant(tool_stream.inst.to(card),
                               tool_stream.tile_start.to(card), name, **geo).cpu()
    if name == "dma_only":
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6)
    elif name in ("bwd_nowrite", "bwd_noshfl"):
        cot = (tool_kernels.lane0_cot(geo["n_tiles"], 32, 32, "cpu") if name == "bwd_noshfl"
               else tool_kernels.bwd_nowrite_cot(geo["n_tiles"], 1024, "cpu"))
        grads = kernels.composite_backward_plain(
            tool_stream.inst, tool_stream.tile_start, cot, **geo)
        # Within 5e-3 of the stream's largest |d_mx|.
        scale = float(grads[:, 0].abs().max())
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=5e-3 * scale)
    else:  # 2e-3 per chunk walked (fwd_nodep sums its chunks)
        _, mask = tool_kernels._chunk_heads(tool_stream.tile_start, geo["n_tiles"])
        np.testing.assert_allclose(got.numpy(), want.numpy(),
                                   atol=2e-3 * int(mask.sum(1).max()))


@functools.lru_cache(maxsize=None)
def _probe_stream(case):
    """The composite's inputs for a 160x120 view of a CPU scene: 1500
    Gaussians, or 12,000 for the dense case (tiles of several staging
    batches)."""
    tile = case.removesuffix("_dense")
    tw, th = (int(v) for v in tile.split("x"))
    params, aux = random_scene(12_000 if case.endswith("_dense") else 1500, seed=3,
                               spread=1.5, device="cpu")
    cam = look_at_origin_camera(W, H, device="cpu")
    cfg = RasterConfig(tile_w=tw, tile_h=th, max_instances=1 << 16, max_rows=1 << 15)
    return instance_stream(params, cam, cfg, aux.alive)


@pytest.mark.parametrize("case", ["32x32", "16x16", "64x32", "32x32_dense"])
def test_probes_take_apart_the_main_kernels(card, case):
    """The probes launch as the kernels that ship: blockout equals
    composite_forward bit for bit, outpath "ship" holds its colour and T
    bit for bit in rows 0-3 and zeros in rows 4-7, outpath "notrans" is
    within rtol 1e-5 of its plain version (zero but [t, 0, 0]) and repeats
    bit for bit, replay_fwd and fwd_nocond give the forward's red at
    pixel 0 bit for bit, and bwd_nowrite the chunk-head sums of
    composite_backward's d_mx on the same cotangent within 1e-6 of each
    sum's magnitudes (the kernel sums them in another order)."""
    stream = _probe_stream(case)
    geo = stream.geometry
    inst, ts = stream.inst.to(card), stream.tile_start.to(card)
    color, trans = kernels.composite_forward(inst, ts, **geo)
    b_color, b_trans = tool_kernels.blockout(inst, ts, **geo)
    assert torch.equal(b_color.view(torch.int32), color.view(torch.int32))
    assert torch.equal(b_trans[..., 0].view(torch.int32), trans.view(torch.int32))
    ship = tool_kernels.outpath(inst, ts, "ship", **geo)
    assert torch.equal(ship[:, 0:3].transpose(1, 2).contiguous().view(torch.int32),
                       color.view(torch.int32))
    assert torch.equal(ship[:, 3].contiguous().view(torch.int32), trans.view(torch.int32))
    assert not bool(ship[:, 4:].any())
    notrans = [tool_kernels.outpath(inst, ts, "notrans", **geo) for _ in range(2)]
    assert torch.equal(notrans[0].view(torch.int32), notrans[1].view(torch.int32))
    want = tool_kernels.outpath_plain(stream.inst, stream.tile_start, "notrans", **geo)
    np.testing.assert_allclose(notrans[0].cpu().numpy(), want.numpy(), rtol=1e-5, atol=0)
    for name in ("replay_fwd", "fwd_nocond"):
        got = tool_kernels.variant(inst, ts, name, **geo).reshape(-1)
        assert torch.equal(got.view(torch.int32), color[:, 0, 0].view(torch.int32)), name
    cot = tool_kernels.bwd_nowrite_cot(geo["n_tiles"], geo["tile_w"] * geo["tile_h"], card)
    grads = kernels.composite_backward(inst, ts, cot, **geo)
    want = tool_kernels._chunk_head_sums(grads, ts, geo["n_tiles"])
    mag = tool_kernels._chunk_head_sums(grads.abs(), ts, geo["n_tiles"])
    got = tool_kernels.variant(inst, ts, "bwd_nowrite", **geo).reshape(-1)
    assert bool((mag > 0).any())
    assert bool(((got - want).abs() <= 1e-6 * mag).all())


@pytest.mark.parametrize("variant", tool_kernels.OUTPATH_VARIANTS)
def test_outpath_and_blockout_match_plain(card, tool_stream, variant):
    geo = tool_stream.geometry
    inst, ts = tool_stream.inst, tool_stream.tile_start
    want = tool_kernels.outpath_plain(inst, ts, variant, **geo)
    got = tool_kernels.outpath(inst.to(card), ts.to(card), variant, **geo).cpu()
    if variant == "ship":
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-3)
    else:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=0)
        again = tool_kernels.outpath(inst.to(card), ts.to(card), variant, **geo).cpu()
        assert torch.equal(again.view(torch.int32), got.view(torch.int32))
    for want_x, got_x in zip(tool_kernels.blockout_plain(inst, ts, **geo),
                             tool_kernels.blockout(inst.to(card), ts.to(card), **geo)):
        np.testing.assert_allclose(got_x.cpu().numpy(), want_x.numpy(), atol=2e-3)


def _budget_index(rng, n: int, p: int) -> np.ndarray:
    """A binning-shaped index into N + 1 rows: about 66 % of the P slots at
    the zero pad row N (a budget's dead slots), the rest a random
    permutation of rows."""
    idx = np.full(p, n, np.int64)
    live = rng.choice(p, size=p // 3, replace=False)
    idx[live] = rng.permutation(n)[:live.size]
    return idx


@pytest.mark.parametrize("width", kernels.GATHER_WIDTHS)
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("index", ["random", "budget"])
def test_row_gather_matches_plain(card, width, dtype, index):
    """The render path's row gather against index_select, bit for bit, at
    any P: random rows, or a budget's index (mostly the pad row)."""
    rng = np.random.default_rng(width)
    src = torch.from_numpy(rng.standard_normal((5001, width)).astype(np.float32))
    idx = (rng.integers(0, 5001, 12_345) if index == "random"
           else _budget_index(rng, 5000, 12_345))
    idx = torch.from_numpy(idx).to(dtype)
    want = kernels.row_gather_plain(src, idx)
    kernels.reset_launch_counts()
    got = kernels.row_gather(src.to(card), idx.to(card)).cpu()
    assert kernels.launch_counts["row_gather"] == 1
    assert torch.equal(got, want)


def test_row_gather_offsets_pass_2_to_the_31(card):
    """A (P, 16) gather whose P * 16 floats pass 2^31 (P = 2^27 + 5, 8 GiB
    out): its offsets are 64-bit, and every row equals index_select's."""
    p = (1 << 27) + 5
    gen = torch.Generator(device=card).manual_seed(0)
    src = torch.randn((4097, 16), generator=gen, device=card)
    idx = torch.randint(0, 4097, (p,), generator=gen, device=card, dtype=torch.int32)
    got = kernels.row_gather(src, idx)
    assert p * 16 > 2**31
    assert torch.equal(got, src.index_select(0, idx))
    assert torch.equal(got[-5:], src[idx[-5:].long()])
