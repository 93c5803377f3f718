"""gsjax_torch binning against gsjax binning, integer for integer.

Both packages bin the same depth-ordered inputs: gsjax's own preprocess
outputs, as numpy (so no last-ulp difference upstream can move a
float-to-integer step). On the CPU the port runs the plain versions of its
row-engine and rank-prefix kernels; those are also held bit for bit to the
Pallas kernels in interpret mode, on the very arguments gsjax's binning
passes them.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsjax.render.binning as jbin
import gsjax.render.pallas_kernels as jpk
import gsjax_torch.render.binning as tbin
from gsjax.config import RasterConfig as JaxRasterConfig
from gsjax.render.composite import pack_fields
from gsjax.render.preprocess import preprocess as jax_preprocess
from gsjax_torch.config import RasterConfig
from gsjax_torch.render import kernels
from tests.scene_utils import look_at_origin_camera, random_scene
from tests.torch_parity import n, t

torch.set_num_threads(1)
W, H = 64, 48
OUT = ("perm", "sorted_owner", "sorted_slot", "tile_start", "gm_start",
       "num_instances", "num_rows")
CASES = {
    # name: (RasterConfig kwargs, packed_paths, overflow)
    "16x16": (dict(tile_size=16, max_instances=4096, max_rows=2048), None, None),
    "32x16": (dict(tile_w=32, tile_h=16, max_instances=4096, max_rows=2048), None, None),
    "instance_overflow": (dict(tile_size=16, max_instances=256, max_rows=2048), None, "instances"),
    "row_overflow": (dict(tile_size=16, max_instances=4096, max_rows=128), None, "rows"),
    "gather_path": (dict(tile_size=16, max_instances=4096, max_rows=2048), False, None),
}


def _ordered_inputs(params, aux, cam):
    """gsjax's depth-ordered binning inputs for a scene and camera (numpy)."""
    proj = jax_preprocess(
        xyz=params.xyz, sh=params.get_features(), opacity=params.get_opacity(),
        scaling=params.get_scaling(), rotation=params.rotation, camera=cam,
        active_sh_degree=3, alive=aux.alive,
    )
    perm = jbin.depth_order(proj.depth)
    f12 = jnp.take(
        jnp.concatenate(
            [pack_fields(proj.mean_pix, proj.conic, proj.rgb, proj.opacity),
             proj.ext, proj.qmax[:, None]], axis=-1,
        ),
        perm, axis=0,
    )
    return {
        "mean_pix": np.asarray(f12[:, 0:2]), "depth": np.asarray(proj.depth),
        "ext": np.asarray(f12[:, 9:11]), "conic": np.asarray(f12[:, 2:5]),
        "qmax": np.asarray(f12[:, 11]), "perm": np.asarray(perm),
        # The same inputs before the depth permute (the perm=None form).
        "raw": {k: np.asarray(v) for k, v in (
            ("mean_pix", proj.mean_pix), ("ext", proj.ext),
            ("conic", proj.conic), ("qmax", proj.qmax))},
    }


@pytest.fixture(scope="module")
def ordered():
    """gsjax's depth-ordered binning inputs for the tests scene (numpy)."""
    params, aux = random_scene(200, seed=0, spread=1.3)
    return _ordered_inputs(params, aux, look_at_origin_camera(W, H))


def _record(monkeypatch, module, name):
    """Record (args, kwargs, result) of every call of module.<name>."""
    calls = []
    real = getattr(module, name)

    def recorder(*args, **kwargs):
        out = real(*args, **kwargs)
        calls.append((args, kwargs, out))
        return out

    monkeypatch.setattr(module, name, recorder)
    return calls


def _bin_both(ordered, cfg_kw, packed_paths, with_perm=True, height=H, width=W):
    names = ("mean_pix", "depth", "ext", "conic", "qmax")
    if with_perm:
        arrs = [ordered[k] for k in names]
        perm = ordered["perm"]
    else:
        raw = ordered["raw"]
        arrs = [raw.get(k, ordered["depth"]) for k in names]
        perm = None
    a = jbin.bin_gaussians(
        *map(jnp.asarray, arrs), height, width,
        JaxRasterConfig(interpret=True, **cfg_kw),
        packed_paths=packed_paths,
        perm=None if perm is None else jnp.asarray(perm),
    )
    b = tbin.bin_gaussians(
        *map(t, arrs), height, width, RasterConfig(**cfg_kw),
        packed_paths=packed_paths,
        perm=None if perm is None else t(perm),
    )
    return a, b


@pytest.mark.parametrize("case", list(CASES))
def test_bin_gaussians_matches_gsjax_exactly(ordered, case, monkeypatch):
    cfg_kw, packed_paths, overflow = CASES[case]
    engine = _record(monkeypatch, jpk, "row_engine_pallas")
    ranks = _record(monkeypatch, jbin, "rank_prefix_pallas")
    a, b = _bin_both(ordered, cfg_kw, packed_paths)
    for name in OUT:
        got, want = n(getattr(b, name)), np.asarray(getattr(a, name))
        assert got.dtype == np.int32, name
        np.testing.assert_array_equal(got, want, name)
    assert int(b.num_instances) > 0
    if overflow == "instances":
        assert int(b.num_instances) > cfg_kw["max_instances"]
    if overflow == "rows":
        assert int(b.num_rows) > cfg_kw["max_rows"]

    # The plain kernel versions, bit for bit against the Pallas kernels on
    # the arguments gsjax's binning gave them.
    assert bool(engine) == (packed_paths is None)
    for args, kwargs, out in engine:
        table, _, total_rows = args
        kw = {k: kwargs[k] for k in ("budget", "tiles_x", "tile_w", "tile_h", "bits_tile")}
        got = kernels.row_engine_plain(t(table), t(total_rows), **kw)
        for g, w in zip(got, out):
            np.testing.assert_array_equal(n(g), np.asarray(w).view(np.int32))
    for args, kwargs, out in ranks:
        dcum = kwargs.get("dcum")
        got = kernels.rank_prefix_plain(
            t(args[0]), t(np.asarray(args[1]).view(np.int32)),
            budget=kwargs["budget"], plus_iota=kwargs.get("plus_iota", False),
            init=kwargs.get("init", 0), dcum=None if dcum is None else t(dcum),
        )
        np.testing.assert_array_equal(n(got).view(np.uint32), np.asarray(out))


def test_bin_gaussians_own_depth_sort_matches_gsjax(ordered):
    a, b = _bin_both(ordered, CASES["16x16"][0], None, with_perm=False)
    for name in OUT:
        np.testing.assert_array_equal(n(getattr(b, name)), np.asarray(getattr(a, name)), name)


# Owner and tile bits past one 32-bit word: 4097 Gaussians -> 13 bits, an
# 8192x8192 view in 8x8 tiles -> 2^20 tiles, 20 bits (at 1920x1080 with
# 16x16 tiles any scene above 2^19 Gaussians is as wide).
BIG = 8192
WIDE_CFG = dict(tile_size=8, max_instances=1 << 17, max_rows=1 << 15)
WIDE_CASES = {
    # name: (RasterConfig kwargs, with_perm, held against, overflow)
    "instance_overflow": (dict(WIDE_CFG, max_instances=1 << 15), True, "gsjax", "instances"),
    "row_overflow": (dict(WIDE_CFG, max_rows=1 << 13), True, "gsjax", "rows"),
    "own_depth_sort": (WIDE_CFG, False, "gsjax", None),
    "gather_path": (WIDE_CFG, True, "gather_path", None),
}


@pytest.fixture(scope="module")
def wide():
    """gsjax's depth-ordered binning inputs at the wide widths (numpy)."""
    params, aux = random_scene(4097, seed=4, scale_range=(0.001, 0.003))
    return _ordered_inputs(params, aux, look_at_origin_camera(BIG, BIG))


def _wide_route(monkeypatch):
    """Record the port's row_engine and rank_prefix calls."""
    return _record(monkeypatch, kernels, "row_engine"), _record(monkeypatch, kernels, "rank_prefix")


def _assert_wide_route(engine, ranks, cfg_kw):
    """One row engine, then the tile expansion and the owner expansion,
    both over the instance budget."""
    assert len(engine) == 1
    assert [(kw["budget"], kw.get("plus_iota", False), kw.get("init", 0))
            for _, kw, _ in ranks] == [(cfg_kw["max_instances"], True, 0),
                                       (cfg_kw["max_instances"], False, -1)]


def test_bin_gaussians_rank_form_matches_gsjax(wide, monkeypatch):
    """The wide route, taken when owner and tile bits do not fit one
    32-bit word: the row engine with a tile-only word, a rank expansion of
    the tiles and one of the owners over the instance budget; integers
    equal to gsjax's, with the plain rank_prefix bit for bit against the
    Pallas kernel's owner expansion."""
    engine, port_ranks = _wide_route(monkeypatch)
    ranks = _record(monkeypatch, jbin, "rank_prefix_pallas")
    a, b = _bin_both(wide, WIDE_CFG, None, height=BIG, width=BIG)
    _assert_wide_route(engine, port_ranks, WIDE_CFG)
    assert [kw.get("init") for _, kw, _ in ranks] == [-1]
    for name in OUT:
        np.testing.assert_array_equal(n(getattr(b, name)), np.asarray(getattr(a, name)), name)
    assert 0 < int(b.num_instances) <= WIDE_CFG["max_instances"]
    (start, ones), kw, want = ranks[0]
    got = kernels.rank_prefix_plain(
        t(start), t(np.asarray(ones).view(np.int32)), budget=kw["budget"], init=-1,
    )
    np.testing.assert_array_equal(n(got).view(np.uint32), np.asarray(want))


@pytest.mark.parametrize("case", list(WIDE_CASES))
def test_bin_gaussians_wide_route_exact(wide, case, monkeypatch):
    """The wide route under instance and row overflow, with its own depth
    sort, and against the port's own gather path, integer for integer."""
    cfg_kw, with_perm, against, overflow = WIDE_CASES[case]
    engine, ranks = _wide_route(monkeypatch)
    if against == "gsjax":
        a, b = _bin_both(wide, cfg_kw, None, with_perm=with_perm, height=BIG, width=BIG)
        want = {name: np.asarray(getattr(a, name)) for name in OUT}
    else:
        args = [t(wide[k]) for k in ("mean_pix", "depth", "ext", "conic", "qmax")]
        b, g = (tbin.bin_gaussians(*args, BIG, BIG, RasterConfig(**cfg_kw),
                                   packed_paths=pp, perm=t(wide["perm"]))
                for pp in (None, False))
        want = {name: n(getattr(g, name)) for name in OUT}
    _assert_wide_route(engine, ranks, cfg_kw)
    for name in OUT:
        np.testing.assert_array_equal(n(getattr(b, name)), want[name], name)
    assert int(b.num_instances) > 0
    if overflow == "instances":
        assert int(b.num_instances) > cfg_kw["max_instances"]
    if overflow == "rows":
        assert int(b.num_rows) > cfg_kw["max_rows"]
    else:
        assert int(b.num_rows) <= cfg_kw["max_rows"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rank_prefix_plain_matches_pallas(seed):
    """Full-range uint32 deltas (wraparound), zero-length runs, runs past
    the budget, a budget that is not a block multiple; plus_iota and the
    init=-1 owner form."""
    rng = np.random.default_rng(seed)
    r = int(rng.integers(3, 700))
    budget = 3000
    counts = rng.integers(0, 9, r)
    counts[rng.integers(0, r, r // 3)] = 0
    start = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    delta = rng.integers(0, 2**32, r, dtype=np.uint64).astype(np.uint32)
    for kw, d in ((dict(plus_iota=True), delta),
                  (dict(init=-1), np.ones(r, np.uint32))):
        want = np.asarray(jpk.rank_prefix_pallas(
            jnp.asarray(start), jnp.asarray(d), budget=budget, interpret=True, **kw,
        ))
        got = kernels.rank_prefix_plain(
            t(start), t(d.view(np.int32)), budget=budget, **kw,
        )
        np.testing.assert_array_equal(n(got).view(np.uint32), want)


def test_rank_owner_expansion_equals_mark_scatter():
    """The rank expansion of run starts (the wide route's owner expansion)
    is the gather path's boundary-mark expansion, bit for bit."""
    rng = np.random.default_rng(7)
    counts = rng.integers(0, 4, 500)
    rstart = t(np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32))
    owner, _ = tbin._expand(rstart, 1024)
    ranked = kernels.rank_prefix(rstart, torch.ones_like(rstart), budget=1024, init=-1)
    np.testing.assert_array_equal(n(ranked), n(owner))
