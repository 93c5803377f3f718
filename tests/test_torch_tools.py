"""The port's profiling tools against the JAX package's, on the CPU.

The JAX tools' kernels (tools/probe_outpath.py, tools/ablate_kernels.py,
tools/probe_prims.py) run in Pallas interpret mode on gsjax's instance
stream of a 200-Gaussian scene at 64x64 in 32x32 tiles; the port's plain
versions (gsjax_torch/tools/kernels.py) run on the same rows, transposed
at the boundary (gsjax keeps (16, P), the port (P, 16)).

The tools are not imported: tools/probe_outpath.py builds a 500k scene at
import, and the other two repoint the JAX compile cache. A small `ast`
loader takes each file's imports and the named top-level defs only, and
runs them with `pl` bound to a shim whose pallas_call is interpret mode.

Tolerances: forward values within 2e-3 (the composite forward's); the
fwd_nodep sum within 2e-3 per chunk summed; the backward variant within
5e-3 of the stream's largest |d_mx| (the composite backward's); dma_only
within rtol 1e-6 (the same few rows summed); gathers exactly. The notrans
block sum adds 4 * 1024 forward values per tile: within rtol 1e-5 of it
(the two sides' per-pixel values agree to ~1e-7 here, and f32 sums of
4096 terms in two orders differ by ~1e-7 relative).

Then the bench step and the stage profiler on the CPU at 64x48.
"""

from __future__ import annotations

import ast
import functools
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from gsjax.config import RasterConfig as JaxRasterConfig
from gsjax.render.binning import bin_gaussians, num_tiles
from gsjax.render.common import build_inst_data
from gsjax.render.composite import pack_fields
from gsjax.render.pallas_kernels import composite_backward_pallas
from gsjax.render.preprocess import preprocess
from gsjax_torch import bench
from gsjax_torch.config import RasterConfig
from gsjax_torch.model import PARAM_NAMES
from gsjax_torch.profile_stages import Stages
from gsjax_torch.render.api import render
from gsjax_torch.tools import ablate_kernels, common
from gsjax_torch.tools import kernels as tk
from gsjax_torch.train.loss import l1_loss
from tests.scene_utils import look_at_origin_camera, random_scene
from tests.torch_parity import n, t, to_torch_camera, to_torch_params

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parents[1]
W = H = 64
TILE = 32
BUDGETS = dict(max_instances=4096, max_rows=4096)


class _InterpretPallas:
    """jax.experimental.pallas with pallas_call in interpret mode."""

    pallas_call = staticmethod(functools.partial(pl.pallas_call, interpret=True))

    def __getattr__(self, name):
        return getattr(pl, name)


def load_tool(name: str, defs: tuple[str, ...], **consts) -> dict:
    """The imports and the top-level defs `defs` of tools/<name>.py, run in
    a fresh namespace, `pl` rebound to interpret mode, `consts` added."""
    path = ROOT / "tools" / f"{name}.py"
    tree = ast.parse(path.read_text())
    body = [node for node in tree.body
            if isinstance(node, (ast.Import, ast.ImportFrom))
            or (isinstance(node, ast.FunctionDef) and node.name in defs)]
    missing = set(defs) - {node.name for node in body if isinstance(node, ast.FunctionDef)}
    assert not missing, f"{path}: no top-level {missing}"
    ns = {"__name__": f"tools_{name}"}
    exec(compile(ast.Module(body=body, type_ignores=[]), str(path), "exec"), ns)
    ns["pl"] = _InterpretPallas()
    ns.update(consts)
    return ns


@pytest.fixture(scope="module")
def stream():
    """gsjax's instance stream (16, P) and tile ranges, built as the JAX
    tools build them, and the JAX tools' namespaces."""
    params, aux = random_scene(200, seed=0)
    cam = look_at_origin_camera(W, H)
    cfg = JaxRasterConfig(tile_w=TILE, tile_h=TILE, interpret=True, **BUDGETS)
    proj = preprocess(
        xyz=params.xyz, sh=params.get_features(), opacity=params.get_opacity(),
        scaling=params.get_scaling(), rotation=params.rotation, camera=cam,
        active_sh_degree=3, alive=aux.alive,
    )
    binning = bin_gaussians(proj.mean_pix, proj.depth, proj.ext, proj.conic,
                            proj.qmax, H, W, cfg)
    inst = build_inst_data(
        jnp.take(pack_fields(proj.mean_pix, proj.conic, proj.rgb, proj.opacity),
                 binning.perm, axis=0),
        binning.sorted_owner,
    )
    tiles_x, tiles_y = num_tiles(H, W, TILE, TILE)
    geo = dict(n_tiles=tiles_x * tiles_y, tiles_x=tiles_x)
    tile_start = np.asarray(binning.tile_start)
    consts = dict(TILE_W=TILE, TILE_H=TILE)
    return dict(
        jparams=params, jaux=aux, jcam=cam, inst=inst, tile_start=tile_start,
        rows=t(np.asarray(inst).T.copy()), ts=t(tile_start), geo=geo,
        port_geo=dict(geo, tile_w=TILE, tile_h=TILE),
        ablate=load_tool("ablate_kernels", ("run_variant", "_variant_kernel",
                                           "run_blockout", "_blockout_kernel"),
                         **consts),
        outpath=load_tool("probe_outpath", ("run", "_fwd_kernel_var"), **consts),
        prims=load_tool("probe_prims", ("_gather_kernel",)),
    )


def test_instance_stream_matches_gsjax(stream):
    """The port's pipeline up to the composite's inputs (tools/common.py)
    on gsjax's scene: tile ranges exactly, rows within 1e-5 of their
    magnitude (f32 preprocess in two frameworks)."""
    got = common.instance_stream(
        to_torch_params(stream["jparams"]), to_torch_camera(stream["jcam"]),
        RasterConfig(tile_w=TILE, tile_h=TILE, **BUDGETS),
        t(stream["jaux"].alive),
    )
    np.testing.assert_array_equal(n(got.tile_start), stream["tile_start"])
    assert got.geometry == stream["port_geo"]
    want = n(stream["rows"])
    np.testing.assert_allclose(n(got.inst), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", [*tk.TOOL_VARIANTS, "other"])
def test_variant_matches_ablate_kernels(stream, name):
    want = np.asarray(stream["ablate"]["run_variant"](
        stream["inst"], jnp.asarray(stream["tile_start"]), variant=name,
        **stream["geo"])[0])
    got = n(tk.variant(stream["rows"], stream["ts"], name, **stream["port_geo"]))
    assert got.shape == want.shape == (stream["geo"]["n_tiles"], 1, 1)
    if name == "dma_only":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
        assert np.all(got != 0)
    elif name == "fwd_nodep":
        heads, mask = tk._chunk_heads(stream["ts"], stream["geo"]["n_tiles"])
        np.testing.assert_allclose(got, want, atol=2e-3 * int(mask.sum(1).max()))
    elif name in ("fwd_nocond", "replay_fwd"):
        np.testing.assert_allclose(got, want, atol=2e-3)
    else:
        cot = tk.bwd_nowrite_cot(stream["geo"]["n_tiles"], TILE * TILE, "cpu")
        grads = tk.tiled.composite_backward_tiles(
            stream["rows"], stream["ts"], cot, **stream["port_geo"])
        scale = float(grads[:, 0].abs().max())
        np.testing.assert_allclose(got / scale, want / scale, atol=5e-3)
    # Each case is one the scene makes non-trivial (dma_only and the
    # forward variants: a tile whose pixel 0 or first rows are covered).
    assert np.abs(want).max() > 0


def test_bwd_noshfl_matches_pallas_backward_at_lane0(stream):
    """bwd_noshfl, the port's own ablation (the JAX tool has none): the
    backward of the pixels at lane 0 of each warp. gsjax's
    composite_backward_pallas (interpret mode) on the tool's cotangent
    zeroed but at those pixels, summed as bwd_nowrite sums, within 5e-3
    of its largest |d_mx|."""
    geo, n_tiles = stream["port_geo"], stream["geo"]["n_tiles"]
    cot = tk.lane0_cot(n_tiles, TILE, TILE, "cpu")  # (T, PIX, 4)
    assert int((cot[..., 3] != 0).sum()) == n_tiles * TILE * TILE // 32
    want = np.asarray(composite_backward_pallas(
        stream["inst"], jnp.asarray(stream["tile_start"]),
        jnp.asarray(np.concatenate([n(cot).swapaxes(1, 2),
                                    np.zeros((n_tiles, 4, TILE * TILE), np.float32)],
                                   axis=1)),
        chunk=128, interpret=True, **geo,
    )).T  # (P, 16)
    want_sums = n(tk._chunk_head_sums(t(want.copy()), stream["ts"], n_tiles))
    got = n(tk.variant(stream["rows"], stream["ts"], "bwd_noshfl", **geo))[:, 0, 0]
    scale = float(np.abs(want[:, 0]).max())
    assert scale > 0 and np.abs(want_sums).max() > 0
    np.testing.assert_allclose(got / scale, want_sums / scale, atol=5e-3)


@pytest.mark.parametrize("semantics", tk.SEMANTICS)
def test_blockout_matches_ablate_kernels(stream, semantics):
    want_c, want_t = stream["ablate"]["run_blockout"](
        stream["inst"], jnp.asarray(stream["tile_start"]), semantics=semantics,
        **stream["geo"])
    got_c, got_t = tk.blockout(stream["rows"], stream["ts"], semantics,
                               **stream["port_geo"])
    np.testing.assert_allclose(n(got_c), np.asarray(want_c), atol=2e-3)
    np.testing.assert_allclose(n(got_t), np.asarray(want_t), atol=2e-3)


@pytest.mark.parametrize("variant", tk.OUTPATH_VARIANTS)
def test_outpath_matches_probe_outpath(stream, variant):
    want = np.asarray(stream["outpath"]["run"](
        stream["inst"], jnp.asarray(stream["tile_start"]), variant=variant,
        **stream["geo"]))
    got = n(tk.outpath(stream["rows"], stream["ts"], variant, **stream["port_geo"]))
    assert got.shape == want.shape == (stream["geo"]["n_tiles"], 8, TILE * TILE)
    if variant == "ship":
        # Rows 4-7 are stale VMEM on the TPU; the port writes zeros there.
        np.testing.assert_allclose(got[:, 0:4], want[:, 0:4], atol=2e-3)
        assert np.all(got[:, 4:] == 0)
    else:
        np.testing.assert_allclose(got[:, 0, 0], want[:, 0, 0], rtol=1e-5)
        got[:, 0, 0] = 0
        assert np.all(got == 0)


@pytest.mark.parametrize("width", tk.GATHER_WIDTHS)
def test_row_gather_matches_probe_prims(stream, width):
    """The JAX probe's _gather_kernel at P = 1024, block 512, in a
    pallas_call whose out_specs is one BlockSpec (the probe's own wrapper
    passes a list, which the installed JAX refuses); the port's gather
    equals it and src[idx] exactly."""
    rng = np.random.default_rng(width)
    src = rng.standard_normal((700, width)).astype(np.float32)
    idx = rng.integers(0, 700, 1024).astype(np.int32)
    block = 512
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(idx.shape[0] // block,),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec(memory_space=pl.ANY),
        scratch_shapes=[pltpu.VMEM((2, block, width), jnp.float32),
                        pltpu.SemaphoreType.DMA((2, 16))],
    )
    want = np.asarray(stream["prims"]["pl"].pallas_call(
        functools.partial(stream["prims"]["_gather_kernel"], block=block,
                          width=width),
        grid_spec=grid_spec,
        out_shape=jax.ShapeDtypeStruct((idx.shape[0], width), jnp.float32),
    )(jnp.asarray(idx), jnp.asarray(src)))
    np.testing.assert_array_equal(want, src[idx])
    for ix in (t(idx), t(idx).long()):
        np.testing.assert_array_equal(n(tk.row_gather(t(src), ix)), want)


# --- bench and the stage profiler on the CPU ----------------------------------------


@pytest.fixture(scope="module")
def small_bench():
    return common.bench_scene("cpu", n=200, width=64, height=48,
                              budgets=BUDGETS)


def test_bench_step_on_cpu(small_bench):
    params, aux, camera, cfg = small_bench
    before = {k: getattr(params, k).detach().clone() for k in PARAM_NAMES}
    step = bench.BenchStep(params, aux, camera, cfg)
    loss = step()
    with torch.no_grad():
        image = render(params, camera, active_sh_degree=3, bg_color=torch.zeros(3),
                       cfg=cfg, alive=aux.alive).image
    assert float(loss) == float(l1_loss(image, torch.zeros_like(image))) > 0
    assert len(step.grads) == len(PARAM_NAMES) + 1
    assert all(bool(torch.isfinite(g).all()) for g in step.grads)
    assert any(bool((g != 0).any()) for g in step.grads)
    for k in PARAM_NAMES:  # p - 0 * g
        assert torch.equal(getattr(params, k).detach(), before[k]), k


def test_bench_main_without_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exit_info:
        bench.main()
    assert exit_info.value.code == 1
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "pixels_per_s_fwd_bwd_1080p"
    assert line["value"] == 0.0 and "error" in line
    with pytest.raises(SystemExit):  # the tools measure the card only
        ablate_kernels.main([])


def test_stage_chain_gives_render_image(small_bench):
    params, aux, camera, cfg = small_bench
    stages = Stages(params, aux, camera, cfg)
    proj = stages.preprocess()
    fields, binning = stages.binning(proj)
    inst = stages.build_inst(fields, binning)
    tile_color, tile_t = stages.composite_fwd(inst, binning.tile_start)
    with torch.no_grad():
        want = render(params, camera, active_sh_degree=3, bg_color=torch.zeros(3),
                      cfg=cfg, alive=aux.alive).image
    assert torch.equal(stages.image(tile_color, tile_t), want)
    cot = stages.cotangent(tile_color, tile_t)
    sums = stages.grad_reduction(stages.composite_bwd(inst, binning.tile_start, cot),
                                 binning)
    assert sums.shape == (params.capacity, 9) and bool(torch.isfinite(sums).all())


def test_profile_binning_stages_rebuild_bin_gaussians():
    """gsjax_torch.tools.profile_binning on the CPU at a small scene: every
    stage runs and the stages rebuild bin_gaussians' stream (its own
    check); nothing is timed off the card."""
    from gsjax_torch.tools import profile_binning

    rows = profile_binning.run(device="cpu", n=2000, width=128, height=96,
                               budgets=dict(max_instances=8192, max_rows=4096))
    stages = [r["stage"] for r in rows if "stage" in r]
    assert stages[:11] == [s for s in stages if s[0].isdigit()]
    assert {"row_engine", profile_binning.OWNER_EXPANSION, "bin_gaussians (whole)"} <= set(stages)
    assert all(r["device_ms"] == "not measured" for r in rows if "stage" in r)
    assert 0 < rows[-1]["num_instances"] <= 8192
