"""The port's remaining tools (gsjax_torch/tools: probe_tilesize,
probe_saturation, probe_gradreduce, ckpt_to_ply, diagnose_quality,
quality_run's artifact, export_lpips_weights, scaling_projection,
bench_scaling, sky_run) against the JAX package's tools on the CPU.

Scene: tests/scene_utils' 200 Gaussians (capacity 256, SH degree 3) seen
from the origin at 64x48, handed to both packages as numpy arrays; gsjax's
side is computed once, in a module fixture (its Pallas kernels in
interpret mode). Tolerances: pair counts, per-tile terminated fractions,
slab counts and PLY bytes exactly; the transmittance map within 2e-3 (the
composite forward's); the grad-reduction pieces within 1e-5 of each other
and of owner_sums (f32 sums in two orders); the projection's numbers as
gsjax rounds them; diagnose_quality's text line for line.
"""

from __future__ import annotations

import json
import os
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from gsjax.config import RasterConfig as JRasterConfig
from gsjax.parallel.render import slab_rows as jslab_rows
from gsjax.render.binning import bin_gaussians as jbin_gaussians
from gsjax.render.binning import num_tiles as jnum_tiles
from gsjax.render.common import untile_image as juntile_image
from gsjax.render.composite import CompositeStatic as JCompositeStatic
from gsjax.render.composite import composite as jcomposite
from gsjax.render.composite import pack_fields as jpack_fields
from gsjax.render.preprocess import preprocess as jpreprocess
from gsjax_torch.config import RasterConfig
from gsjax_torch.render.api import depth_sorted_bins
from gsjax_torch.render.composite import owner_sums
from gsjax_torch.render.preprocess import preprocess
from gsjax_torch.tools import (
    bench_scaling,
    ckpt_to_ply,
    diagnose_quality,
    export_lpips_weights,
    probe_gradreduce,
    probe_saturation,
    probe_tilesize,
    quality_run,
    scaling_projection,
    sky_run,
)
from tests.scene_utils import look_at_origin_camera, random_scene
from tests.torch_parity import n, t, to_torch_camera, to_torch_params
from tools import ckpt_to_ply as jckpt_to_ply
from tools import diagnose_quality as jdiagnose_quality
from tools import export_lpips_weights as jexport_lpips_weights
from tools import probe_tilesize as jprobe_tilesize
from tools import scaling_projection as jscaling_projection

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parents[1]
W, H = 64, 48
SH = 3
BUDGETS = dict(max_instances=4096, max_rows=4096)
# Slab counts before any clamp, as both projections take them.
COUNT_BUDGETS = dict(max_instances=128, max_rows=1 << 12)
SLAB_TILE = 16
V3 = ROOT / "artifacts" / "quality_run_v3.json"


def jax_projection(params, aux, cam):
    return jpreprocess(
        xyz=params.xyz, sh=params.get_features(), opacity=params.get_opacity(),
        scaling=params.get_scaling(), rotation=params.rotation, camera=cam,
        active_sh_degree=SH, alive=aux.alive)


def port_projection(params, aux, cam):
    with torch.no_grad():
        return preprocess(
            xyz=params.xyz, sh=params.get_features(), opacity=params.get_opacity(),
            scaling=params.get_scaling(), rotation=params.rotation, camera=cam,
            active_sh_degree=SH, alive=aux.alive)


def jax_t_map(proj, cfg):
    """tools/probe_saturation.py's t_map, on a projection."""
    binning = jbin_gaussians(proj.mean_pix, proj.depth, proj.ext, proj.conic, proj.qmax,
                             H, W, cfg)
    tiles_x, tiles_y = jnum_tiles(H, W, cfg.tw, cfg.th)
    static = JCompositeStatic(n_tiles=tiles_x * tiles_y, tiles_x=tiles_x, tile_w=cfg.tw,
                              tile_h=cfg.th, chunk=cfg.chunk, strips=cfg.strips,
                              interpret=cfg.interpret)
    fields = jpack_fields(proj.mean_pix, proj.conic, proj.rgb, proj.opacity)
    tile_color, tile_t = jcomposite(jnp.take(fields, binning.perm, axis=0), binning, static)
    _, transmittance = juntile_image(tile_color, tile_t, H, W, tiles_x, tiles_y,
                                     cfg.tw, cfg.th)
    return np.asarray(transmittance)


def jax_slab_counts(proj, splits):
    """tools/scaling_projection.py's slab_pair_counts, on a projection."""
    cfg = JRasterConfig(tile_w=SLAB_TILE, tile_h=SLAB_TILE, interpret=True, **COUNT_BUDGETS)
    tiles_x, _ = jnum_tiles(H, W, cfg.tw, cfg.th)
    out = {}
    for n_tile in splits:
        rows = jslab_rows(H, n_tile, cfg.th)
        counts = []
        for d in range(n_tile):
            py0 = jnp.float32(d * rows * cfg.th)
            local = proj.mean_pix - jnp.stack([jnp.zeros(()), py0])[None, :]
            b = jbin_gaussians(local, proj.depth, proj.ext, proj.conic, proj.qmax,
                               rows * cfg.th, tiles_x * cfg.tw, cfg, packed_paths=False)
            counts.append(int(b.num_instances))
        out[n_tile] = counts
    return out


@pytest.fixture(scope="module")
def scene():
    """Both packages' scene, projection and the gsjax tools' outputs."""
    jparams, jaux = random_scene(200, capacity=256, sh_degree=SH, seed=0)
    jcam = look_at_origin_camera(W, H)
    jproj = jax_projection(jparams, jaux, jcam)
    params, cam = to_torch_params(jparams), to_torch_camera(jcam)
    aux = type("Aux", (), {"alive": t(jaux.alive)})()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jprobe_tilesize, "WIDTH", W)
        mp.setattr(jprobe_tilesize, "HEIGHT", H)
        jpairs = {shape: jprobe_tilesize.count_pairs(jproj, *shape)
                  for shape in probe_tilesize.TILE_SHAPES}
    return dict(
        jparams=jparams, jaux=jaux, params=params, aux=aux, cam=cam,
        proj=port_projection(params, aux, cam), jpairs=jpairs,
        jt=jax_t_map(jproj, JRasterConfig(interpret=True, **BUDGETS)),
        jslabs=jax_slab_counts(jproj, scaling_projection.TILE_SPLITS),
    )


# --- probe_tilesize, probe_saturation, probe_gradreduce ----------------------------


@pytest.mark.parametrize("shape", probe_tilesize.TILE_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_count_pairs_matches_gsjax(scene, shape):
    got = probe_tilesize.count_pairs(scene["proj"], *shape, W, H)
    assert got == scene["jpairs"][shape]
    assert got[0] > 0


def test_probe_tilesize_rows(scene):
    rows = probe_tilesize.run(scene["proj"], W, H)
    assert [r["tile"] for r in rows] == ["16x16", "32x16", "32x32", "64x16"]
    for r, shape in zip(rows, probe_tilesize.TILE_SHAPES):
        assert (r["pairs"], r["rows"], r["tiles"]) == scene["jpairs"][shape]
        assert r["est_walks"] == r["pairs"] / 128 + r["tiles"]


def test_transmittance_map_matches_gsjax(scene):
    got = n(probe_saturation.t_map(scene["params"], scene["aux"], scene["cam"],
                                   RasterConfig(**BUDGETS), SH))
    assert got.shape == (H, W)
    np.testing.assert_allclose(got, scene["jt"], atol=2e-3, rtol=0)
    assert got.min() < 0.5  # the scene covers part of the view


def test_tile_done_fractions_match_gsjax(scene):
    """tools/probe_saturation.py's per-tile fractions, on gsjax's map and
    on the port's, exactly."""
    jt = scene["jt"]
    tsw = tsh = 16
    th, tw = H // tsh, W // tsw
    tt = jt[: th * tsh, : tw * tsw].reshape(th, tsh, tw, tsw).transpose(0, 2, 1, 3)
    want = (tt < 1e-4).reshape(th * tw, -1).mean(axis=1)
    np.testing.assert_array_equal(probe_saturation.tile_done_fractions(jt, tsw, tsh), want)
    got = n(probe_saturation.t_map(scene["params"], scene["aux"], scene["cam"],
                                   RasterConfig(**BUDGETS), SH))
    np.testing.assert_array_equal(probe_saturation.tile_done_fractions(got, tsw, tsh), want)
    s = probe_saturation.summarize(jt, tsw, tsh)
    assert s["frac_pixels_terminated"] == float((jt < 1e-4).mean())
    assert s["frac_tiles_fully_terminated"] == float((want == 1.0).mean())


def test_gradreduce_pieces_agree(scene):
    """Each piece on the port's plain path: the two regroups equal, the
    segment_sum kernel's plain version and segment_reduce within 1e-5, and
    owner_sums their first nine columns."""
    with torch.no_grad():
        _, binning = depth_sorted_bins(scene["proj"], scene["cam"],
                                       RasterConfig(tile_size=16, **BUDGETS))
    gen = torch.Generator().manual_seed(0)
    grads = torch.randn((binning.sorted_slot.shape[0], 16), generator=gen)
    out = {k: fn() for k, fn in probe_gradreduce.pieces(
        grads, binning.sorted_slot, binning.gm_start).items()}
    inverse = out["a. inverse permutation (scatter)"]
    assert torch.equal(inverse[binning.sorted_slot.long()],
                       torch.arange(inverse.shape[0]))
    assert torch.equal(out["c. regroup (P,16) index_select"],
                       out["c. regroup (P,16) row_gather kernel"])
    sums = out["g. segment_sum kernel"]
    torch.testing.assert_close(out["g. segment_reduce (library)"], sums, rtol=0, atol=1e-5)
    torch.testing.assert_close(out["h. owner_sums end to end"], sums[:, :9], rtol=0,
                               atol=1e-5)
    torch.testing.assert_close(owner_sums(grads, binning.sorted_slot, binning.gm_start),
                               sums[:, :9], rtol=0, atol=1e-5)
    assert float(sums.abs().sum()) > 0


# --- ckpt_to_ply, diagnose_quality, quality_run's artifact -------------------------


def test_ckpt_to_ply_bytes_match_gsjax(scene, tmp_path, monkeypatch):
    """A gsjax-written npz checkpoint to PLY through both tools: the same
    bytes."""
    from gsjax.train.checkpoint import save_checkpoint
    from gsjax.train.optimizer import adam_init
    from gsjax.train.step import TrainState

    state = TrainState(params=scene["jparams"], opt=adam_init(scene["jparams"]),
                       aux=scene["jaux"], step=jnp.int32(7))
    ckpt = str(tmp_path / "chkpnt7.npz")
    save_checkpoint(ckpt, state, SH, 1.0)
    monkeypatch.setattr(sys, "argv", ["ckpt_to_ply", ckpt, str(tmp_path / "jax")])
    jckpt_to_ply.main()
    got = ckpt_to_ply.main([ckpt, str(tmp_path / "torch"), "--device", "cpu"])
    rel = os.path.join("point_cloud", "iteration_7", "point_cloud.ply")
    assert got == str(tmp_path / "torch" / rel)
    assert (tmp_path / "torch" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes()


def diagnosis(main, path, capsys) -> list[str]:
    main(str(path))
    return capsys.readouterr().out.splitlines()


def test_diagnose_quality_v3_text_matches_gsjax(capsys):
    want = diagnosis(jdiagnose_quality.main, V3, capsys)
    got = diagnosis(diagnose_quality.main, V3, capsys)
    assert got == want and len(got) > 40


class _Trainer:
    """What quality_run.artifact reads of a Trainer: events, the state, the
    scene's test banks and extent, render_view."""

    def __init__(self, params, aux, bank, events):
        from gsjax_torch.render.api import render
        from gsjax_torch.train.optimizer import adam_init
        from gsjax_torch.train.step import TrainState

        self.events = events
        self.state = TrainState(params=params, opt=adam_init(params), aux=aux,
                                step=torch.tensor(10, dtype=torch.int32))
        self.scene = type("Scene", (), {"cameras_extent": 1.5,
                                        "get_test_banks": lambda self: [bank]})()
        self.raster_cfg = RasterConfig(**BUDGETS)
        self.render_view = lambda cam: render(
            params, cam, active_sh_degree=SH, bg_color=torch.zeros(3),
            cfg=self.raster_cfg, alive=aux.alive).image

    def n_alive(self):
        return int(self.state.aux.alive.sum())


def test_quality_artifact_keys_and_diagnosis(scene, tmp_path, capsys):
    """The port's artifact holds every key of gsjax's (v3's, less the note
    its merge added) and diagnoses to the same text through both tools."""
    from gsjax_torch.model import GaussianAux
    from gsjax_torch.scene import CameraBank

    rng = np.random.default_rng(0)
    cams = [scene["cam"]] * 3
    bank = CameraBank.from_cameras(
        cams, [rng.integers(0, 256, (3, H, W), dtype=np.uint8) for _ in cams],
        [np.full((1, H, W), 255, np.uint8) for _ in cams])
    events = []
    for it, pts in ((5, 200), (10, 230)):
        for split, ps in (("test", 11.0 + it / 10), ("train", 12.0 + it / 10)):
            events.append({"eval": split, "iteration": it, "l1": 0.2, "psnr": ps,
                           "points": pts})
    events += [{"budgets": 6, "from": [4096, 4096], "to": [8192, 4096], "why": "x"},
               {"grow": 8, "from": 256, "to": 512}]
    alive = torch.zeros(256, dtype=torch.bool)
    alive[:200] = True
    aux = GaussianAux(alive=alive, max_radii2d=torch.zeros(256),
                      xyz_grad_accum=torch.zeros(256), denom=torch.zeros(256))
    trainer = _Trainer(scene["params"], aux, bank, events)
    art = quality_run.artifact(trainer, 10, 1.0, None, "cpu", str(tmp_path / "renders"))
    with open(V3) as f:
        want_keys = set(json.load(f)) - {"curve_note"}
    assert set(art) == want_keys
    assert [v["view"] for v in art["final_per_view"]] == ["0_0", "0_1", "0_2"]
    assert art["points_curve"] == [{"iteration": 5, "points": 200},
                                   {"iteration": 10, "points": 230}]
    assert art["final_test_psnr"] == 12.0 and art["capacity_events"] == [events[-1]]
    assert art["final_state_diagnostics"]["n_alive"] == 200
    assert len(os.listdir(tmp_path / "renders")) == 3
    path = tmp_path / "artifact.json"
    path.write_text(json.dumps(art))
    assert diagnosis(diagnose_quality.main, path, capsys) == diagnosis(
        jdiagnose_quality.main, path, capsys)


def test_state_diagnostics_formula():
    rng = np.random.default_rng(1)
    xyz = rng.normal(size=(50, 3)).astype(np.float32)
    opac = rng.uniform(size=(50, 1)).astype(np.float32)
    alive = rng.uniform(size=50) > 0.2
    d = quality_run.state_diagnostics(xyz, opac, alive, 1.2)
    live = xyz[alive]
    r = np.linalg.norm(live - live.mean(0), axis=-1)
    assert d["n_alive"] == int(alive.sum())
    assert d["radius_p99"] == round(float(np.percentile(r, 99)), 3)
    assert d["frac_outside_extent"] == round(float((r > 1.2).mean()), 4)


# --- export_lpips_weights ------------------------------------------------------------


def lpips_state_dicts():
    """torchvision's VGG16 state dict layout (features and classifier) and
    LPIPS's linear heads, random."""
    from gsjax_torch.image_metrics import expected_lpips_members

    shapes = expected_lpips_members()
    gen = torch.Generator().manual_seed(0)
    vgg = {}
    for i, idx in enumerate(jexport_lpips_weights.VGG16_CONV_INDICES):
        vgg[f"features.{idx}.weight"] = torch.randn(shapes[f"conv{i}.w"], generator=gen)
        vgg[f"features.{idx}.bias"] = torch.randn(shapes[f"conv{i}.b"], generator=gen)
    vgg["classifier.0.weight"] = torch.randn((4, 8), generator=gen)
    lin = {f"lin{i}.model.1.weight": torch.randn(shapes[f"lin{i}.w"], generator=gen)
           for i in range(5)}
    return vgg, lin


def test_export_lpips_weights_layout(tmp_path):
    from gsjax_torch.image_metrics import check_lpips_weights, expected_lpips_members

    vgg, lin = lpips_state_dicts()
    torch.save(vgg, tmp_path / "vgg16.pth")
    torch.save(lin, tmp_path / "vgg.pth")
    out = export_lpips_weights.main(["--vgg", str(tmp_path / "vgg16.pth"), "--lin",
                                     str(tmp_path / "vgg.pth"), "--out",
                                     str(tmp_path / "lpips.npz")])
    assert export_lpips_weights.VGG16_CONV_INDICES == jexport_lpips_weights.VGG16_CONV_INDICES
    check_lpips_weights(out)
    with np.load(out) as z:
        assert set(z.files) == set(expected_lpips_members())
        for i, idx in enumerate(jexport_lpips_weights.VGG16_CONV_INDICES):
            np.testing.assert_array_equal(z[f"conv{i}.w"], vgg[f"features.{idx}.weight"])
            np.testing.assert_array_equal(z[f"conv{i}.b"], vgg[f"features.{idx}.bias"])
        for i in range(5):
            np.testing.assert_array_equal(z[f"lin{i}.w"], lin[f"lin{i}.model.1.weight"])


def test_export_lpips_weights_needs_the_files(tmp_path):
    with pytest.raises(SystemExit, match="no file"):
        export_lpips_weights.main(["--vgg", str(tmp_path / "none.pth"), "--lin",
                                   str(tmp_path / "none2.pth")])


# --- scaling_projection, bench_scaling ---------------------------------------------


def test_slab_pair_counts_match_gsjax(scene):
    got = scaling_projection.slab_pair_counts(
        scene["proj"], W, H, RasterConfig(tile_w=SLAB_TILE, tile_h=SLAB_TILE,
                                          **COUNT_BUDGETS))
    assert got == scene["jslabs"]
    assert sum(got[2]) > 0


@pytest.mark.parametrize("link", [45.0, scaling_projection.NVLINK_GBPS_EACH_WAY])
def test_projection_matches_gsjax(scene, tmp_path, monkeypatch, link):
    """gsjax's main on the same stage times, slab counts, Gaussian count,
    view and link rate: the port's projection, rounded as gsjax rounds."""
    stages = dict(zip(scaling_projection.REPLICATED + scaling_projection.SLAB,
                      (1.25, 2.5, 0.5, 3.0, 2.0, 4.5, 6.0, 1.75, 0.75)))
    (tmp_path / "stages.json").write_text(json.dumps(stages))
    slabs = scene["jslabs"]
    monkeypatch.setattr(jscaling_projection, "slab_pair_counts", lambda splits: slabs)
    monkeypatch.setattr(jscaling_projection, "N_GAUSS", 256)
    monkeypatch.setattr(jscaling_projection, "WIDTH", W)
    monkeypatch.setattr(jscaling_projection, "HEIGHT", H)
    monkeypatch.setattr(sys, "argv", [
        "scaling_projection", "--stages-json", str(tmp_path / "stages.json"),
        "--ici-gbps", str(link), "--out", str(tmp_path / "jax.json")])
    jscaling_projection.main()
    want = json.loads((tmp_path / "jax.json").read_text())
    t11, rows = scaling_projection.project(stages, slabs, 256, W * H, link)
    assert round(t11, 2) == want["single_chip_step_ms"]
    digits = {"max_slab_pair_share": 4, "imbalance_factor": 3, "tile_psum_ms": 3,
              "data_psum_ms": 3, "step_ms": 2, "throughput_px_per_s": 0, "efficiency": 3}
    for got, w in zip(rows, want["projection"]):
        assert got["mesh"] == w["mesh"]
        assert {k: round(got[k], d) for k, d in digits.items()} == {k: w[k] for k in digits}
    for nbytes, ranks in ((1e6, 1), (9 * 4 * 256, 2), (59 * 4 * 5e5, 8)):
        assert scaling_projection.ring_allreduce_ms(nbytes, ranks, link) == \
            jscaling_projection.ring_allreduce_ms(nbytes, ranks, link)


def test_stages_from_profile_lines(tmp_path):
    rows = [{"stage": "FULL fwd+bwd step", "device_ms": 20.0},
            {"stage": "FULL fwd only", "device_ms": 5.0},
            {"stage": "preprocess (fwd)", "device_ms": 0.5},
            {"stage": "preprocess fwd+bwd", "device_ms": 1.5},
            {"stage": "binning", "device_ms": 3.0},
            {"stage": "permute+build_inst_data", "device_ms": 1.0},
            {"stage": "composite fwd kernel", "device_ms": 0.5},
            {"stage": "composite bwd kernel", "device_ms": 1.5},
            {"stage": "grad reduction", "device_ms": 0.5}]
    got = scaling_projection.stages_from_profile(rows, {"binning_n_rate": 1.0,
                                                        "adam_update": 0.25})
    assert set(got) == set(scaling_projection.REPLICATED + scaling_projection.SLAB)
    assert got["binning_inst_rate"] == 2.0 and got["adam_update"] == 0.25
    assert got["loss_and_misc"] == 20.0 - (1.5 + 3.0 + 1.0 + 0.5 + 1.5 + 0.5)
    # profile_stages' printed lines: a device line, the stages, the counts.
    lines = [{"device": "card"}, *rows, {"rect_instances": 9}]
    (tmp_path / "stages.jsonl").write_text("\n".join(map(json.dumps, lines)) + "\n")
    loaded = scaling_projection.load_stages(str(tmp_path / "stages.jsonl"))
    assert loaded == dict(got, binning_n_rate=0.0, binning_inst_rate=3.0, adam_update=0.0)


def test_bench_scaling_world_of_one_on_gloo(capsys):
    out = bench_scaling.main(["--device", "cpu", "--tiles", "1,2", "--gaussians", "200",
                              "--width", str(W), "--height", str(H), "--iters", "2"])
    assert not dist.is_initialized()
    assert [r["tile"] for r in out["results"]] == [1]
    r = out["results"][0]
    assert r["ms_per_step"] > 0 and "efficiency_vs_1" not in r
    assert out["evidence"] == bench_scaling.NOT_SCALING
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == out


def test_bench_scaling_efficiency():
    rows = [{"tile": 2, "ms_per_step": 6.0}, {"tile": 1, "ms_per_step": 10.0}]
    out = bench_scaling.payload(rows, 10, 10, 5, "card", shares_processor=False)
    assert [r["efficiency_vs_1"] for r in out["results"]] == [1.0, 10.0 / 12.0]
    assert "evidence" not in out


# --- sky_run's pure parts ------------------------------------------------------------


def test_sky_run_shell_stats():
    rng = np.random.default_rng(2)
    xyz = np.concatenate([rng.normal(size=(40, 3)), 30 + rng.normal(size=(10, 3))])
    opac = rng.uniform(size=(50, 1))
    alive = np.ones(50, bool)
    alive[-2:] = False
    got = sky_run.shell_stats(xyz, opac, alive, [0.0, 0.0, 0.0], 2.0)
    assert (got["n_alive"], got["n_far_shell"]) == (48, 8)
    assert got["far_opacity_mean"] == pytest.approx(float(opac[40:48].mean()))
    assert sky_run.shell_stats(xyz[:40], opac[:40], alive[:40], [0, 0, 0], 2.0)[
        "far_opacity_mean"] is None


def test_sky_run_evals_and_summary():
    events = [{"window": 1, "steps": 4}, {"eval": "test", "iteration": 500, "l1": 0.1,
                                          "psnr": 20.0, "points": 9},
              {"eval": "train", "iteration": 500, "l1": 0.1, "psnr": 21.0, "points": 9}]
    assert quality_run.eval_entries(events, "test") == [
        {"iteration": 500, "split": "test", "psnr": 20.0, "l1": 0.1}]
    on = {"final_test_psnr": 22.5, "shell_at_end": {"n_far_shell": 3}}
    off = {"final_test_psnr": 21.0, "shell_at_end": {"n_far_shell": 0}}
    assert sky_run.summarize({"sky_on": on, "sky_off": off}) == {
        "delta_test_psnr": 1.5, "shell_survived_prune": True}
    assert sky_run.summarize({"sky_on": dict(on, shell_at_end={"n_far_shell": 0})}) == {
        "shell_survived_prune": False}
    assert sky_run.summarize({}) == {}
