"""gsjax_torch.parallel on the CPU: the mesh over gloo, one process per
rank (tests/torch_mesh_worker.py).

Held to the port's own single-device path at tests/test_parallel.py's
tolerances (300 Gaussians, capacity 512, SH degree 1, 64x64 and 64x48,
8192-pair budgets): render_sharded at (1,1), (1,4) and (2,2);
sharded_grads at (1,2), (1,4), (2,2) and the H=48 slab overrun (tile rank
3's slab lies wholly past the image); one full sharded step against
train_step. Held to gsjax: render_sharded and sharded_grads on a (2,2)
mesh at 64x48 with two cameras on "data" (gsjax's side computed once, in
a module fixture), ssim_map(pad_h=False) forward and gradient, and
mesh_shape_for; make_mesh's errors.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import gsjax.parallel as jparallel
import gsjax.train.loss as jloss
from gsjax.config import OptimizationConfig as JOptimizationConfig
from gsjax.config import RasterConfig as JRasterConfig
from gsjax.parallel.step import make_sharded_train_step as jmake_sharded_train_step
from gsjax_torch.config import OptimizationConfig
from gsjax_torch.model import PARAM_NAMES
from gsjax_torch.parallel import make_mesh, mesh_shape_for, render_sharded
from gsjax_torch.parallel.multihost import init_local_group
from gsjax_torch.render.api import render
from gsjax_torch.train import loss
from gsjax_torch.train.step import state_tensors, train_step
from tests import torch_mesh_worker as worker
from tests.scene_utils import look_at_origin_camera as jlook_at_origin_camera
from tests.scene_utils import orbit_camera as jorbit_camera
from tests.scene_utils import random_scene as jrandom_scene
from tests.torch_parity import n

torch.set_num_threads(1)
W = worker.W
LAM = OptimizationConfig().lambda_dssim


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return worker.launch("parallel4", 4, str(tmp_path_factory.mktemp("parallel4")))


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return worker.launch("parallel2", 2, str(tmp_path_factory.mktemp("parallel2")))


@pytest.fixture(scope="module")
def worlds(world4, world2):
    """Rank 0's results of both worlds, by key."""
    return {**world4[0], **world2[0]}


@pytest.fixture()
def local_group():
    """A world-size-1 gloo group in this process, for the test's length."""
    init_local_group("cpu")
    yield
    dist.destroy_process_group()


def single_render(h: int, bg) -> torch.Tensor:
    params, aux = worker.scene()
    cam = worker.look_at_origin_camera(W, h, device="cpu")
    with torch.no_grad():
        return render(params, cam, active_sh_degree=worker.SH_DEG, bg_color=torch.tensor(bg),
                      cfg=worker.CFG, alive=aux.alive).image


def single_grads(h: int, bg):
    """The single-device loss and parameter gradients (the objective of
    train_step) on the ramp ground truth."""
    params, aux = worker.scene()
    cam = worker.look_at_origin_camera(W, h, device="cpu")
    gt = worker.ramp_gt(h)
    img = render(params, cam, active_sh_degree=worker.SH_DEG, bg_color=torch.tensor(bg),
                 cfg=worker.CFG, alive=aux.alive).image
    obj = (1.0 - LAM) * loss.l1_loss(img, gt) + LAM * (1.0 - loss.ssim(img, gt))
    grads = torch.autograd.grad(obj, [getattr(params, k) for k in PARAM_NAMES])
    return float(obj.detach()), dict(zip(PARAM_NAMES, grads)), aux.alive


def test_mesh_shape_for_matches_gsjax():
    for n_dev in range(1, 17):
        for max_tile in (1, 2, 4, 8):
            assert mesh_shape_for(n_dev, max_tile) == jparallel.mesh_shape_for(n_dev, max_tile)


def test_make_mesh_errors(monkeypatch):
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh("cpu", data=1, tile=1)
    with pytest.raises(ValueError, match="device_type"):
        make_mesh("tpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh("cuda", data=1, tile=1)
    init_local_group("cpu")
    try:
        with pytest.raises(ValueError, match="mesh 2x1 != 1 devices"):
            make_mesh("cpu", data=2, tile=1)
        mesh = make_mesh("cpu")
        assert (mesh.mesh_dim_names, tuple(mesh.shape)) == (("data", "tile"), (1, 1))
        # A CUDA mesh needs NCCL, not the gloo group this process holds.
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        with pytest.raises(ValueError, match="nccl"):
            make_mesh("cuda", data=1, tile=1)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("data,tile", [(1, 1), (1, 4), (2, 2)])
def test_render_sharded_matches_single(worlds, local_group, data, tile):
    if (data, tile) == (1, 1):
        params, aux = worker.scene()
        got = render_sharded(
            params, worker.look_at_origin_camera(W, W, device="cpu"),
            mesh=make_mesh("cpu", data=1, tile=1), active_sh_degree=worker.SH_DEG,
            bg_color=torch.tensor(worker.BG_RENDER), cfg=worker.CFG, alive=aux.alive)
    else:
        got = worlds[f"render_{data}x{tile}"]
    want = single_render(W, worker.BG_RENDER)
    assert got.shape == (3, W, W)
    np.testing.assert_allclose(n(got), n(want), atol=2e-5, rtol=1e-4)


GRAD_CASES = {"1x2": (W, worker.BG_GRADS), "1x4": (W, worker.BG_GRADS),
              "2x2": (W, worker.BG_GRADS), "overrun": (48, worker.BG_OVERRUN)}


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_sharded_grads_match_single(worlds, case):
    """The reduced gradient before Adam equals the single-device backward
    at tests/test_parallel.py's tolerances, on alive rows (dead capacity
    slots are don't-care on both paths). "overrun": H=48 on 4 tile ranks
    with 16-pixel tile rows, so rank 3's slab is wholly past the image and
    rank 2's partly: the row masking, the zero halos at the ends and the
    halo cotangents' directions all show in this case."""
    h, bg = GRAD_CASES[case]
    want_loss, want, alive = single_grads(h, bg)
    got = worlds[f"grads_{case}"]
    np.testing.assert_allclose(float(got["loss"]), want_loss, rtol=1e-5)
    for name in PARAM_NAMES:
        b = n(want[name])[n(alive)]
        assert np.isfinite(b).all(), f"single-device {name} grads not finite"
        np.testing.assert_allclose(n(got["grads"][name])[n(alive)], b, atol=8e-6,
                                   rtol=2e-4, err_msg=f"gradient mismatch in {name}")


@pytest.mark.parametrize("data,tile", [(1, 2), (2, 2)])
def test_sharded_step_matches_single(worlds, data, tile):
    """One sharded step equals one train_step on the same camera (the
    camera replicated over "data", so the batch mean is a no-op and the
    statistics scale by `data`): tests/test_parallel.py's rule, < 0.5 % of
    elements beyond 5e-5 + 1e-3|b|."""
    params, aux = worker.scene()
    cam = worker.look_at_origin_camera(W, W, device="cpu")
    gt = torch.round(worker.ramp_gt(W) * 255.0) / 255.0
    s1, m1 = train_step(worker.fresh_state(params, aux), cam, gt, torch.zeros(3),
                        active_sh_degree=worker.SH_DEG, opt_cfg=OptimizationConfig(),
                        raster_cfg=worker.CFG, spatial_lr_scale=1.0)
    got = worlds[f"step_{data}x{tile}"]
    assert np.isfinite(float(got["loss"]))
    np.testing.assert_allclose(float(got["loss"]), float(m1.loss), rtol=1e-5)
    want = state_tensors(s1)
    for i, name in enumerate(PARAM_NAMES):
        a, b = n(got["state"][i]), n(want[i])
        bad = np.abs(a - b) > 5e-5 + 1e-3 * np.abs(b)
        assert bad.mean() < 0.005, f"{name}: {bad.sum()}/{bad.size} mismatched"
    # The aux tensors follow the 18 parameter and moment tensors.
    alive, radii, accum, denom = (n(t) for t in got["state"][18:22])
    np.testing.assert_array_equal(alive, n(s1.aux.alive))
    np.testing.assert_allclose(denom, n(s1.aux.denom) * data, atol=1e-6)
    np.testing.assert_allclose(accum, n(s1.aux.xyz_grad_accum) * data, atol=1e-6, rtol=8e-3)
    np.testing.assert_allclose(radii, n(s1.aux.max_radii2d), atol=0)


def test_replicas_are_equal(world4, world2):
    """Every rank holds the same reduced gradients and the same state after
    a step, bit for bit (NaN rows of dead slots included)."""
    def flat(r):
        out = []
        for k, v in sorted(r.items()):
            if k.startswith("grads_"):
                out += [v["grads"][name] for name in PARAM_NAMES]
                out += [v[s] for s in ("accum", "denom", "radii", "loss", "l1", "counts")]
            elif k.startswith("step_"):
                out += v["state"]
        return [t.numpy().tobytes() for t in out]

    for world in (world4, world2):
        first = flat(world[0])
        assert first and all(flat(r) == first for r in world[1:])


# --- against gsjax's own sharded functions ---------------------------------------


@pytest.fixture(scope="module")
def gsjax_sharded():
    """gsjax's render_sharded and sharded_grads on a (2,2) mesh of virtual
    CPU devices at 64x48, two cameras on "data": computed once."""
    params, aux = jrandom_scene(300, capacity=512, sh_degree=worker.SH_DEG, seed=3)
    cams = [jlook_at_origin_camera(width=W, height=worker.GSJAX_H),
            jorbit_camera(worker.GSJAX_ORBIT, width=W, height=worker.GSJAX_H)]
    cfg = JRasterConfig(max_instances=8192, max_rows=8192, interpret=True)
    mesh = jparallel.make_mesh(jax.devices()[:4], data=2, tile=2)
    image = jparallel.render_sharded(
        params, cams[0], mesh=mesh, active_sh_degree=worker.SH_DEG,
        bg_color=jnp.asarray(worker.BG_RENDER, jnp.float32), cfg=cfg, alive=aux.alive)
    step = jmake_sharded_train_step(
        mesh, height=worker.GSJAX_H, width=W, active_sh_degree=worker.SH_DEG,
        opt_cfg=JOptimizationConfig(), raster_cfg=cfg, spatial_lr_scale=1.0)
    stack = lambda k: jnp.stack([getattr(c, k) for c in cams])  # noqa: E731
    g, accum, denom, radii, loss_, l1, counts = jax.jit(step.sharded_grads)(
        params, aux.alive, stack("view"), stack("full_proj"), stack("cam_center"),
        stack("tan_fovx"), stack("tan_fovy"),
        jnp.asarray(worker.random_gt(2, worker.GSJAX_H).numpy()),
        jnp.asarray(worker.BG_GRADS, jnp.float32))
    return {"image": np.asarray(image), "alive": np.asarray(aux.alive),
            "grads": {k: np.asarray(getattr(g, k)) for k in PARAM_NAMES},
            "accum": np.asarray(accum), "denom": np.asarray(denom),
            "radii": np.asarray(radii), "loss": float(loss_), "l1": float(l1),
            "counts": np.asarray(counts)}


def test_render_sharded_matches_gsjax(world4, gsjax_sharded):
    np.testing.assert_allclose(n(world4[0]["gsjax_render"]), gsjax_sharded["image"],
                               atol=2e-3, rtol=1e-3)


def test_sharded_grads_match_gsjax(world4, gsjax_sharded):
    """Gradients within 5e-3 of each column's largest (the port's gradient
    tolerance against gsjax), on alive rows; the statistics and the loss
    alike."""
    got, want = world4[0]["gsjax_grads"], gsjax_sharded
    alive = want["alive"]
    np.testing.assert_allclose(float(got["loss"]), want["loss"], rtol=1e-4)
    np.testing.assert_allclose(float(got["l1"]), want["l1"], rtol=1e-4)
    for name in PARAM_NAMES:
        a = n(got["grads"][name])[alive].reshape(alive.sum(), -1)
        b = want["grads"][name][alive].reshape(alive.sum(), -1)
        scale = np.maximum(np.abs(b).max(axis=0), 1e-8)
        np.testing.assert_allclose(a / scale, b / scale, atol=5e-3, err_msg=name)
    np.testing.assert_array_equal(n(got["denom"]), want["denom"])
    np.testing.assert_array_equal(n(got["radii"]), want["radii"])
    scale = want["accum"].max()
    np.testing.assert_allclose(n(got["accum"]) / scale, want["accum"] / scale, atol=5e-3)
    np.testing.assert_array_equal(n(got["counts"]), want["counts"])


def test_ssim_map_valid_rows_matches_gsjax():
    """ssim_map(pad_h=False) on an image carrying 5 halo rows top and
    bottom: its map and its gradients against gsjax's, and its map against
    the rows of the whole image's map that it covers."""
    rng = np.random.default_rng(0)
    a = rng.uniform(0.0, 1.0, (3, 30, 40)).astype(np.float32)
    b = np.clip(a + 0.2 * rng.standard_normal(a.shape), 0.0, 1.0).astype(np.float32)
    u = rng.standard_normal((3, 20, 40)).astype(np.float32)
    ta, tb = torch.from_numpy(a).requires_grad_(), torch.from_numpy(b).requires_grad_()
    smap = loss.ssim_map(ta, tb, pad_h=False)
    got = torch.autograd.grad(smap, (ta, tb), torch.from_numpy(u))

    def jfn(x, y):
        return jnp.sum(jloss.ssim_map(x, y, 11, 1.5, False) * u)

    want_map = np.asarray(jloss.ssim_map(jnp.asarray(a), jnp.asarray(b), 11, 1.5, False))
    want = jax.grad(jfn, (0, 1))(jnp.asarray(a), jnp.asarray(b))
    assert smap.shape == (3, 20, 40)
    np.testing.assert_allclose(n(smap), want_map, atol=1e-5)
    for g, w in zip(got, want):
        np.testing.assert_allclose(n(g), np.asarray(w), atol=1e-5)
    whole = loss.ssim_map(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(n(smap), n(whole)[:, 5:25], atol=1e-6)
