"""The mesh window (gsjax_torch.parallel.step.make_sharded_train_steps) on
a 1x1 mesh: on the CPU over gloo a Python loop of the sharded step, on the
card over NCCL replays of its captured CUDA graph.

Scene: 200 Gaussians (capacity 256, SH degree 1) at 64x48 in 16x16 tiles,
4096-pair budgets; a window of four steps on two orbit views with
per-step backgrounds, against ground truths rendered from a perturbed
copy. The window is held to the same steps taken one by one, bit for bit
(states as bytes: dead capacity slots carry NaN gradients). On the card
the replayed window is held to the eager loop bit for bit where two eager
windows agree bit for bit, its kernel launches are the capture's count
times the replays, a second window replays the same graph, and
drop_step_graphs forgets it.
"""

from __future__ import annotations

import pytest
import torch
import torch.distributed as dist

from gsjax_torch.config import OptimizationConfig, RasterConfig
from gsjax_torch.parallel import make_mesh
from gsjax_torch.parallel.multihost import init_local_group
from gsjax_torch.parallel.step import make_sharded_train_step, make_sharded_train_steps
from gsjax_torch.render import kernels
from gsjax_torch.render.api import render
from gsjax_torch.synthetic import orbit_camera, random_scene
from gsjax_torch.train import step as steps_mod
from gsjax_torch.train.optimizer import adam_init
from gsjax_torch.train.step import TrainState, clone_state, state_tensors

torch.set_num_threads(1)
W, H = 64, 48
SH = 1
CFG = RasterConfig(tile_size=16, max_instances=4096, max_rows=4096)
ANGLES = (0.2, -0.3)
WINDOW = 4


def problem(device: str):
    """(state, window inputs [W, 1, ...]) on `device`."""
    params, aux = random_scene(200, capacity=256, sh_degree=SH, seed=3, device=device)
    target, _ = random_scene(200, capacity=256, sh_degree=SH, seed=4, device=device)
    cams = [orbit_camera(a, width=W, height=H, device=device) for a in ANGLES]
    with torch.no_grad():
        gts = [render(target, c, active_sh_degree=SH, bg_color=torch.zeros(3, device=device),
                      cfg=CFG, alive=aux.alive).image for c in cams]
    pick = [k % len(cams) for k in range(WINDOW)]

    def stack(get):
        return torch.stack([get(cams[i])[None] for i in pick])

    window = (stack(lambda c: c.view), stack(lambda c: c.full_proj),
              stack(lambda c: c.cam_center), stack(lambda c: c.tan_fovx),
              stack(lambda c: c.tan_fovy), torch.stack([gts[i][None] for i in pick]))
    bgs = torch.linspace(0.0, 1.0, WINDOW * 3).reshape(WINDOW, 3)
    state = TrainState(params=params, opt=adam_init(params), aux=aux,
                       step=torch.ones((), dtype=torch.int32, device=device))
    return state, window, bgs


def as_bytes(state, metrics=None) -> list[bytes]:
    out = [t.detach().cpu().numpy().tobytes() for t in state_tensors(state)]
    if metrics is not None:
        out += [getattr(metrics, k).cpu().numpy().tobytes() for k in steps_mod.METRIC_DTYPES]
    return out


def make_steps(mesh):
    kw = dict(height=H, width=W, active_sh_degree=SH, opt_cfg=OptimizationConfig(),
              raster_cfg=CFG, spatial_lr_scale=1.0)
    return make_sharded_train_step(mesh, **kw), make_sharded_train_steps(mesh, **kw)


@pytest.fixture()
def gloo_mesh():
    init_local_group("cpu")
    try:
        yield make_mesh("cpu", data=1, tile=1)
    finally:
        dist.destroy_process_group()


def test_window_on_gloo_equals_sequential_steps(gloo_mesh):
    """On a CPU mesh the window is the loop: the same bytes as the steps one
    by one, and no graph is captured."""
    step, window_steps = make_steps(gloo_mesh)
    state, window, bgs = problem("cpu")
    a, ma = window_steps(clone_state(state), *window, bgs)
    b, losses = clone_state(state), []
    for k in range(WINDOW):
        b, m = step(b, *(x[k] for x in window), bgs[k])
        losses.append(m.loss)
    assert as_bytes(a) == as_bytes(b)
    assert ma.loss.shape == (WINDOW,) and torch.equal(ma.loss, torch.stack(losses))
    assert int(a.step) == 1 + WINDOW
    assert not steps_mod._GRAPHS


def test_window_loop_takes_host_backgrounds(gloo_mesh):
    """The trainer hands the window its backgrounds on the host; the loop
    moves them to the state's device itself."""
    _, window_steps = make_steps(gloo_mesh)
    state, window, bgs = problem("cpu")
    a, _ = window_steps(clone_state(state), *window, bgs)
    b, _ = window_steps.loop(clone_state(state), *window, bgs.clone())
    assert as_bytes(a) == as_bytes(b)


@pytest.fixture()
def nccl_mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    init_local_group("cuda")
    try:
        yield make_mesh("cuda", data=1, tile=1)
    finally:
        steps_mod.drop_step_graphs()
        dist.destroy_process_group()


@pytest.mark.cuda
def test_mesh_graph_equals_eager_loop_on_card(nccl_mesh):
    _, window_steps = make_steps(nccl_mesh)
    state, window, bgs = problem("cuda")
    ea, ma = window_steps.loop(clone_state(state), *window, bgs)
    eb, mb = window_steps.loop(clone_state(state), *window, bgs)
    eager_bitwise = as_bytes(ea, ma) == as_bytes(eb, mb)
    steps_mod.drop_step_graphs()
    steps_mod.reset_graph_counts()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    held = clone_state(state)
    g, mg = window_steps(held, *window, bgs)
    torch.cuda.synchronize()
    assert len(steps_mod.captures) == 1 and len(steps_mod._GRAPHS) == 1
    per_replay = steps_mod.captures[0]["launches"]
    assert all(per_replay[k] > 0 for k in kernels.KERNEL_NAMES)
    assert per_replay["row_gather"] == 4
    assert steps_mod.replayed_launch_counts == {k: n * WINDOW for k, n in per_replay.items()}
    assert g.params.xyz.data_ptr() == held.params.xyz.data_ptr()
    if eager_bitwise:
        assert as_bytes(g, mg) == as_bytes(ea, ma)
    else:
        torch.testing.assert_close(g.params.xyz, ea.params.xyz, rtol=1e-4, atol=1e-5,
                                   equal_nan=True)
    # A second window replays the same graph from where the first ended.
    g2, _ = window_steps(g, *window, bgs)
    assert len(steps_mod.captures) == 1 and int(g2.step) == 1 + 2 * WINDOW
    steps_mod.drop_step_graphs()
    assert not steps_mod._GRAPHS


@pytest.mark.cuda
def test_mesh_graph_across_cards(tmp_path):
    """The window on up to four cards (tests/torch_mesh_worker.py's graph
    task under torchrun, NCCL): at (1, n) and, on four, (2, 2) the replays
    equal the eager loop bit for bit where two eager loops agree, one
    capture per mesh, and every rank ends with the same replica."""
    import os
    import pathlib
    import subprocess
    import sys

    from gsjax_torch.parallel.multihost import free_port

    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count < 2:
        pytest.skip("needs two or more CUDA devices")
    n = min(count, 4)
    # The worker by path: another installed package may be named "tests".
    worker = pathlib.Path(__file__).with_name("torch_mesh_worker.py")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(n),
           "--master_port", str(free_port()), str(worker), "graph", str(tmp_path), "cuda"]
    run = subprocess.run(cmd, cwd=worker.parents[1], capture_output=True, text=True,
                         timeout=600, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(n)]
    meshes = [k for k in ranks[0] if k.startswith("graph_")]
    assert meshes == [f"graph_1x{n}"] + (["graph_2x2"] if n == 4 else [])
    for key in meshes:
        for r in ranks:
            assert r[key]["captures"] == 1
            assert r[key]["graph_bitwise"] or not r[key]["eager_bitwise"], key
        assert len({r[key]["digest"] for r in ranks}) == 1, key
