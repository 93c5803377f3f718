"""Worker process for the port's mesh tests on the CPU (gloo), and for the
mesh window's test across cards (NCCL).

Launched by tests/test_torch_parallel.py and tests/test_torch_multihost.py
as one process per rank, with gsjax's launch protocol (COORDINATOR_ADDRESS,
NUM_PROCESSES, PROCESS_ID) in the environment:

    python tests/torch_mesh_worker.py <task> <out_dir> [<task arguments>]

or, as the task `cli`, under torchrun (its MASTER_ADDR protocol):

    torchrun --nproc_per_node 2 tests/torch_mesh_worker.py cli <train flags>

or, as the task `graph` on "cuda" or "cpu", under torchrun:

    torchrun --nproc_per_node 4 tests/torch_mesh_worker.py graph <out_dir> cuda

Joins the process group through
gsjax_torch.parallel.multihost.maybe_init_distributed (the code under
test), runs the task's sharded renders, gradients, steps or training run
on the tiny scene of tests/test_parallel.py (300 Gaussians, capacity 512,
SH degree 1), and writes its results with torch.save to
<out_dir>/rank<r>.pt. Imports no JAX.
"""

from __future__ import annotations

import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch
import torch.distributed as dist

from gsjax_torch.config import OptimizationConfig, RasterConfig
from gsjax_torch.parallel import make_mesh, render_sharded
from gsjax_torch.parallel.multihost import free_port, host_local_views, maybe_init_distributed
from gsjax_torch.parallel.step import make_sharded_train_step, make_sharded_train_steps
from gsjax_torch.synthetic import look_at_origin_camera, orbit_camera, random_scene
from gsjax_torch.train.optimizer import adam_init
from gsjax_torch.train.step import TrainState, clone_state, state_tensors

CFG = RasterConfig(max_instances=8192, max_rows=8192)
SH_DEG = 1
W = 64
BG_RENDER = (0.1, 0.2, 0.3)
BG_GRADS = (0.2, 0.1, 0.4)
BG_OVERRUN = (0.3, 0.0, 0.1)
# The cross-package case: 64x48, two cameras on "data".
GSJAX_H = 48
GSJAX_ORBIT = 0.15


def scene():
    return random_scene(300, capacity=512, sh_degree=SH_DEG, seed=3, device="cpu")


def ramp_gt(h: int, w: int = W) -> torch.Tensor:
    """tests/test_parallel.py's ground truth: a linear ramp over the pixels."""
    g = np.linspace(0, 1, h * w, dtype=np.float32).reshape(1, h, w)
    return torch.from_numpy(np.tile(g, (3, 1, 1)))


def random_gt(n: int, h: int) -> torch.Tensor:
    return torch.from_numpy(
        np.random.default_rng(1).uniform(0, 1, (n, 3, h, W)).astype(np.float32))


def bank_args(cams, gts):
    """The step's (views, projs, centers, tanx, tany, gt) for one camera
    per data group."""
    return (torch.stack([c.view for c in cams]), torch.stack([c.full_proj for c in cams]),
            torch.stack([c.cam_center for c in cams]),
            torch.stack([c.tan_fovx for c in cams]), torch.stack([c.tan_fovy for c in cams]),
            torch.stack(list(gts)))


def grads_out(step, params, aux, args, bg):
    g, accum, denom, radii, loss, l1, counts = step.sharded_grads(
        params, aux.alive, *args, torch.tensor(bg))
    return {"grads": {k: v.detach() for k, v in g.items()}, "accum": accum,
            "denom": denom, "radii": radii, "loss": loss, "l1": l1, "counts": counts}


def make_step(mesh, h, w=W, **kw):
    return make_sharded_train_step(
        mesh, height=h, width=w, active_sh_degree=SH_DEG, opt_cfg=OptimizationConfig(),
        raster_cfg=CFG, spatial_lr_scale=1.0, **kw)


def fresh_state(params, aux):
    return clone_state(TrainState(params=params, opt=adam_init(params), aux=aux,
                                  step=torch.zeros((), dtype=torch.int32)))


def full_step(mesh, data):
    """One sharded step from a fresh state on tests/test_parallel.py's
    quantized ramp, the camera replicated over "data"."""
    params, aux = scene()
    cam = look_at_origin_camera(W, W, device="cpu")
    gt = torch.round(ramp_gt(W) * 255.0) / 255.0
    state, m = make_step(mesh, W)(fresh_state(params, aux),
                                  *bank_args([cam] * data, [gt] * data), torch.zeros(3))
    return {"state": [t.detach() for t in state_tensors(state)], "loss": m.loss,
            "l1": m.l1, "num_instances": m.num_instances}


def task_parallel4(out, _):
    """World of 4: renders and gradients at (1,4) and (2,2), the H=48 slab
    overrun, one full step at (2,2), and the cross-package case."""
    params, aux = scene()
    cam = look_at_origin_camera(W, W, device="cpu")
    for d, t in ((1, 4), (2, 2)):
        mesh = make_mesh("cpu", data=d, tile=t)
        out[f"render_{d}x{t}"] = render_sharded(
            params, cam, mesh=mesh, active_sh_degree=SH_DEG,
            bg_color=torch.tensor(BG_RENDER), cfg=CFG, alive=aux.alive)
        out[f"grads_{d}x{t}"] = grads_out(
            make_step(mesh, W), params, aux, bank_args([cam] * d, [ramp_gt(W)] * d),
            BG_GRADS)
    mesh = make_mesh("cpu", data=1, tile=4)
    cam48 = look_at_origin_camera(W, 48, device="cpu")
    out["grads_overrun"] = grads_out(make_step(mesh, 48), params, aux,
                                     bank_args([cam48], [ramp_gt(48)]), BG_OVERRUN)
    mesh = make_mesh("cpu", data=2, tile=2)
    out["step_2x2"] = full_step(mesh, 2)
    cams = [look_at_origin_camera(W, GSJAX_H, device="cpu"),
            orbit_camera(GSJAX_ORBIT, width=W, height=GSJAX_H, device="cpu")]
    out["gsjax_render"] = render_sharded(
        params, cams[0], mesh=mesh, active_sh_degree=SH_DEG,
        bg_color=torch.tensor(BG_RENDER), cfg=CFG, alive=aux.alive)
    out["gsjax_grads"] = grads_out(make_step(mesh, GSJAX_H), params, aux,
                                   bank_args(cams, random_gt(2, GSJAX_H)), BG_GRADS)


def task_parallel2(out, _):
    """World of 2: gradients and one full step at (1,2)."""
    params, aux = scene()
    cam = look_at_origin_camera(W, W, device="cpu")
    mesh = make_mesh("cpu", data=1, tile=2)
    out["grads_1x2"] = grads_out(make_step(mesh, W), params, aux,
                                 bank_args([cam], [ramp_gt(W)]), BG_GRADS)
    out["step_1x2"] = full_step(mesh, 1)


# tests/test_multihost.py's scene: 200 Gaussians, capacity 256, 48x48.
MH_SIZE = 48


def multihost_scene():
    return random_scene(200, capacity=256, sh_degree=SH_DEG, seed=3, device="cpu")


def multihost_args(data):
    cam = look_at_origin_camera(MH_SIZE, MH_SIZE, device="cpu")
    return bank_args([cam] * data, [ramp_gt(MH_SIZE, MH_SIZE)] * data)


def task_multihost(out, argv):
    """World of 2 (one process per rank): two sharded steps on the (1,2) and
    the (2,1) mesh, the same two as one looped window, and a Trainer on the
    (1,2) mesh through a densify and an opacity reset on the dataset at
    argv[0], writing its model under argv[1] from rank 0."""
    from gsjax_torch.config import ModelConfig
    from gsjax_torch.scene import Scene
    from gsjax_torch.train.trainer import Trainer

    for d, t in ((1, 2), (2, 1)):
        mesh = make_mesh("cpu", data=d, tile=t)
        step = make_step(mesh, MH_SIZE, MH_SIZE)
        state = fresh_state(*multihost_scene())
        losses = []
        for _ in range(2):
            state, m = step(state, *multihost_args(d), torch.zeros(3))
            losses.append(float(m.loss))
        out[f"losses_{d}x{t}"] = losses
    mesh = make_mesh("cpu", data=1, tile=2)
    steps = make_sharded_train_steps(
        mesh, height=MH_SIZE, width=MH_SIZE, active_sh_degree=SH_DEG,
        opt_cfg=OptimizationConfig(), raster_cfg=CFG, spatial_lr_scale=1.0)
    wstack = [x[None].expand(2, *x.shape) for x in multihost_args(1)]
    _, wm = steps(fresh_state(*multihost_scene()), *wstack, torch.zeros(2, 3))
    out["window_losses"] = wm.loss.tolist()

    dataset, model = argv
    rank = dist.get_rank()
    cfg = ModelConfig(source_path=dataset, model_path=model if rank == 0 else "")
    opt = OptimizationConfig(iterations=8, densify_from_iter=2, densification_interval=4,
                             densify_until_iter=7, opacity_reset_interval=6,
                             densify_grad_threshold=1e-6, random_background=True)
    trainer = Trainer(Scene(cfg, device="cpu"), cfg, opt,
                      raster_cfg=RasterConfig(max_instances=1 << 12, max_rows=1 << 10),
                      quiet=True, mesh=mesh)
    trainer.train(test_iterations=(8,), save_iterations=(8,), checkpoint_iterations=(8,))
    out["trainer"] = {"is_main": trainer.is_main, "events": trainer.events,
                      "state": [t.detach() for t in state_tensors(trainer.state)],
                      "n_alive": trainer.n_alive()}


def task_cli(argv):
    """cli.train's main under torchrun, at the tests' tiny budgets and
    without TensorBoard (whose import loads TensorFlow here)."""
    import types

    from gsjax_torch.cli import train as train_cli
    from gsjax_torch.train import trainer as trainer_mod

    sys.modules["torch.utils.tensorboard"] = types.SimpleNamespace()
    trainer_mod.RasterConfig = lambda: RasterConfig(max_instances=1 << 12, max_rows=1 << 10)
    trainer = train_cli.main(argv)
    torch.save({"rank": int(os.environ["RANK"]), "is_main": trainer.is_main,
                "events": trainer.events, "n_alive": trainer.n_alive(),
                "state": [t.detach() for t in state_tensors(trainer.state)]},
               os.path.join(os.environ["GSJT_OUT"], f"rank{os.environ['RANK']}.pt"))


# The mesh window across ranks: 20k Gaussians at 320x240 in 16x16 tiles
# (15 tile rows: slabs of 8 at 2 ranks, 4 at 4), two orbit views.
GRAPH_N = 20_000
GRAPH_W, GRAPH_H = 320, 240
GRAPH_CFG = RasterConfig(tile_size=16, max_instances=1 << 17, max_rows=1 << 16)
GRAPH_STEPS = 6


def task_graph(out, argv):
    """The mesh window on the world's ranks, on `argv[0]` ("cuda" or
    "cpu"), at (1, world) and, for a world of four, (2, 2): GRAPH_STEPS
    steps from one state twice as the eager loop and once as the window
    (on a CUDA mesh replays of the captured sharded step, on gloo the
    loop). Per mesh: whether the two eager windows agree bit for bit,
    whether the window equals them bit for bit, the captures made and a
    digest of the window's state (every rank holds the same replica)."""
    import hashlib

    from gsjax_torch.parallel.mesh import local_rank
    from gsjax_torch.render.api import render
    from gsjax_torch.train import step as steps_mod

    device = argv[0]
    dev = torch.device("cuda", local_rank()) if device == "cuda" else torch.device("cpu")
    params, aux = random_scene(GRAPH_N, capacity=GRAPH_N, sh_degree=SH_DEG, seed=3, device=dev)
    target, _ = random_scene(GRAPH_N, sh_degree=SH_DEG, seed=4, device=dev)
    cams = [orbit_camera(a, width=GRAPH_W, height=GRAPH_H, device=dev) for a in (0.1, -0.2)]
    with torch.no_grad():
        gts = [render(target, c, active_sh_degree=SH_DEG, bg_color=torch.zeros(3, device=dev),
                      cfg=GRAPH_CFG, alive=aux.alive).image for c in cams]
    world = dist.get_world_size()

    def as_bytes(state, metrics):
        return b"".join([t.detach().cpu().numpy().tobytes() for t in state_tensors(state)]
                        + [getattr(metrics, k).cpu().numpy().tobytes()
                           for k in steps_mod.METRIC_DTYPES])

    for d, t in [(1, world)] + ([(2, world // 2)] if world == 4 else []):
        mesh = make_mesh(device, data=d, tile=t)
        steps = make_sharded_train_steps(
            mesh, height=GRAPH_H, width=GRAPH_W, active_sh_degree=SH_DEG,
            opt_cfg=OptimizationConfig(), raster_cfg=GRAPH_CFG, spatial_lr_scale=1.0)
        picks = [[(k + j) % len(cams) for j in range(d)] for k in range(GRAPH_STEPS)]
        window = tuple(torch.stack([torch.stack([get(i) for i in row]) for row in picks])
                       for get in (lambda i: cams[i].view, lambda i: cams[i].full_proj,
                                   lambda i: cams[i].cam_center, lambda i: cams[i].tan_fovx,
                                   lambda i: cams[i].tan_fovy, lambda i: gts[i]))
        bgs = torch.linspace(0.0, 1.0, GRAPH_STEPS * 3).reshape(GRAPH_STEPS, 3)
        start = TrainState(params=params, opt=adam_init(params), aux=aux,
                           step=torch.ones((), dtype=torch.int32, device=dev))
        eager_a = as_bytes(*steps.loop(clone_state(start), *window, bgs))
        eager_b = as_bytes(*steps.loop(clone_state(start), *window, bgs))
        steps_mod.drop_step_graphs()
        steps_mod.reset_graph_counts()
        state, metrics = steps(clone_state(start), *window, bgs)
        got = as_bytes(state, metrics)
        out[f"graph_{d}x{t}"] = {
            "eager_bitwise": eager_a == eager_b, "graph_bitwise": got == eager_a,
            "captures": len(steps_mod.captures), "digest": hashlib.sha256(got).hexdigest(),
            "loss": metrics.loss.cpu()}
        steps_mod.drop_step_graphs()


TASKS = {"parallel4": task_parallel4, "parallel2": task_parallel2,
         "multihost": task_multihost, "graph": task_graph}
WORKER = os.path.abspath(__file__)
REPO = os.path.dirname(os.path.dirname(WORKER))


def launch(task: str, n: int, out_dir: str, *args: str, timeout: float = 150) -> list[dict]:
    """Run `task` in n worker processes joined by gsjax's launch protocol;
    returns each rank's results, in rank order."""
    port = free_port()
    procs = []
    for rank in range(n):
        env = dict(os.environ, COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   NUM_PROCESSES=str(n), PROCESS_ID=str(rank), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, task, out_dir, *args], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    logs = [p.communicate(timeout=timeout)[0].decode(errors="replace") for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"{task} worker failed:\n{log[-4000:]}"
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt")) for r in range(n)]


def main() -> None:
    torch.set_num_threads(1)
    if sys.argv[1] == "cli":
        task_cli(sys.argv[2:])
        return
    task, out_dir = sys.argv[1], sys.argv[2]
    device = sys.argv[3] if task == "graph" else "cpu"
    if not maybe_init_distributed(device):
        raise SystemExit("the worker needs the COORDINATOR_ADDRESS protocol")
    out = {"rank": dist.get_rank(), "world": dist.get_world_size(),
           "host_views": list(host_local_views(5))}
    TASKS[task](out, sys.argv[3:])
    torch.save(out, os.path.join(out_dir, f"rank{dist.get_rank()}.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
