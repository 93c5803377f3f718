"""Training CLI (reference: train.py:193-221):

    python -m gsjax_torch.cli.train -s <dataset> -m <model dir> [--eval] ...

Trains on the device `--data_device` names (CUDA by default), and serves
the SIBR remote viewer on `--ip`/`--port` (default 127.0.0.1:6009) between
windows; if that address cannot be bound, it trains without the viewer.
Returns the Trainer from main() for callers that drive it in-process.

With `--data_parallel D --tile_parallel T` above 1 it trains on a (D, T)
device mesh, one process per device, launched by torchrun (or gsjax's
COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID protocol):

    torchrun --nproc_per_node 4 -m gsjax_torch.cli.train -s <dataset> \
        -m <model dir> --data_device cpu --data_parallel 2 --tile_parallel 2

The collectives run on NCCL for `--data_device cuda`, on gloo for `cpu`.
Rank 0 alone writes the model directory, prints and serves the viewer.
An in-process caller may pass main() the Trainer's starting RasterConfig
(pre-sized budgets, as gsjax's tools/quality_run.py hands its Trainer)
and the seed of the densify split noise (`split_seed`, default gsjax's
0); the command line has no such flags, as gsjax's has none.

`--densify_strategy mcmc --cap_max N` trains with 3DGS-MCMC's density
control (train/mcmc.py) on one device, with its published constants
(`--noise_lr`, `--opacity_reg`, `--scale_reg`) and densify_until_iter
25,000 unless `--densify_until_iter` is given (OptimizationConfig's
default by strategy)."""

from __future__ import annotations

import dataclasses
import os
import sys
import uuid

import torch
import torch.distributed as dist

from gsjax_torch.cli.args import extract, make_train_parser, save_cfg_args
from gsjax_torch.config import ModelConfig, OptimizationConfig, PipelineConfig, RasterConfig
from gsjax_torch.parallel.mesh import make_mesh
from gsjax_torch.parallel.multihost import maybe_init_distributed
from gsjax_torch.scene import Scene
from gsjax_torch.train.trainer import Trainer
from gsjax_torch.utils.general import safe_state
from gsjax_torch.viewer import NetworkGUI


def prepare_output_and_logger(model_cfg: ModelConfig) -> tuple[ModelConfig, object]:
    """(reference: train.py:134-154)"""
    if not model_cfg.model_path:
        unique = os.getenv("OAR_JOB_ID") or str(uuid.uuid4())
        model_cfg = dataclasses.replace(
            model_cfg, model_path=os.path.join("./output/", unique[0:10])
        )
    print(f"Output folder: {model_cfg.model_path}")
    os.makedirs(model_cfg.model_path, exist_ok=True)
    save_cfg_args(model_cfg.model_path, model_cfg)

    tb_writer = None
    try:
        from torch.utils.tensorboard import SummaryWriter

        tb_writer = SummaryWriter(model_cfg.model_path)
    except ImportError:
        print("Tensorboard not available: not logging progress")
    return model_cfg, tb_writer


def main(argv=None, raster_cfg: RasterConfig | None = None, split_seed: int = 0) -> Trainer:
    parser = make_train_parser()
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])
    if args.orbax:
        raise NotImplementedError("orbax checkpoints are not ported (ROADMAP §3)")
    model_cfg = extract(ModelConfig, args)
    opt_cfg = extract(OptimizationConfig, args)
    pipe_cfg = extract(PipelineConfig, args)

    mesh, own_group = None, False
    n = args.data_parallel * args.tile_parallel
    if n > 1:
        device_type = torch.device(model_cfg.data_device).type
        own_group = not dist.is_initialized() and maybe_init_distributed(device_type)
        world = dist.get_world_size() if dist.is_initialized() else 1
        if world != n:
            raise RuntimeError(
                f"--data_parallel {args.data_parallel} x --tile_parallel "
                f"{args.tile_parallel} needs {n} processes, one per device, and "
                f"this run has {world}: launch it with torchrun --nproc_per_node "
                f"{n} -m gsjax_torch.cli.train ...")
        mesh = make_mesh(device_type, data=args.data_parallel, tile=args.tile_parallel)
    try:
        return _train(args, model_cfg, opt_cfg, pipe_cfg, mesh, raster_cfg, split_seed)
    finally:
        if own_group:
            dist.destroy_process_group()


def _train(args, model_cfg, opt_cfg, pipe_cfg, mesh, raster_cfg, split_seed) -> Trainer:
    is_main = mesh is None or mesh.get_rank() == 0
    save_iterations = list(args.save_iterations) + [opt_cfg.iterations]
    if is_main:
        print(f"Optimizing {model_cfg.model_path}")
    # Ranks other than 0 write nothing and print nothing.
    safe_state(args.quiet or not is_main)
    if mesh is not None:
        print(f"Training on a (data={args.data_parallel}, "
              f"tile={args.tile_parallel}) device mesh")

    if args.detect_anomaly:
        # The reference's own meaning (reference: train.py:218). A captured
        # step cannot run under it: the windows then run eagerly.
        torch.autograd.set_detect_anomaly(True)

    # --debug is the reference rasterizer's dump-inputs-on-failure flag
    # (reference: README.md:143-146); here it turns on anomaly detection
    # from iteration 0 (the trainer also snapshots the whole state on a
    # non-finite loss). --debug_from delays it (reference train.py:81-82).
    debug_from = 0 if pipe_cfg.debug else args.debug_from

    gui = tb_writer = None
    if is_main:
        model_cfg, tb_writer = prepare_output_and_logger(model_cfg)
        try:
            gui = NetworkGUI(args.ip, args.port)
        except OSError as e:
            print(f"Viewer server unavailable ({e}); continuing without GUI")
    else:
        model_cfg = dataclasses.replace(model_cfg, model_path="")

    try:
        scene = Scene(model_cfg, capacity=args.capacity, device=model_cfg.data_device)
        trainer = Trainer(
            scene,
            model_cfg,
            opt_cfg,
            pipe_cfg,
            raster_cfg=raster_cfg,
            start_checkpoint=args.start_checkpoint,
            tb_writer=tb_writer,
            gui=gui,
            quiet=args.quiet,
            profile_dir=args.profile_dir,
            mesh=mesh,
            split_seed=split_seed,
        )
        trainer.train(
            test_iterations=set(args.test_iterations),
            save_iterations=set(save_iterations),
            checkpoint_iterations=set(args.checkpoint_iterations),
            debug_from=debug_from,
        )
    finally:
        # The viewer is served while training runs (gsjax's process ends
        # here).
        if gui is not None:
            gui.close()
    if tb_writer is not None:
        tb_writer.close()
    print("\nTraining complete.")
    return trainer


if __name__ == "__main__":
    main()
