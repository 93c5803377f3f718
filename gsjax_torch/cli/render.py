"""Batch novel-view rendering CLI (reference: render.py:24-65): loads a
trained model at iteration N and renders every train/test view to PNGs
under <model>/{train,test}/ours_<it>/{renders,gt}. On the card each view
is a replay of the render captured for its resolution and budgets
(render/graph.py), as gsjax jits one per (width, height, budgets); on the
CPU the renders run eagerly.

    python -m gsjax_torch.cli.render -m <model dir> [--iteration N]
"""

from __future__ import annotations

import dataclasses
import os
import sys
from argparse import ArgumentParser

import numpy as np
import torch

from gsjax_torch.cli.args import add_group, extract, get_combined_args
from gsjax_torch.config import ModelConfig, PipelineConfig, RasterConfig, pow2_budget
from gsjax_torch.render.graph import drop_render_graphs, render_replayed
from gsjax_torch.scene import Scene
from gsjax_torch.utils.general import safe_state


def save_png(path: str, image: torch.Tensor) -> None:
    from PIL import Image

    arr = torch.clamp(image, 0.0, 1.0).cpu().numpy()
    arr = (arr * 255.0 + 0.5).astype(np.uint8).transpose(1, 2, 0)
    Image.fromarray(arr).save(path)


@torch.no_grad()
def render_set(
    model_path, name, iteration, banks, params, alive, sh_degree, bg, cfg
) -> RasterConfig:
    """(reference: render.py:24-35)

    Returns the (possibly grown) RasterConfig: a frame whose true
    (gaussian, tile) pair count exceeds the static budget is rendered
    again with the budget doubled to the next power of two — dropped pairs
    would silently degrade the output images. A growth drops the captured
    renders of the outgrown budgets, as gsjax clears its jit cache
    (gsjax/cli/render.py:74).
    """
    render_path = os.path.join(model_path, name, f"ours_{iteration}", "renders")
    gts_path = os.path.join(model_path, name, f"ours_{iteration}", "gt")
    os.makedirs(render_path, exist_ok=True)
    os.makedirs(gts_path, exist_ok=True)

    idx = 0
    for bank in banks:
        for i in range(bank.count):
            cam, gt = bank.pick(i)
            while True:
                out = render_replayed(params, cam, active_sh_degree=sh_degree,
                                      bg_color=bg, cfg=cfg, alive=alive)
                ninst, nrows = int(out.num_instances), int(out.num_rows)
                if ninst <= cfg.max_instances and nrows <= cfg.max_rows:
                    break
                drop_render_graphs()
                cfg = dataclasses.replace(
                    cfg,
                    max_instances=max(pow2_budget(ninst), cfg.max_instances),
                    max_rows=max(pow2_budget(nrows), cfg.max_rows),
                )
                print(
                    f"growing raster budgets to {cfg.max_instances}/"
                    f"{cfg.max_rows} (frame needs {ninst}/{nrows})"
                )
            save_png(os.path.join(render_path, f"{idx:05d}.png"), out.image)
            save_png(os.path.join(gts_path, f"{idx:05d}.png"), gt)
            idx += 1
    return cfg


def render_sets(
    model_cfg: ModelConfig,
    iteration: int,
    pipe_cfg: PipelineConfig,
    skip_train: bool,
    skip_test: bool,
) -> None:
    """(reference: render.py:37-49), on the device `data_device` names."""
    scene = Scene(model_cfg, load_iteration=iteration, shuffle=False,
                  device=model_cfg.data_device)
    bgv = [1.0, 1.0, 1.0] if model_cfg.white_background else [0.0, 0.0, 0.0]
    bg = torch.tensor(bgv, dtype=torch.float32, device=scene.params.device)
    cfg = RasterConfig()
    sh_degree = scene.params.max_sh_degree

    if not skip_train:
        cfg = render_set(
            model_cfg.model_path, "train", scene.loaded_iter,
            scene.get_train_banks(), scene.params, scene.aux.alive, sh_degree,
            bg, cfg,
        )
    if not skip_test:
        render_set(
            model_cfg.model_path, "test", scene.loaded_iter,
            scene.get_test_banks(), scene.params, scene.aux.alive, sh_degree,
            bg, cfg,
        )


def make_parser() -> ArgumentParser:
    parser = ArgumentParser(description="Testing script parameters")
    add_group(parser, ModelConfig, fill_none=True)
    add_group(parser, PipelineConfig, fill_none=True)
    parser.add_argument("--iteration", default=-1, type=int)
    parser.add_argument("--skip_train", action="store_true")
    parser.add_argument("--skip_test", action="store_true")
    parser.add_argument("--quiet", action="store_true")
    return parser


def main(argv=None) -> None:
    args = get_combined_args(make_parser(), argv)
    print("Rendering " + args.model_path)
    safe_state(args.quiet)
    render_sets(
        extract(ModelConfig, args),
        args.iteration,
        extract(PipelineConfig, args),
        args.skip_train,
        args.skip_test,
    )


if __name__ == "__main__":
    main()
