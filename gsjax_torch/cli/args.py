"""Argparse wiring over the config dataclasses.

The port of `gsjax.cli.args` (the reference's reflection-based ParamGroup
system, reference: arguments/__init__.py:19-112): flags are generated from
the dataclass fields so names and defaults stay identical to the published
recipe; the same flags get shorthands (-s, -m, -i, -r, -w); training
persists the merged namespace to <model>/cfg_args and render re-hydrates
it with CLI flags taking precedence (get_combined_args).

`--data_device` (reference: where the images live) names the device the
port's scene, model and training run on: "cuda" by default, "cpu" on
request. The mesh flags (`--data_parallel`, `--tile_parallel`) are
gsjax's: above 1 the train CLI trains on a device mesh, one process per
device under torchrun. `--orbax` is parsed as gsjax parses it and refused:
orbax checkpoints are not ported. `--ip` / `--port` are the address the
train CLI's viewer server (gsjax_torch.viewer) listens on.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from argparse import ArgumentParser, Namespace

from gsjax_torch.config import ModelConfig, OptimizationConfig, PipelineConfig

# Fields with single-letter shorthands (reference: leading-underscore attrs,
# arguments/__init__.py:49-56).
_SHORTHANDS = {
    "source_path": "s",
    "model_path": "m",
    "images": "i",
    "resolution": "r",
    "white_background": "w",
}


def add_group(parser: ArgumentParser, cfg_cls, fill_none: bool = False) -> None:
    """Register one config dataclass's fields as flags."""
    for f in dataclasses.fields(cfg_cls):
        default = None if fill_none else f.default
        short = _SHORTHANDS.get(f.name)
        names = [f"--{f.name}"] + ([f"-{short}"] if short else [])
        if f.type in ("bool", bool):
            parser.add_argument(*names, action="store_true", default=default)
        else:
            # A field whose default is None (resolved by its dataclass) takes
            # the type it is annotated with.
            ty = {"int": int, "float": float, "str": str}.get(
                f.type.removesuffix(" | None"), type(f.default))
            parser.add_argument(*names, type=ty, default=default)


def extract(cfg_cls, args: Namespace):
    """Pull one group's fields out of the parsed namespace."""
    kwargs = {}
    for f in dataclasses.fields(cfg_cls):
        v = getattr(args, f.name, None)
        kwargs[f.name] = f.default if v is None else v
    cfg = cfg_cls(**kwargs)
    if hasattr(cfg, "source_path") and cfg.source_path:
        cfg = dataclasses.replace(cfg, source_path=os.path.abspath(cfg.source_path))
    return cfg


def save_cfg_args(model_path: str, model_cfg: ModelConfig) -> None:
    """Persist the model namespace for render-time merging
    (reference: train.py:145-146)."""
    os.makedirs(model_path, exist_ok=True)
    ns = Namespace(**dataclasses.asdict(model_cfg))
    with open(os.path.join(model_path, "cfg_args"), "w") as f:
        f.write(repr(ns))


def get_combined_args(parser: ArgumentParser, argv=None) -> Namespace:
    """Merge saved training cfg_args under CLI flags
    (reference: arguments/__init__.py:92-112)."""
    cmdline = parser.parse_args(argv if argv is not None else sys.argv[1:])
    merged = {}
    try:
        cfgfilepath = os.path.join(cmdline.model_path, "cfg_args")
        print("Looking for config file in", cfgfilepath)
        with open(cfgfilepath) as f:
            cfgfile_string = f.read()
        print(f"Config file found: {cfgfilepath}")
        args_cfgfile = eval(cfgfile_string)
        merged = vars(args_cfgfile).copy()
    except (TypeError, FileNotFoundError):
        print("Config file not found at")
    for k, v in vars(cmdline).items():
        if v is not None:
            merged[k] = v
    return Namespace(**merged)


def make_train_parser() -> ArgumentParser:
    """All train flags (reference: train.py:193-211), as gsjax's."""
    parser = ArgumentParser(description="Training script parameters")
    add_group(parser, ModelConfig)
    add_group(parser, OptimizationConfig)
    add_group(parser, PipelineConfig)
    parser.add_argument("--ip", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=6009)
    parser.add_argument("--debug_from", type=int, default=-1)
    parser.add_argument("--detect_anomaly", action="store_true", default=False)
    parser.add_argument(
        "--test_iterations", nargs="+", type=int, default=[7_000, 30_000]
    )
    parser.add_argument(
        "--save_iterations", nargs="+", type=int, default=[7_000, 30_000]
    )
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--checkpoint_iterations", nargs="+", type=int, default=[])
    parser.add_argument("--start_checkpoint", type=str, default=None)
    parser.add_argument(
        "--capacity", type=int, default=None,
        help="static Gaussian buffer capacity (default: grows on demand)",
    )
    parser.add_argument(
        "--data_parallel", type=int, default=1,
        help="cameras per step (data-parallel batch over the device mesh)",
    )
    parser.add_argument(
        "--tile_parallel", type=int, default=1,
        help="devices sharding the tile grid (tile-slab parallelism)",
    )
    parser.add_argument(
        "--profile_dir", type=str, default=None,
        help="write a torch.profiler trace of steps 100-110 to this dir",
    )
    parser.add_argument(
        "--orbax", action="store_true", default=False,
        help="orbax checkpoints (not ported: the npz form only)",
    )
    return parser
