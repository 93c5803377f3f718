"""Full benchmark harness (reference: full_eval.py:15-75): trains all 13
benchmark scenes (MipNeRF360 x9, Tanks&Temples x2, DeepBlending x2),
renders at 7k/30k, and runs metrics, through the port's own CLIs
(`python -m gsjax_torch.cli.{train,render,metrics}`)."""

from __future__ import annotations

import os
import sys
from argparse import ArgumentParser

MIPNERF360_OUTDOOR = ["bicycle", "flowers", "garden", "stump", "treehill"]
MIPNERF360_INDOOR = ["room", "counter", "kitchen", "bonsai"]
TANKS_AND_TEMPLES = ["truck", "train"]
DEEP_BLENDING = ["drjohnson", "playroom"]


def main(argv=None) -> None:
    parser = ArgumentParser(description="Full evaluation script parameters")
    parser.add_argument("--skip_training", action="store_true")
    parser.add_argument("--skip_rendering", action="store_true")
    parser.add_argument("--skip_metrics", action="store_true")
    parser.add_argument("--output_path", default="./eval")
    parser.add_argument("--mipnerf360", "-m360", default="", type=str)
    parser.add_argument("--tanksandtemples", "-tat", default="", type=str)
    parser.add_argument("--deepblending", "-db", default="", type=str)
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])

    if not args.skip_training or not args.skip_rendering:
        for src, scenes in (
            (args.mipnerf360, MIPNERF360_OUTDOOR + MIPNERF360_INDOOR),
            (args.tanksandtemples, TANKS_AND_TEMPLES),
            (args.deepblending, DEEP_BLENDING),
        ):
            if not src:
                raise SystemExit(
                    "provide --mipnerf360/--tanksandtemples/--deepblending "
                    "dataset folders (or --skip_training --skip_rendering)"
                )

    py = sys.executable
    common = " --quiet --eval --test_iterations -1"
    if not args.skip_training:
        for scene in MIPNERF360_OUTDOOR:
            source = args.mipnerf360 + "/" + scene
            os.system(
                f"{py} -m gsjax_torch.cli.train -s {source} -i images_4 -m "
                f"{args.output_path}/{scene}{common}"
            )
        for scene in MIPNERF360_INDOOR:
            source = args.mipnerf360 + "/" + scene
            os.system(
                f"{py} -m gsjax_torch.cli.train -s {source} -i images_2 -m "
                f"{args.output_path}/{scene}{common}"
            )
        for scene in TANKS_AND_TEMPLES:
            source = args.tanksandtemples + "/" + scene
            os.system(
                f"{py} -m gsjax_torch.cli.train -s {source} -m {args.output_path}/{scene}{common}"
            )
        for scene in DEEP_BLENDING:
            source = args.deepblending + "/" + scene
            os.system(
                f"{py} -m gsjax_torch.cli.train -s {source} -m {args.output_path}/{scene}{common}"
            )

    all_scenes = (
        MIPNERF360_OUTDOOR + MIPNERF360_INDOOR + TANKS_AND_TEMPLES + DEEP_BLENDING
    )
    if not args.skip_rendering:
        all_sources = (
            [args.mipnerf360 + "/" + s for s in MIPNERF360_OUTDOOR]
            + [args.mipnerf360 + "/" + s for s in MIPNERF360_INDOOR]
            + [args.tanksandtemples + "/" + s for s in TANKS_AND_TEMPLES]
            + [args.deepblending + "/" + s for s in DEEP_BLENDING]
        )
        for scene, source in zip(all_scenes, all_sources):
            for it in (7_000, 30_000):
                os.system(
                    f"{py} -m gsjax_torch.cli.render --iteration {it} -s {source} -m "
                    f"{args.output_path}/{scene} --quiet --eval --skip_train"
                )

    if not args.skip_metrics:
        scenes_string = " ".join(
            f'"{args.output_path}/{s}"' for s in all_scenes
        )
        os.system(f"{py} -m gsjax_torch.cli.metrics -m {scenes_string}")


if __name__ == "__main__":
    main()
