"""COLMAP conversion CLI (reference: convert.py:31-122): wraps the external
`colmap` binary (feature_extractor -> exhaustive_matcher -> mapper ->
image_undistorter) and optionally resizes with PIL (the reference shells out
to ImageMagick; PIL is baked into this image and magick is not)."""

from __future__ import annotations

import os
import shutil
import sys
from argparse import ArgumentParser


def run(cmd: str) -> None:
    exit_code = os.system(cmd)
    if exit_code != 0:
        print(f"command failed with code {exit_code}. Exiting.")
        raise SystemExit(exit_code)


def main(argv=None) -> None:
    parser = ArgumentParser("Colmap converter")
    parser.add_argument("--no_gpu", action="store_true")
    parser.add_argument("--skip_matching", action="store_true")
    parser.add_argument("--source_path", "-s", required=True, type=str)
    parser.add_argument("--camera", default="OPENCV", type=str)
    parser.add_argument("--colmap_executable", default="", type=str)
    parser.add_argument("--resize", action="store_true")
    parser.add_argument("--magick_executable", default="", type=str)
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])

    colmap_command = (
        f'"{args.colmap_executable}"' if args.colmap_executable else "colmap"
    )
    use_gpu = 1 if not args.no_gpu else 0
    src = args.source_path

    if not args.skip_matching:
        os.makedirs(src + "/distorted/sparse", exist_ok=True)
        run(
            f"{colmap_command} feature_extractor "
            f"--database_path {src}/distorted/database.db "
            f"--image_path {src}/input "
            f"--ImageReader.single_camera 1 "
            f"--ImageReader.camera_model {args.camera} "
            f"--SiftExtraction.use_gpu {use_gpu}"
        )
        run(
            f"{colmap_command} exhaustive_matcher "
            f"--database_path {src}/distorted/database.db "
            f"--SiftMatching.use_gpu {use_gpu}"
        )
        run(
            f"{colmap_command} mapper "
            f"--database_path {src}/distorted/database.db "
            f"--image_path {src}/input "
            f"--output_path {src}/distorted/sparse "
            f"--Mapper.ba_global_function_tolerance=0.000001"
        )

    # Undistort into the layout train.py expects.
    run(
        f"{colmap_command} image_undistorter "
        f"--image_path {src}/input "
        f"--input_path {src}/distorted/sparse/0 "
        f"--output_path {src} --output_type COLMAP"
    )
    files = os.listdir(src + "/sparse")
    os.makedirs(src + "/sparse/0", exist_ok=True)
    for fname in files:
        if fname == "0":
            continue
        shutil.move(
            os.path.join(src, "sparse", fname),
            os.path.join(src, "sparse", "0", fname),
        )

    if args.resize:
        from PIL import Image

        print("Copying and resizing...")
        for factor, dirname in ((2, "images_2"), (4, "images_4"), (8, "images_8")):
            os.makedirs(src + "/" + dirname, exist_ok=True)
            for fname in os.listdir(src + "/images"):
                im = Image.open(os.path.join(src, "images", fname))
                w, h = im.size
                im.resize((w // factor, h // factor)).save(
                    os.path.join(src, dirname, fname)
                )
    print("Done.")


if __name__ == "__main__":
    main()
