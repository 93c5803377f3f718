"""Evaluation CLI (reference: metrics.py:24-103): reads rendered/gt image
pairs from <model>/test/ours_<it>/ and writes results.json and
per_view.json with SSIM / PSNR / LPIPS, under gsjax's keys.

    python -m gsjax_torch.cli.metrics -m <model dir> [...] [--device cpu]

LPIPS-vgg is scored per view when weights are available
(image_metrics.lpips_available(): GSJAX_LPIPS_WEIGHTS names an npz in the
layout of gsjax/weights/LPIPS_WEIGHTS_SPEC.md); without them it is
reported as null, with gsjax's message.
"""

from __future__ import annotations

import json
import os
import sys
from argparse import ArgumentParser
from pathlib import Path

import numpy as np
import torch

from gsjax_torch.config import resolve_device
from gsjax_torch.image_metrics import lpips, lpips_available, psnr
from gsjax_torch.train.loss import ssim


def read_images(renders_dir: Path, gt_dir: Path):
    """(reference: metrics.py:24-34)"""
    from PIL import Image

    renders, gts, names = [], [], []
    for fname in sorted(os.listdir(renders_dir)):
        render = np.asarray(Image.open(renders_dir / fname).convert("RGB"))
        gt = np.asarray(Image.open(gt_dir / fname).convert("RGB"))
        renders.append(render.transpose(2, 0, 1).astype(np.float32) / 255.0)
        gts.append(gt.transpose(2, 0, 1).astype(np.float32) / 255.0)
        names.append(fname)
    return renders, gts, names


@torch.no_grad()
def evaluate(model_paths: list[str], device=None) -> None:
    """(reference: metrics.py:36-93), on `device` (default CUDA)."""
    dev = resolve_device(device)
    full_dict, per_view_dict = {}, {}
    for scene_dir in model_paths:
        try:
            print("Scene:", scene_dir)
            full_dict[scene_dir] = {}
            per_view_dict[scene_dir] = {}
            test_dir = Path(scene_dir) / "test"

            for method in os.listdir(test_dir):
                print("Method:", method)
                full_dict[scene_dir][method] = {}
                per_view_dict[scene_dir][method] = {}
                method_dir = test_dir / method
                renders, gts, names = read_images(
                    method_dir / "renders", method_dir / "gt"
                )
                ssims, psnrs, lpipss = [], [], []
                use_lpips = lpips_available()
                for r, g in zip(renders, gts):
                    rt = torch.as_tensor(r, device=dev)
                    gtt = torch.as_tensor(g, device=dev)
                    ssims.append(float(ssim(rt, gtt)))
                    psnrs.append(float(psnr(rt, gtt).mean()))
                    lpipss.append(
                        float(lpips(rt, gtt, net_type="vgg").mean())
                        if use_lpips
                        else None
                    )
                mean = lambda xs: (
                    float(np.mean([x for x in xs if x is not None]))
                    if any(x is not None for x in xs)
                    else None
                )
                print(f"  SSIM : {mean(ssims):.7f}")
                print(f"  PSNR : {mean(psnrs):.7f}")
                if use_lpips:
                    print(f"  LPIPS: {mean(lpipss):.7f}")
                else:
                    print(
                        "  LPIPS: UNAVAILABLE — reported as null in "
                        "results.json. The reference always scores "
                        "LPIPS-vgg (metrics.py:71-74); this environment "
                        "has no network egress to fetch the pretrained "
                        "VGG16+linear-head weights. Export them once with "
                        "tools/export_lpips_weights.py on a machine with "
                        "torchvision, then set GSJAX_LPIPS_WEIGHTS=<npz>."
                    )
                full_dict[scene_dir][method].update(
                    {
                        "SSIM": mean(ssims),
                        "PSNR": mean(psnrs),
                        "LPIPS": mean(lpipss),
                    }
                )
                per_view_dict[scene_dir][method].update(
                    {
                        "SSIM": dict(zip(names, ssims)),
                        "PSNR": dict(zip(names, psnrs)),
                        "LPIPS": dict(zip(names, lpipss)),
                    }
                )
            with open(os.path.join(scene_dir, "results.json"), "w") as fp:
                json.dump(full_dict[scene_dir], fp, indent=True)
            with open(os.path.join(scene_dir, "per_view.json"), "w") as fp:
                json.dump(per_view_dict[scene_dir], fp, indent=True)
        except Exception as e:
            print(f"Unable to compute metrics for model {scene_dir}: {e}")


def make_parser() -> ArgumentParser:
    parser = ArgumentParser(description="Training script parameters")
    parser.add_argument(
        "--model_paths", "-m", required=True, nargs="+", type=str, default=[]
    )
    parser.add_argument("--device", type=str, default=None,
                        help="device to score on (default cuda)")
    return parser


def main(argv=None) -> None:
    args = make_parser().parse_args(argv if argv is not None else sys.argv[1:])
    evaluate(args.model_paths, args.device)


if __name__ == "__main__":
    main()
