"""Export LPIPS-vgg weights to the npz the port's LPIPS reads: the
counterpart of the repository's tools/export_lpips_weights.py, from two
local files instead of downloads.

Inputs:
  --vgg  torchvision's VGG16 state dict (vgg16-397923af.pth, the
         IMAGENET1K_V1 weights): the conv layers of `features` through
         relu5_3, `features.<idx>.weight` and `.bias` at
         VGG16_CONV_INDICES;
  --lin  the LPIPS linear heads (richzhang's lpips/weights/v0.1/vgg.pth):
         `lin<i>.model.1.weight` for i in 0..4.
Output (--out): conv<i>.w / conv<i>.b for i in 0..12 and lin<i>.w, float32,
the layout image_metrics.check_lpips_weights holds a file to.

Needs neither torchvision nor a network; without the two files it exits
with a message.

    python -m gsjax_torch.tools.export_lpips_weights --vgg <vgg16.pth> \
        --lin <lpips vgg.pth> [--out gsjax_torch/weights/lpips_vgg.npz]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

# VGG16's feature-extractor conv layers that LPIPS uses (through relu5_3),
# in the 0..12 numbering of the npz.
VGG16_CONV_INDICES = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]
N_LIN = 5


def convert(vgg: dict, lin: dict) -> dict[str, np.ndarray]:
    """The npz members from the two state dicts (name -> tensor)."""
    def array(state, key):
        if key not in state:
            raise KeyError(f"the state dict has no {key}")
        return state[key].detach().cpu().numpy().astype(np.float32)

    out: dict[str, np.ndarray] = {}
    for i, idx in enumerate(VGG16_CONV_INDICES):
        out[f"conv{i}.w"] = array(vgg, f"features.{idx}.weight")
        out[f"conv{i}.b"] = array(vgg, f"features.{idx}.bias")
    for i in range(N_LIN):
        out[f"lin{i}.w"] = array(lin, f"lin{i}.model.1.weight")
    return out


def main(argv=None) -> str:
    import torch

    from gsjax_torch.image_metrics import check_lpips_weights

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--vgg", required=True, help="torchvision VGG16 state dict (.pth)")
    ap.add_argument("--lin", required=True, help="LPIPS v0.1 vgg.pth (linear heads)")
    ap.add_argument("--out", default=os.path.join("gsjax_torch", "weights", "lpips_vgg.npz"))
    args = ap.parse_args(argv)
    for path in (args.vgg, args.lin):
        if not os.path.isfile(path):
            raise SystemExit(f"export_lpips_weights: no file {path}")
    vgg = torch.load(args.vgg, map_location="cpu", weights_only=True)
    lin = torch.load(args.lin, map_location="cpu", weights_only=True)
    out = convert(vgg, lin)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez(args.out, **out)
    digest = check_lpips_weights(args.out)
    print(f"wrote {args.out} ({len(out)} arrays, sha256 {digest})")
    return args.out


if __name__ == "__main__":
    main()
