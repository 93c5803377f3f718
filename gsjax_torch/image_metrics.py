"""Image quality metrics: MSE, PSNR (reference: utils/image_utils.py:14-19)
and LPIPS (reference: lpipsPyTorch/).

LPIPS is the v0.1 network as gsjax.image_metrics builds it: a VGG16
feature trunk with unit-normalised activations and 1x1 linear heads,
here an nn.Module of torch convolutions on the images' device. The
reference downloads its pretrained weights at run time (reference:
lpipsPyTorch/modules/utils.py:11); this package takes them, as gsjax
does, from an npz in the layout of gsjax/weights/LPIPS_WEIGHTS_SPEC.md,
named by `GSJAX_LPIPS_WEIGHTS` (or the `weights` argument), so one file
serves both packages. Without weights LPIPS is unavailable and callers
skip it (lpips_available()).

    python -m gsjax_torch.image_metrics --check-weights PATH
"""

from __future__ import annotations

import functools
import hashlib
import os

import numpy as np
import torch
from torch import nn


def mse(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Per-image mean squared error over flattened pixels
    (reference: utils/image_utils.py:14-15). Takes [C,H,W] or [B,C,H,W];
    returns [1,1,1,1] or [B,1,1,1]."""
    if img1.ndim == 3:
        img1, img2 = img1[None], img2[None]
    return torch.mean((img1 - img2) ** 2, dim=tuple(range(1, img1.ndim)), keepdim=True)


def psnr(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """20 * log10(1 / sqrt(mse)) per image (reference:
    utils/image_utils.py:17-19), in mse's shape."""
    return 20.0 * torch.log10(1.0 / torch.sqrt(mse(img1, img2)))


# --------------------------------------------------------------------------
# LPIPS v0.1
# --------------------------------------------------------------------------

# Input z-score constants of the reference's BaseNet (reference:
# lpipsPyTorch/modules/networks.py:44-52), applied to the [0,1] image
# directly (networks.py:58-60), as gsjax applies them.
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

# VGG16 conv layout: (out_channels, n_convs) per block; features tapped
# after each block's last ReLU (layers 3, 8, 15, 22, 29 in torchvision
# indexing).
_VGG_BLOCKS = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))

_WEIGHTS_ENV = "GSJAX_LPIPS_WEIGHTS"


def lpips_weights_path() -> str | None:
    """The weights npz: $GSJAX_LPIPS_WEIGHTS, else
    gsjax_torch/weights/lpips_vgg.npz, else <repo>/weights/lpips_vgg.npz."""
    p = os.environ.get(_WEIGHTS_ENV)
    if p and os.path.exists(p):
        return p
    here = os.path.dirname(__file__)
    for default in (
        os.path.join(here, "weights", "lpips_vgg.npz"),
        os.path.join(here, "..", "weights", "lpips_vgg.npz"),
    ):
        if os.path.exists(default):
            return default
    return None


def lpips_available() -> bool:
    return lpips_weights_path() is not None


class LPIPSVGG(nn.Module):
    """The LPIPS-vgg network with the weights of one npz (key -> array, in
    expected_lpips_members' layout): 13 conv3x3 layers with bias and ReLU,
    a tap after each block, 2x2 max-pool between blocks, unit-normalised
    channels (eps added to the norm), 1x1 heads, spatial mean."""

    def __init__(self, weights) -> None:
        super().__init__()
        self.convs = nn.ModuleList()
        self.taps = []  # index of each block's last conv
        idx = 0
        for _, n_convs in _VGG_BLOCKS:
            for _ in range(n_convs):
                w = torch.as_tensor(np.asarray(weights[f"conv{idx}.w"], np.float32))
                conv = nn.Conv2d(w.shape[1], w.shape[0], 3, padding=1)
                with torch.no_grad():
                    conv.weight.copy_(w)
                    conv.bias.copy_(torch.as_tensor(
                        np.asarray(weights[f"conv{idx}.b"], np.float32)))
                self.convs.append(conv)
                idx += 1
            self.taps.append(idx - 1)
        for i in range(len(_VGG_BLOCKS)):
            self.register_buffer(f"lin{i}", torch.as_tensor(
                np.asarray(weights[f"lin{i}.w"], np.float32)))
        self.register_buffer("shift", torch.tensor(_SHIFT)[None, :, None, None])
        self.register_buffer("scale", torch.tensor(_SCALE)[None, :, None, None])
        self.requires_grad_(False)

    def features(self, x: torch.Tensor) -> list[torch.Tensor]:
        feats = []
        x = (x - self.shift) / self.scale
        for i, conv in enumerate(self.convs):
            x = torch.relu(conv(x))
            if i in self.taps:
                feats.append(x)
                if i != self.taps[-1]:
                    x = nn.functional.max_pool2d(x, 2, 2)
        return feats

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """[B] distances of [B,3,H,W] images in [0,1]; x and y run as one
        batch of 2B."""
        b = x.shape[0]
        total = torch.zeros(b, dtype=torch.float32, device=x.device)
        for i, f in enumerate(self.features(torch.cat([x, y]))):
            f = f / (torch.linalg.vector_norm(f, dim=1, keepdim=True) + 1e-10)
            d = (f[:b] - f[b:]) ** 2
            total = total + torch.mean(torch.sum(d * getattr(self, f"lin{i}"), dim=1),
                                       dim=(1, 2))
        return total


@functools.lru_cache(maxsize=4)
def _load_net(path: str, device: str) -> LPIPSVGG:
    """The network of one weights file on one device, built once."""
    with np.load(path) as z:
        weights = {k: z[k] for k in z.files}
    return LPIPSVGG(weights).to(device).eval()


def lpips(
    x: torch.Tensor, y: torch.Tensor, net_type: str = "vgg", weights: str | None = None
) -> torch.Tensor:
    """LPIPS distance between [C,H,W] or [B,C,H,W] images in [0,1], on
    their device; returns [B] (reference: lpipsPyTorch/__init__.py:6-19).

    Raises RuntimeError when no weights are available; guard with
    lpips_available(). On the card the convolutions run in f32 with TF32
    off, so the card agrees with the CPU."""
    if net_type != "vgg":
        raise NotImplementedError("gsjax_torch LPIPS supports net_type='vgg'")
    path = weights or lpips_weights_path()
    if path is None:
        raise RuntimeError(
            "LPIPS weights unavailable: set GSJAX_LPIPS_WEIGHTS to an .npz "
            "with conv{i}.w/.b VGG16 weights and lin{i}.w heads"
        )
    if x.ndim == 3:
        x, y = x[None], y[None]
    net = _load_net(os.path.abspath(path), str(x.device))
    with torch.no_grad(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        return net(x.float(), y.float())


def expected_lpips_members() -> dict[str, tuple[int, ...]]:
    """Key -> shape table of the LPIPS weights npz, the byte-level contract
    of gsjax/weights/LPIPS_WEIGHTS_SPEC.md (all members little-endian f32)."""
    shapes: dict[str, tuple[int, ...]] = {}
    idx = 0
    in_ch = 3
    for out_ch, n_convs in _VGG_BLOCKS:
        for _ in range(n_convs):
            shapes[f"conv{idx}.w"] = (out_ch, in_ch, 3, 3)
            shapes[f"conv{idx}.b"] = (out_ch,)
            in_ch = out_ch
            idx += 1
    for i, (out_ch, _) in enumerate(_VGG_BLOCKS):
        shapes[f"lin{i}.w"] = (1, out_ch, 1, 1)
    return shapes


def check_lpips_weights(path: str) -> str:
    """Validate a weights file against the spec; returns its sha256.

    Raises ValueError with every violation listed (missing or extra keys,
    shape or dtype mismatches, non-finite values)."""
    expected = expected_lpips_members()
    errors = []
    with np.load(path) as z:
        for k in sorted(set(expected) - set(z.files)):
            errors.append(f"missing member {k}")
        for k in sorted(set(z.files) - set(expected)):
            errors.append(f"unexpected member {k}")
        for k in sorted(set(expected) & set(z.files)):
            a = z[k]
            if tuple(a.shape) != expected[k]:
                errors.append(f"{k}: shape {tuple(a.shape)} != {expected[k]}")
            if a.dtype != np.float32:
                errors.append(f"{k}: dtype {a.dtype} != float32")
            elif not np.isfinite(a).all():
                errors.append(f"{k}: contains non-finite values")
    if errors:
        raise ValueError(
            f"{path} does not match LPIPS_WEIGHTS_SPEC.md:\n  " + "\n  ".join(errors)
        )
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--check-weights", metavar="PATH",
                    help="validate an LPIPS weights npz against the spec")
    args = ap.parse_args(argv)
    if args.check_weights:
        digest = check_lpips_weights(args.check_weights)
        print(f"OK: {args.check_weights} matches LPIPS_WEIGHTS_SPEC.md")
        print(f"sha256: {digest}")


if __name__ == "__main__":
    main()
