"""Operations and bytes of the work a view or a training step needs, from
its inputs, whatever implements it; and the chip's peaks.

Counts are of what these inputs need (live pairs, visible Gaussians,
pixels), not of what a kernel happens to do: a kernel that does less
useless work reads as closer to its roofline. Each constant names its
source.
"""

from __future__ import annotations

# --- peaks: NVIDIA H100 SXM5 data sheet, at its 700 W power limit (also
# chip_smoke.py:197-207, the port's own roofline constants).
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12  # float32 outside the tensor cores

# --- compositing, per live (Gaussian, pixel) pair: chip_smoke.py:197-207.
# Forward: the power (a quadratic form, 9), exp and opacity (2), the
# transmittance and colour updates (2 more than the 3 FMAs counted in 9 +
# 2). Backward: the published backward's per-pair arithmetic.
COMPOSITE_FLOP_PER_PAIR = 13
BACKWARD_FLOP_PER_LIVE_PAIR = 43

# A (Gaussian, tile) pair that reaches (alpha >= 1/255) a pixel of its
# tile not done yet (the pairs a walk that ends early must read) brings
# the Gaussian's nine float32 screen fields (mean 2, conic 3, colour 3,
# opacity 1) to the tile; a pixel leaves its colour and final
# transmittance (4 floats) in the forward, and brings its colour gradient
# and final transmittance (4 floats) to the backward, which leaves nine
# gradient floats per visible Gaussian.
FIELD_BYTES = 9 * 4
PIXEL_FWD_OUT_BYTES = 4 * 4
PIXEL_BWD_IN_BYTES = 4 * 4
GAUSSIAN_BWD_OUT_BYTES = 9 * 4

# --- per-Gaussian preprocess, forward, counted from the published
# forward.cu (preprocessCUDA): transformPoint4x3 and 4x4 with the
# perspective divide 47; computeCov3D (quaternion normalize, rotation,
# S R, M^T M, the scale exp) 84; computeCov2D (clamps, J, W J, T Sigma
# T^T, dilation) 95; conic, eigenvalue and radius 20; ndc2Pix and the
# rectangle 18; computeColorFromSH at degree 3 (direction 12, basis 30,
# 16 x 3 multiply-adds 96, offset and clamp 6) 144; sigmoid 4.
PREPROCESS_FLOP_PER_GAUSSIAN = 47 + 84 + 95 + 20 + 18 + 144 + 4
# Its backward: twice the forward, the usual ratio of a reverse pass over
# elementwise arithmetic (each operation's two partials; Griewank &
# Walther, Evaluating Derivatives, 2008, the cheap-gradient bound).
PREPROCESS_BWD_FLOP_PER_GAUSSIAN = 2 * PREPROCESS_FLOP_PER_GAUSSIAN

# --- loss, per channel-pixel (published utils/loss_utils.py): L1 3
# forward, 2 backward; SSIM forward 5 maps blurred by a separable 11-tap
# window (5 x 2 x 11 x 2 = 220) and the map (20); its backward three
# more blurs (132) and 30 elementwise.
LOSS_FLOP_PER_CHANNEL_PIXEL = 3 + 2 + 220 + 20 + 132 + 30

# --- Adam, per parameter element (torch.optim.Adam): two moment updates
# (3 + 4), two bias corrections (2), sqrt, eps, quotient, rate and
# update (5).
ADAM_FLOP_PER_ELEMENT = 14
PARAM_FLOATS_PER_GAUSSIAN = 3 + 3 + 45 + 3 + 4 + 1  # xyz, dc, rest (SH 3), scale, rot, opacity


def composite_forward(tile_pairs: int, live_pairs: int, pixels: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one view's compositing."""
    return (COMPOSITE_FLOP_PER_PAIR * live_pairs,
            FIELD_BYTES * tile_pairs + PIXEL_FWD_OUT_BYTES * pixels)


def composite_backward(tile_pairs: int, live_pairs: int, pixels: int,
                       visible: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one view's compositing backward."""
    return (BACKWARD_FLOP_PER_LIVE_PAIR * live_pairs,
            FIELD_BYTES * tile_pairs + PIXEL_BWD_IN_BYTES * pixels
            + GAUSSIAN_BWD_OUT_BYTES * visible)


def roofline_s(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the two bounds."""
    return max(flops / F32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S)


def view_flops(gaussians: int, live_pairs: int, pixels: int) -> float:
    """One exact forward: every Gaussian preprocessed, the live pairs
    composited."""
    return (PREPROCESS_FLOP_PER_GAUSSIAN * gaussians
            + COMPOSITE_FLOP_PER_PAIR * live_pairs)


def step_flops(gaussians: int, live_pairs: int, pixels: int) -> float:
    """One training step on one view: the forward, the loss and its
    gradient, the backward through compositing and preprocess, and Adam
    over every parameter."""
    return (view_flops(gaussians, live_pairs, pixels)
            + 3 * pixels * LOSS_FLOP_PER_CHANNEL_PIXEL
            + BACKWARD_FLOP_PER_LIVE_PAIR * live_pairs
            + PREPROCESS_BWD_FLOP_PER_GAUSSIAN * gaussians
            + ADAM_FLOP_PER_ELEMENT * PARAM_FLOATS_PER_GAUSSIAN * gaussians)
