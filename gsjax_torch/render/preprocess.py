"""Per-Gaussian view preprocessing: frustum cull, projection, EWA splat,
conic + screen extents, SH -> RGB.

The same scalar-expanded formulas, in the same order, as
`gsjax.render.preprocess`: Sigma2D = J W Sigma3D W^T J^T + 0.3 I,
conic = Sigma2D^{-1}, radius = ceil(3 sqrt(max eigenvalue)), plus the tight
per-axis extent `ext` and alpha-threshold level `qmax` that binning uses:
  qmax = 2 ln(255 * opacity)         (alpha >= 1/255  <=>  d^T conic d <= qmax)
  ext  = min(sqrt(qmax * Sigma2D_diag), 3 sigma_max)   per axis
"""

from __future__ import annotations

import dataclasses

import torch

from gsjax_torch.core.cameras import Camera, ndc_to_pixel
from gsjax_torch.core.sh import eval_sh
from gsjax_torch.render.common import ALPHA_SKIP

# Near-plane cull threshold used by the CUDA rasterizer's in_frustum test.
NEAR_CULL_Z = 0.2
# Low-pass dilation ensuring every splat covers >= ~1px (EWA antialias term).
COV2D_DILATION = 0.3


@dataclasses.dataclass
class Projected:
    """Per-Gaussian screen-space quantities (capacity-sized, masked).

    mean_ndc: [N,2] x/y in NDC (carries the screen-space gradient).
    mean_pix: [N,2] continuous pixel coords.
    depth: [N] view-space z.
    conic: [N,3] inverse 2D covariance (a, b, c).
    rgb: [N,3] SH-evaluated color (clamped >= 0).
    opacity: [N] activated opacity.
    radius: [N] int32 screen radius in pixels; 0 == culled/invisible.
    ext: [N,2] tight per-axis pixel extents (no grad; 0 = no coverage).
    qmax: [N] alpha-threshold level 2 ln(255 op) (no grad).
    """

    mean_ndc: torch.Tensor
    mean_pix: torch.Tensor
    depth: torch.Tensor
    conic: torch.Tensor
    rgb: torch.Tensor
    opacity: torch.Tensor
    radius: torch.Tensor
    ext: torch.Tensor
    qmax: torch.Tensor


def project_points(
    xyz: torch.Tensor, camera: Camera
) -> tuple[torch.Tensor, torch.Tensor]:
    """Project world points. Returns (ndc [N,3], view-space point [N,3])."""
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]

    def apply4(m):
        return [m[i, 0] * x + m[i, 1] * y + m[i, 2] * z + m[i, 3] for i in range(4)]

    vx, vy, vz, _ = apply4(camera.view)
    hx, hy, hz, hw = apply4(camera.full_proj)
    inv_w = 1.0 / (hw + 1e-7)
    ndc = torch.stack([hx * inv_w, hy * inv_w, hz * inv_w], dim=-1)
    p_view = torch.stack([vx, vy, vz], dim=-1)
    return ndc, p_view


def compute_cov3d_elems(
    scaling: torch.Tensor, scaling_modifier: float, rotation: torch.Tensor
) -> tuple[torch.Tensor, ...]:
    """Sigma3D = R diag(s^2) R^T as six [N] vectors (xx, xy, xz, yy, yz, zz)
    (reference: scene/gaussian_model.py:26-31, utils/general_utils.py:78-110)."""
    qn = rotation / torch.sqrt(
        torch.sum(rotation * rotation, dim=-1, keepdim=True)
    )
    r, x, y, z = qn[:, 0], qn[:, 1], qn[:, 2], qn[:, 3]
    s = scaling * scaling_modifier
    s0, s1, s2 = s[:, 0] ** 2, s[:, 1] ** 2, s[:, 2] ** 2

    r00 = 1.0 - 2.0 * (y * y + z * z)
    r01 = 2.0 * (x * y - r * z)
    r02 = 2.0 * (x * z + r * y)
    r10 = 2.0 * (x * y + r * z)
    r11 = 1.0 - 2.0 * (x * x + z * z)
    r12 = 2.0 * (y * z - r * x)
    r20 = 2.0 * (x * z - r * y)
    r21 = 2.0 * (y * z + r * x)
    r22 = 1.0 - 2.0 * (x * x + y * y)

    # Sigma_ij = sum_k R_ik R_jk s_k^2.
    c_xx = r00 * r00 * s0 + r01 * r01 * s1 + r02 * r02 * s2
    c_xy = r00 * r10 * s0 + r01 * r11 * s1 + r02 * r12 * s2
    c_xz = r00 * r20 * s0 + r01 * r21 * s1 + r02 * r22 * s2
    c_yy = r10 * r10 * s0 + r11 * r11 * s1 + r12 * r12 * s2
    c_yz = r10 * r20 * s0 + r11 * r21 * s1 + r12 * r22 * s2
    c_zz = r20 * r20 * s0 + r21 * r21 * s1 + r22 * r22 * s2
    return c_xx, c_xy, c_xz, c_yy, c_yz, c_zz


def compute_cov2d(
    cov3d6: torch.Tensor, p_view: torch.Tensor, camera: Camera
) -> torch.Tensor:
    """EWA projection of [N,6] 3D covariances (xx, xy, xz, yy, yz, zz) at
    the view-space points p_view [N,3] to screen space: [N,3] = (cov_xx,
    cov_xy, cov_yy), dilated by +0.3 on the diagonal, as the CUDA
    rasterizer's computeCov2D."""
    return _cov2d_from_elems(tuple(cov3d6[:, i] for i in range(6)), p_view, camera)


def _cov2d_from_elems(
    elems: tuple[torch.Tensor, ...], p_view: torch.Tensor, camera: Camera
) -> torch.Tensor:
    """EWA projection of the 3D covariance elements (xx, xy, xz, yy, yz,
    zz) to screen space: [N,3] = (cov_xx, cov_xy, cov_yy), dilated by +0.3
    on the diagonal."""
    c_xx, c_xy, c_xz, c_yy, c_yz, c_zz = elems
    tz = p_view[:, 2]
    tz_safe = torch.where(tz.abs() < 1e-6, torch.full_like(tz, 1e-6), tz)
    limx = 1.3 * camera.tan_fovx
    limy = 1.3 * camera.tan_fovy
    txtz = torch.minimum(torch.maximum(p_view[:, 0] / tz_safe, -limx), limx)
    tytz = torch.minimum(torch.maximum(p_view[:, 1] / tz_safe, -limy), limy)
    tx = txtz * tz_safe
    ty = tytz * tz_safe

    inv_z = 1.0 / tz_safe
    a0 = camera.focal_x * inv_z
    a2 = -camera.focal_x * tx * inv_z * inv_z
    b1 = camera.focal_y * inv_z
    b2 = -camera.focal_y * ty * inv_z * inv_z

    # M = J @ W: row0 = a0 * W0 + a2 * W2, row1 = b1 * W1 + b2 * W2.
    W = camera.view[:3, :3]
    m00 = a0 * W[0, 0] + a2 * W[2, 0]
    m01 = a0 * W[0, 1] + a2 * W[2, 1]
    m02 = a0 * W[0, 2] + a2 * W[2, 2]
    m10 = b1 * W[1, 0] + b2 * W[2, 0]
    m11 = b1 * W[1, 1] + b2 * W[2, 1]
    m12 = b1 * W[1, 2] + b2 * W[2, 2]

    def sig_dot(mx, my, mz):
        return (
            c_xx * mx + c_xy * my + c_xz * mz,
            c_xy * mx + c_yy * my + c_yz * mz,
            c_xz * mx + c_yz * my + c_zz * mz,
        )

    s0x, s0y, s0z = sig_dot(m00, m01, m02)
    s1x, s1y, s1z = sig_dot(m10, m11, m12)
    v_xx = m00 * s0x + m01 * s0y + m02 * s0z + COV2D_DILATION
    v_xy = m00 * s1x + m01 * s1y + m02 * s1z
    v_yy = m10 * s1x + m11 * s1y + m12 * s1z + COV2D_DILATION
    return torch.stack([v_xx, v_xy, v_yy], dim=-1)


def conic_and_radius(
    cov2d: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Invert the 2x2 covariance and bound the splat extent.

    Returns (conic [N,3], radius_f [N] float, valid [N] bool) with
    radius = ceil(3 * sqrt(lambda_max)), the 99.7% extent.
    """
    det = cov2d[:, 0] * cov2d[:, 2] - cov2d[:, 1] * cov2d[:, 1]
    valid = det > 0.0
    det_safe = torch.where(valid, det, torch.ones_like(det))
    inv_det = 1.0 / det_safe
    conic = torch.stack(
        [cov2d[:, 2] * inv_det, -cov2d[:, 1] * inv_det, cov2d[:, 0] * inv_det],
        dim=-1,
    )
    mid = 0.5 * (cov2d[:, 0] + cov2d[:, 2])
    disc = torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    lambda_max = mid + disc
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp(lambda_max, min=0.0)))
    return conic, radius, valid


def sh_to_rgb(
    sh: torch.Tensor, xyz: torch.Tensor, cam_center: torch.Tensor,
    active_degree: int,
) -> torch.Tensor:
    """Per-Gaussian view-dependent color, clamped at 0
    (reference: gaussian_renderer/__init__.py:72-78)."""
    dirs = xyz - cam_center[None, :]
    norm = torch.sqrt(torch.sum(dirs * dirs, dim=-1, keepdim=True))
    dirs = dirs / norm.clamp(min=1e-12)
    rgb = eval_sh(active_degree, sh, dirs) + 0.5
    return torch.clamp(rgb, min=0.0)


def preprocess(
    xyz: torch.Tensor,
    sh: torch.Tensor,
    opacity: torch.Tensor,
    scaling: torch.Tensor,
    rotation: torch.Tensor,
    camera: Camera,
    active_sh_degree: int,
    scaling_modifier: float = 1.0,
    mean2d_offset: torch.Tensor | None = None,
    alive: torch.Tensor | None = None,
    cov3d_precomp: torch.Tensor | None = None,
    rgb_precomp: torch.Tensor | None = None,
) -> Projected:
    """Run the full preprocess stage for one camera.

    Args:
      xyz: [N,3] positions.
      sh: [N,K,3] SH coefficients (dc + rest).
      opacity: [N] or [N,1] activated (post-sigmoid) opacity.
      scaling: [N,3] activated (post-exp) scales.
      rotation: [N,4] raw quaternions (normalized here).
      camera: target view, on the same device as the tensors.
      active_sh_degree: current SH degree.
      scaling_modifier: global scale multiplier.
      mean2d_offset: [N,2] zeros added in NDC; its gradient is the
        screen-space gradient densification reads.
      alive: [N] bool mask for capacity slots; dead rows get radius 0.
      cov3d_precomp: optional [N,6] covariance override.
      rgb_precomp: optional [N,3] color override.
    """
    ndc, p_view = project_points(xyz, camera)
    depth = p_view[:, 2]
    in_front = depth > NEAR_CULL_Z

    if cov3d_precomp is None:
        cov3d_elems = compute_cov3d_elems(scaling, scaling_modifier, rotation)
    else:
        cov3d_elems = tuple(cov3d_precomp[:, i] for i in range(6))
    cov2d = _cov2d_from_elems(cov3d_elems, p_view, camera)
    conic, radius_f, det_ok = conic_and_radius(cov2d)

    mean_ndc = ndc[:, :2]
    if mean2d_offset is not None:
        mean_ndc = mean_ndc + mean2d_offset
    # Filled on the device, not copied from the host: a CUDA graph cannot
    # capture a copy from pageable memory.
    size = torch.full((2,), float(camera.width), dtype=torch.float32,
                      device=xyz.device)
    size[1:].fill_(camera.height)
    mean_pix = ndc_to_pixel(mean_ndc, size[None, :])

    if rgb_precomp is None:
        rgb = sh_to_rgb(sh, xyz, camera.cam_center, active_sh_degree)
    else:
        rgb = rgb_precomp

    visible = in_front & det_ok
    if alive is not None:
        visible = visible & alive
    zero = torch.zeros_like(radius_f)
    radius = torch.where(visible, radius_f, zero)
    # Zero-radius Gaussians touch no tiles; also zero when the splat's
    # bounding square misses the image entirely.
    mp = mean_pix.detach()
    on_screen = (
        (mp[:, 0] + radius >= 0)
        & (mp[:, 0] - radius < camera.width)
        & (mp[:, 1] + radius >= 0)
        & (mp[:, 1] - radius < camera.height)
    )
    radius = torch.where(on_screen, radius, zero)
    radius_i = radius.detach().to(torch.int32)

    opacity = opacity.reshape(-1)

    # Tight per-axis extents (no grad; binning bookkeeping only): the
    # sublevel set {d : d^T conic d <= qmax} has max |dx| = sqrt(qmax *
    # Sigma_xx), intersected with the reference's 3-sigma square.
    op_sg = opacity.detach()
    qmax = 2.0 * torch.log(torch.clamp(255.0 * op_sg, min=1e-6))
    qmax = torch.clamp(qmax, min=0.0)  # <=0 means no pixel can pass the skip
    cov_sg = cov2d.detach()
    ex = torch.sqrt(torch.clamp(qmax * cov_sg[:, 0], min=0.0))
    ey = torch.sqrt(torch.clamp(qmax * cov_sg[:, 2], min=0.0))
    covered = (op_sg >= ALPHA_SKIP) & (radius > 0.0)
    ext = torch.stack(
        [
            torch.where(covered, torch.minimum(ex, radius), zero),
            torch.where(covered, torch.minimum(ey, radius), zero),
        ],
        dim=-1,
    )

    return Projected(
        mean_ndc=mean_ndc,
        mean_pix=mean_pix,
        depth=depth,
        conic=conic,
        rgb=rgb,
        opacity=opacity,
        radius=radius_i,
        ext=ext.detach(),
        qmax=qmax,
    )
