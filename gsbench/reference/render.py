"""Plain rendering of 3D Gaussians, forward and gradients.

The semantics of the published CUDA rasterizer (diff-gaussian-rasterization,
forward.cu preprocessCUDA / renderCUDA), with gsjax's tile rectangle:

* preprocess: view-space point by transformPoint4x3, near cull z > 0.2,
  3D covariance R S S^T R^T, EWA 2D covariance J W Sigma W^T J^T with
  t clamped to 1.3 tan(fov) and +0.3 on the diagonal, conic = its
  inverse (invisible where the determinant is not positive), radius =
  ceil(3 sqrt(lambda_max)) with the discriminant floored at 0.1, pixel
  mean ndc2Pix, SH colour + 0.5 clamped at 0;
* a Gaussian reaches the tiles of its square rectangle
  [int((m - r) / 16), ceil((m + r + 1) / 16)), clamped to the grid, and
  is invisible where that square misses the image;
* per pixel, front to back in depth order (ties in index order):
  alpha = min(0.99, opacity exp(power)) with power = -0.5 d^T conic d,
  skipped where alpha < 1/255 or power > 0; compositing stops before the
  contribution that would take T below 1e-4; colour = sum rgb alpha T +
  T_final bg. The 0.99 cap passes its gradient straight through, as the
  published backward does.

Gradients are autograd's through the same expressions. Work runs in
chunks of tiles of at most `max_elems` (pair, pixel) elements, so memory
stays bounded whatever the scene. The per-pixel colour sum is a matrix
product (TF32 where the caller allows it: the benchmark's control).
"""

from __future__ import annotations

import dataclasses

import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)
NEAR_Z = 0.2
DILATION = 0.3
ALPHA_CAP = 0.99
ALPHA_SKIP = 1.0 / 255.0
T_EPS = 1e-4
TILE = 16
MAX_ELEMS = 1 << 26


@dataclasses.dataclass
class Cam:
    """One view: w2c and proj @ w2c (column-vector, [4,4]), centre [3],
    tangents of the half fields of view (0-d), pixels."""

    view: torch.Tensor
    full_proj: torch.Tensor
    center: torch.Tensor
    tan_fovx: torch.Tensor
    tan_fovy: torch.Tensor
    width: int
    height: int


@dataclasses.dataclass
class Projected:
    mean_pix: torch.Tensor  # [n,2]
    depth: torch.Tensor  # [n]
    conic: torch.Tensor  # [n,3]
    rgb: torch.Tensor  # [n,3]
    opacity: torch.Tensor  # [n]
    radius: torch.Tensor  # [n] float, 0 = invisible


def _row(m: torch.Tensor, i: int, x, y, z) -> torch.Tensor:
    """Row i of a column-vector transform applied to (x, y, z, 1), in the
    published order: m_i0 x + m_i1 y + m_i2 z + m_i3."""
    return m[i, 0] * x + m[i, 1] * y + m[i, 2] * z + m[i, 3]


def sh_colour(sh: torch.Tensor, xyz: torch.Tensor, center: torch.Tensor,
              degree: int) -> torch.Tensor:
    """computeColorFromSH: [n,3] colour toward the camera, + 0.5, >= 0."""
    d = xyz - center[None, :]
    d = d / torch.sqrt(torch.sum(d * d, dim=-1, keepdim=True)).clamp(min=1e-12)
    x, y, z = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    c = SH_C0 * sh[:, 0]
    if degree > 0:
        c = c - SH_C1 * y * sh[:, 1] + SH_C1 * z * sh[:, 2] - SH_C1 * x * sh[:, 3]
    if degree > 1:
        xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
        c = (c + SH_C2[0] * xy * sh[:, 4] + SH_C2[1] * yz * sh[:, 5]
             + SH_C2[2] * (2.0 * zz - xx - yy) * sh[:, 6] + SH_C2[3] * xz * sh[:, 7]
             + SH_C2[4] * (xx - yy) * sh[:, 8])
        if degree > 2:
            c = (c + SH_C3[0] * y * (3.0 * xx - yy) * sh[:, 9]
                 + SH_C3[1] * xy * z * sh[:, 10]
                 + SH_C3[2] * y * (4.0 * zz - xx - yy) * sh[:, 11]
                 + SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy) * sh[:, 12]
                 + SH_C3[4] * x * (4.0 * zz - xx - yy) * sh[:, 13]
                 + SH_C3[5] * z * (xx - yy) * sh[:, 14]
                 + SH_C3[6] * x * (xx - 3.0 * yy) * sh[:, 15])
    return torch.clamp(c + 0.5, min=0.0)


def covariance3d(log_scale: torch.Tensor, quat: torch.Tensor) -> torch.Tensor:
    """computeCov3D: [n,3,3] R S S^T R^T of exp(log_scale) and the
    normalized quaternion (w, x, y, z)."""
    q = quat / torch.sqrt(torch.sum(quat * quat, dim=-1, keepdim=True))
    r, x, y, z = q.unbind(-1)
    rot = torch.stack([
        1.0 - 2.0 * (y * y + z * z), 2.0 * (x * y - r * z), 2.0 * (x * z + r * y),
        2.0 * (x * y + r * z), 1.0 - 2.0 * (x * x + z * z), 2.0 * (y * z - r * x),
        2.0 * (x * z - r * y), 2.0 * (y * z + r * x), 1.0 - 2.0 * (x * x + y * y),
    ], dim=-1).reshape(-1, 3, 3)
    m = rot * torch.exp(log_scale)[:, None, :]
    return m @ m.transpose(1, 2)


def preprocess(params: dict, cam: Cam, degree: int) -> Projected:
    """Per-Gaussian screen-space quantities of raw parameters
    (xyz, features_dc, features_rest, scaling (log), rotation, opacity
    (logit)), differentiable in them."""
    xyz = params["xyz"]
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    tx, ty, tz = (_row(cam.view, i, x, y, z) for i in range(3))
    hx, hy, _, hw = (_row(cam.full_proj, i, x, y, z) for i in range(4))
    inv_w = 1.0 / (hw + 1e-7)
    mean_pix = torch.stack([((hx * inv_w + 1.0) * cam.width - 1.0) * 0.5,
                            ((hy * inv_w + 1.0) * cam.height - 1.0) * 0.5], dim=-1)

    cov = covariance3d(params["scaling"], params["rotation"])
    focal_x = torch.div(torch.full_like(cam.tan_fovx, float(cam.width)), 2.0 * cam.tan_fovx)
    focal_y = torch.div(torch.full_like(cam.tan_fovy, float(cam.height)), 2.0 * cam.tan_fovy)
    limx, limy = 1.3 * cam.tan_fovx, 1.3 * cam.tan_fovy
    tz_s = torch.where(tz.abs() < 1e-6, torch.full_like(tz, 1e-6), tz)
    cx = torch.minimum(torch.maximum(tx / tz_s, -limx), limx) * tz_s
    cy = torch.minimum(torch.maximum(ty / tz_s, -limy), limy) * tz_s
    zero = torch.zeros_like(tz_s)
    jac = torch.stack([
        torch.stack([focal_x / tz_s, zero, -(focal_x * cx) / (tz_s * tz_s)], -1),
        torch.stack([zero, focal_y / tz_s, -(focal_y * cy) / (tz_s * tz_s)], -1),
    ], dim=1)  # [n,2,3]
    t = jac @ cam.view[:3, :3]
    cov2 = t @ cov @ t.transpose(1, 2)
    a = cov2[:, 0, 0] + DILATION
    b = cov2[:, 0, 1]
    c = cov2[:, 1, 1] + DILATION
    det = a * c - b * b
    ok = det > 0.0
    inv = 1.0 / torch.where(ok, det, torch.ones_like(det))
    conic = torch.stack([c * inv, -b * inv, a * inv], dim=-1)
    mid = 0.5 * (a + c)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp(lam, min=0.0))).detach()

    sh = torch.cat([params["features_dc"], params["features_rest"]], dim=1)
    rgb = sh_colour(sh, xyz, cam.center, degree)
    opacity = torch.sigmoid(params["opacity"]).reshape(-1)

    mp = mean_pix.detach()
    visible = ((tz > NEAR_Z) & ok & (mp[:, 0] + radius >= 0) & (mp[:, 0] - radius < cam.width)
               & (mp[:, 1] + radius >= 0) & (mp[:, 1] - radius < cam.height))
    radius = torch.where(visible, radius, torch.zeros_like(radius))
    return Projected(mean_pix=mean_pix, depth=tz, conic=conic, rgb=rgb,
                     opacity=opacity, radius=radius)


@dataclasses.dataclass
class Bins:
    """(Gaussian, tile) pairs sorted by tile, then depth: gauss [P], and
    per tile its count and first pair."""

    gauss: torch.Tensor
    count: torch.Tensor
    start: torch.Tensor
    tiles_x: int
    tiles_y: int


def bin_pairs(proj: Projected, width: int, height: int) -> Bins:
    dev = proj.depth.device
    tiles_x, tiles_y = -(-width // TILE), -(-height // TILE)
    ids = torch.nonzero(proj.radius > 0).squeeze(1)
    mp = proj.mean_pix.detach()[ids]
    r = proj.radius[ids]
    x0 = torch.clamp((mp[:, 0] - r) / TILE, 0, tiles_x).to(torch.int64)
    y0 = torch.clamp((mp[:, 1] - r) / TILE, 0, tiles_y).to(torch.int64)
    x1 = torch.clamp(torch.ceil((mp[:, 0] + r + 1.0) / TILE), 0, tiles_x).to(torch.int64)
    y1 = torch.clamp(torch.ceil((mp[:, 1] + r + 1.0) / TILE), 0, tiles_y).to(torch.int64)
    w = (x1 - x0).clamp(min=0)
    n = w * (y1 - y0).clamp(min=0)
    # Depth rank of each visible Gaussian (stable: ties in index order).
    rank = torch.empty_like(ids)
    rank[torch.sort(proj.depth.detach()[ids], stable=True).indices] = torch.arange(
        ids.numel(), device=dev)
    owner = torch.repeat_interleave(torch.arange(ids.numel(), device=dev), n)
    first = torch.cumsum(n, 0) - n
    local = torch.arange(owner.numel(), device=dev) - first[owner]
    wo = w[owner]
    tile = (y0[owner] + local // wo) * tiles_x + x0[owner] + local % wo
    order = torch.sort(tile * ids.numel() + rank[owner]).indices
    count = torch.bincount(tile, minlength=tiles_x * tiles_y)
    return Bins(gauss=ids[owner[order]], count=count, start=torch.cumsum(count, 0) - count,
                tiles_x=tiles_x, tiles_y=tiles_y)


def chunks(bins: Bins, max_elems: int = MAX_ELEMS) -> list[tuple[torch.Tensor, int]]:
    """Tiles grouped (most pairs first) into chunks of (tile ids, K) with
    tiles x K x pixels at most max_elems."""
    counts = bins.count.cpu()
    order = torch.sort(counts, descending=True, stable=True).indices
    out, i, n = [], 0, int((counts > 0).sum())
    pix = TILE * TILE
    while i < n:
        k = int(counts[order[i]])
        m = max(1, min(n - i, max_elems // max(1, k * pix)))
        out.append((order[i:i + m].to(bins.count.device), k))
        i += m
    return out


def _fields(proj: Projected) -> torch.Tensor:
    """[n+1, 9] (mean x, y, conic a, b, c, r, g, b, opacity); the last row
    is a pad whose opacity 0 composites nothing."""
    f = torch.cat([proj.mean_pix, proj.conic, proj.rgb, proj.opacity[:, None]], dim=-1)
    return torch.cat([f, torch.zeros_like(f[:1])])


def composite_chunk(fields: torch.Tensor, bins: Bins, tiles: torch.Tensor, k: int,
                    bg: torch.Tensor, width: int, height: int, count: bool = False):
    """Colour [t, 256, 3] of `tiles` (each with at most k pairs) and, with
    `count`, the live (Gaussian, pixel) pairs and the (Gaussian, tile)
    pairs that reach a pixel not done yet, in-image pixels only."""
    dev = fields.device
    pad = fields.shape[0] - 1
    slot = torch.arange(k, device=dev)
    n = bins.count[tiles]
    at = (bins.start[tiles][:, None] + slot[None, :]).clamp(max=bins.gauss.numel() - 1)
    g = torch.where(slot[None, :] < n[:, None], bins.gauss[at], pad)
    f = fields[g]  # [t,k,9]
    p = torch.arange(TILE * TILE, device=dev)
    px = ((tiles % bins.tiles_x)[:, None] * TILE + p % TILE).to(torch.float32)
    py = ((tiles // bins.tiles_x)[:, None] * TILE + p // TILE).to(torch.float32)
    dx = f[..., 0:1] - px[:, None, :]
    dy = f[..., 1:2] - py[:, None, :]
    power = -0.5 * (f[..., 2:3] * dx * dx + f[..., 4:5] * dy * dy) - f[..., 3:4] * dx * dy
    raw = f[..., 8:9] * torch.exp(power)
    alpha = raw + (torch.clamp(raw, max=ALPHA_CAP) - raw).detach()
    keep = (power <= 0.0) & (alpha.detach() >= ALPHA_SKIP)
    alpha = torch.where(keep, alpha, torch.zeros_like(alpha))
    om = 1.0 - alpha
    t_in = torch.cumprod(om, dim=1)
    live = (t_in >= T_EPS).detach()
    t_ex = torch.cat([torch.ones_like(t_in[:, :1]), t_in[:, :-1]], dim=1)
    w = alpha * t_ex * live
    colour = w.transpose(1, 2) @ f[..., 5:8]  # [t,256,3]
    t_final = torch.prod(torch.where(live, om, torch.ones_like(om)), dim=1)
    out = colour + t_final[..., None] * bg
    if not count:
        return out
    inside = ((px < width) & (py < height))[:, None, :]
    real = slot[None, :] < n[:, None]
    n_live = int(((w.detach() > 0) & inside).sum())
    # A pair has to be read where it reaches (alpha >= 1/255) a pixel of
    # its tile that is not done yet.
    n_read = int(((keep & (t_ex.detach() >= T_EPS) & inside).any(dim=2) & real).sum())
    return out, n_live, n_read


def untile(tiles: torch.Tensor, bins: Bins, width: int, height: int) -> torch.Tensor:
    """[T, 256, 3] -> [3, H, W]."""
    c = tiles.reshape(bins.tiles_y, bins.tiles_x, TILE, TILE, 3)
    c = c.permute(4, 0, 2, 1, 3).reshape(3, bins.tiles_y * TILE, bins.tiles_x * TILE)
    return c[:, :height, :width]


def tile_image(img: torch.Tensor, bins: Bins) -> torch.Tensor:
    """[3, H, W] -> [T, 256, 3] (zero past the image)."""
    h, w = img.shape[1:]
    full = torch.zeros((3, bins.tiles_y * TILE, bins.tiles_x * TILE), device=img.device)
    full[:, :h, :w] = img
    return full.reshape(3, bins.tiles_y, TILE, bins.tiles_x, TILE).permute(
        1, 3, 2, 4, 0).reshape(-1, TILE * TILE, 3)


@dataclasses.dataclass
class Frame:
    image: torch.Tensor  # [3,H,W]
    live_pairs: int  # (Gaussian, pixel) pairs that contributed
    tile_pairs: int  # (Gaussian, tile) pairs that reach a pixel not done yet
    visible: int  # Gaussians with a tile


@torch.no_grad()
def render(params: dict, cam: Cam, bg: torch.Tensor, degree: int,
           max_elems: int = MAX_ELEMS) -> Frame:
    """One view, no gradients, with its pair counts."""
    proj = preprocess(params, cam, degree)
    bins = bin_pairs(proj, cam.width, cam.height)
    fields = _fields(proj)
    out = bg[None, None, :].expand(bins.count.numel(), TILE * TILE, 3).clone()
    live = pairs = 0
    for tiles, k in chunks(bins, max_elems):
        out[tiles], n_live, n_pairs = composite_chunk(fields, bins, tiles, k, bg, cam.width,
                                                      cam.height, count=True)
        live += n_live
        pairs += n_pairs
    return Frame(untile(out, bins, cam.width, cam.height), live, pairs,
                 int((proj.radius > 0).sum()))


def backward(params: dict, cam: Cam, bg: torch.Tensor, degree: int,
             grad_image: torch.Tensor, max_elems: int = MAX_ELEMS) -> None:
    """Accumulate into params[*].grad the gradient of <image, grad_image>:
    the tiles are composited again with gradients, chunk by chunk, into
    the screen-space fields, then through the preprocess."""
    proj = preprocess(params, cam, degree)
    bins = bin_pairs(proj, cam.width, cam.height)
    fields = _fields(proj)
    leaf = fields.detach().requires_grad_(True)
    g_tiles = tile_image(grad_image, bins)
    for tiles, k in chunks(bins, max_elems):
        out = composite_chunk(leaf, bins, tiles, k, bg, cam.width, cam.height)
        torch.autograd.backward(out, g_tiles[tiles])
    if leaf.grad is not None:
        torch.autograd.backward(fields, leaf.grad)
