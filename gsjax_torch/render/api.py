"""Public render API — the counterpart of the reference's
`render(viewpoint_camera, pc, pipe, bg_color, scaling_modifier,
override_color)` (reference: gaussian_renderer/__init__.py:18-100).

`render` runs on the device its inputs lie on: on a CUDA device every
kernel of the path is the hand-written one (render/kernels.py), on the CPU
their plain versions run.
"""

from __future__ import annotations

import dataclasses

import torch

from gsjax_torch.config import RasterConfig
from gsjax_torch.core.cameras import Camera
from gsjax_torch.core.transforms import build_covariance
from gsjax_torch.model import GaussianParams
from gsjax_torch.render.binning import (
    Binning,
    bin_gaussians,
    depth_order,
    num_tiles,
    permute_rows,
)
from gsjax_torch.render.common import untile_image
from gsjax_torch.render.composite import CompositeStatic, composite, pack_fields
from gsjax_torch.render.oracle import composite_oracle
from gsjax_torch.render.preprocess import (
    NEAR_CULL_Z,
    Projected,
    preprocess,
    project_points,
    sh_to_rgb,
)


@dataclasses.dataclass
class RenderOutput:
    """image: [3,H,W]; radii: [N] int32 (0 = invisible); num_instances /
    num_rows: true (gaussian, tile) pair and (gaussian, tile-row) run counts
    (above cfg.max_instances / cfg.max_rows, work was dropped
    deepest-first)."""

    image: torch.Tensor
    radii: torch.Tensor
    num_instances: torch.Tensor
    num_rows: torch.Tensor

    @property
    def visibility_filter(self) -> torch.Tensor:
        return self.radii > 0


def depth_sorted_bins(
    proj: Projected, camera: Camera, cfg: RasterConfig
) -> tuple[torch.Tensor, Binning]:
    """The composite's [N, 9] fields in depth order and the frame's
    binning. One N-rate depth permute serves both consumers: columns 0..8
    are the composite fields (pack_fields layout), 9..11 binning's
    ext/qmax."""
    perm = depth_order(proj.depth)
    fields12 = torch.cat(
        [
            pack_fields(proj.mean_pix, proj.conic, proj.rgb, proj.opacity),
            proj.ext,
            proj.qmax[:, None],
        ],
        dim=-1,
    )
    f12 = permute_rows(fields12, perm)
    binning = bin_gaussians(
        f12[:, 0:2],
        proj.depth,
        f12[:, 9:11],
        f12[:, 2:5],
        f12[:, 11],
        camera.height,
        camera.width,
        cfg,
        perm=perm,
    )
    return f12[:, 0:9], binning


def _check_devices(params: GaussianParams, camera: Camera, **optional) -> None:
    dev = params.device
    others = {"camera": camera.device}
    others.update({k: v.device for k, v in optional.items() if v is not None})
    wrong = {k: d for k, d in others.items() if d != dev}
    if wrong:
        raise ValueError(f"inputs must lie on the params' device {dev}: {wrong}")


def render(
    params: GaussianParams,
    camera: Camera,
    *,
    active_sh_degree: int,
    bg_color: torch.Tensor,
    cfg: RasterConfig = RasterConfig(),
    scaling_modifier: float = 1.0,
    mean2d_offset: torch.Tensor | None = None,
    alive: torch.Tensor | None = None,
    override_color: torch.Tensor | None = None,
    compute_cov3d_outside: bool = False,
    convert_shs_outside: bool = False,
) -> RenderOutput:
    """Render one view, on the device of `params`.

    Args:
      params: the scene (capacity-padded raw parameters).
      camera: target view.
      active_sh_degree: current SH degree.
      bg_color: [3] background composited under residual transmittance.
      cfg: rasterizer configuration.
      scaling_modifier: global scale multiplier (viewer slider).
      mean2d_offset: optional [C,2] zeros carrying the NDC screen-space
        position gradient.
      alive: [C] bool mask; None = all alive.
      override_color: optional [C,3] color override.
      compute_cov3d_outside / convert_shs_outside: run covariance / SH->RGB
        through the standalone paths (reference `--compute_cov3D_python` /
        `--convert_SHs_python`).
    """
    _check_devices(
        params, camera, bg_color=bg_color, mean2d_offset=mean2d_offset,
        alive=alive, override_color=override_color,
    )
    cov3d = None
    if compute_cov3d_outside:
        cov3d = build_covariance(
            params.get_scaling(), scaling_modifier, params.rotation
        )
    rgb_pre = override_color
    if rgb_pre is None and convert_shs_outside:
        rgb_pre = sh_to_rgb(
            params.get_features(), params.xyz, camera.cam_center, active_sh_degree
        )

    proj = preprocess(
        xyz=params.xyz,
        sh=params.get_features(),
        opacity=params.get_opacity(),
        scaling=params.get_scaling(),
        rotation=params.rotation,
        camera=camera,
        active_sh_degree=active_sh_degree,
        scaling_modifier=scaling_modifier,
        mean2d_offset=mean2d_offset,
        alive=alive,
        cov3d_precomp=cov3d,
        rgb_precomp=rgb_pre,
    )

    fields, binning = depth_sorted_bins(proj, camera, cfg)

    tiles_x, tiles_y = num_tiles(camera.height, camera.width, cfg.tw, cfg.th)
    static = CompositeStatic(
        n_tiles=tiles_x * tiles_y,
        tiles_x=tiles_x,
        tile_w=cfg.tw,
        tile_h=cfg.th,
        chunk=cfg.chunk,
        strips=cfg.strips,
        fast_fwd=cfg.fast_fwd,
    )
    tile_color, tile_t = composite(fields, binning, static)
    color, transmittance = untile_image(
        tile_color, tile_t, camera.height, camera.width, tiles_x, tiles_y,
        cfg.tw, cfg.th,
    )
    image = color + transmittance[None, :, :] * bg_color[:, None, None]
    return RenderOutput(
        image=image,
        radii=proj.radius,
        num_instances=binning.num_instances,
        num_rows=binning.num_rows,
    )


def mark_visible(xyz: torch.Tensor, camera: Camera) -> torch.Tensor:
    """[N] bool frustum visibility (near-plane test of the in_frustum cull)."""
    _, p_view = project_points(xyz, camera)
    return p_view[:, 2] > NEAR_CULL_Z


def render_oracle(
    params: GaussianParams,
    camera: Camera,
    *,
    active_sh_degree: int,
    bg_color: torch.Tensor,
    scaling_modifier: float = 1.0,
    mean2d_offset: torch.Tensor | None = None,
    alive: torch.Tensor | None = None,
    tile_size: int | None = 16,
) -> torch.Tensor:
    """Naive O(N*pixels) reference render (tests/debugging)."""
    proj = preprocess(
        xyz=params.xyz,
        sh=params.get_features(),
        opacity=params.get_opacity(),
        scaling=params.get_scaling(),
        rotation=params.rotation,
        camera=camera,
        active_sh_degree=active_sh_degree,
        scaling_modifier=scaling_modifier,
        mean2d_offset=mean2d_offset,
        alive=alive,
    )
    return composite_oracle(proj, camera, bg_color, tile_size=tile_size)
