"""How much early-termination headroom the bench view has: the
counterpart of the repository's tools/probe_saturation.py.

The view's final transmittance map, through the port's preprocess ->
bin_gaussians -> composite -> untile (budgets 3 * 2^20 instances and 2^21
rows, 16x16 tiles, as there), its percentiles, the share of pixels that
terminated (T < 1e-4) or nearly (T < 1e-2), and per tile the share of its
pixels that terminated: the share of tiles whose every pixel terminated
is what an all-done skip could save.

    python -m gsjax_torch.tools.probe_saturation

One JSON line on the bench scene (tools/common.bench_scene).
"""

from __future__ import annotations

import json

import numpy as np
import torch

from gsjax_torch.config import RasterConfig

CFG = RasterConfig(max_instances=3 * 2 ** 20, max_rows=2 ** 21)
PERCENTILES = [1, 5, 25, 50, 75, 95, 99]
TILE_PERCENTILES = [5, 25, 50, 75, 95]
DONE = 1e-4


@torch.no_grad()
def t_map(params, aux, camera, cfg: RasterConfig = CFG, sh_degree: int = 3) -> torch.Tensor:
    """The view's final transmittance [H, W]."""
    from gsjax_torch.render.binning import bin_gaussians, num_tiles
    from gsjax_torch.render.common import untile_image
    from gsjax_torch.render.composite import CompositeStatic, composite, pack_fields
    from gsjax_torch.render.preprocess import preprocess

    h, w = camera.height, camera.width
    proj = preprocess(
        xyz=params.xyz, sh=params.get_features(), opacity=params.get_opacity(),
        scaling=params.get_scaling(), rotation=params.rotation, camera=camera,
        active_sh_degree=sh_degree, alive=aux.alive)
    binning = bin_gaussians(proj.mean_pix, proj.depth, proj.ext, proj.conic, proj.qmax,
                            h, w, cfg)
    tiles_x, tiles_y = num_tiles(h, w, cfg.tw, cfg.th)
    static = CompositeStatic(n_tiles=tiles_x * tiles_y, tiles_x=tiles_x, tile_w=cfg.tw,
                             tile_h=cfg.th, chunk=cfg.chunk, strips=cfg.strips)
    fields = pack_fields(proj.mean_pix, proj.conic, proj.rgb, proj.opacity)
    tile_color, tile_t = composite(fields.index_select(0, binning.perm.long()), binning,
                                   static)
    _, transmittance = untile_image(tile_color, tile_t, h, w, tiles_x, tiles_y,
                                    cfg.tw, cfg.th)
    return transmittance


def tile_done_fractions(t: np.ndarray, tile_w: int, tile_h: int) -> np.ndarray:
    """Per whole tile (the partial ones at the right and bottom edges
    left out), the share of its pixels with T < DONE."""
    th, tw = t.shape[0] // tile_h, t.shape[1] // tile_w
    tt = t[: th * tile_h, : tw * tile_w].reshape(th, tile_h, tw, tile_w).transpose(0, 2, 1, 3)
    return (tt < DONE).reshape(th * tw, -1).mean(axis=1)


def summarize(t: np.ndarray, tile_w: int, tile_h: int) -> dict:
    done = tile_done_fractions(t, tile_w, tile_h)
    return {"t_percentiles": dict(zip(PERCENTILES, np.percentile(t, PERCENTILES).tolist())),
            "frac_pixels_terminated": float((t < DONE).mean()),
            "frac_pixels_below_1e-2": float((t < 1e-2).mean()),
            "frac_tiles_fully_terminated": float((done == 1.0).mean()),
            "tile_done_frac_percentiles": dict(zip(
                TILE_PERCENTILES, np.percentile(done, TILE_PERCENTILES).tolist()))}


def main(argv=None) -> None:
    import argparse

    from gsjax_torch.tools.common import bench_scene, require_card

    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    require_card("probe_saturation")
    params, aux, camera, _ = bench_scene()
    t = t_map(params, aux, camera).cpu().numpy()
    print(json.dumps({"tool": "probe_saturation", "device": torch.cuda.get_device_name(0),
                      "width": camera.width, "height": camera.height,
                      "tile": f"{CFG.tw}x{CFG.th}", **summarize(t, CFG.tw, CFG.th)}),
          flush=True)


if __name__ == "__main__":
    main()
