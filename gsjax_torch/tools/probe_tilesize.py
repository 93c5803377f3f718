"""Exact (Gaussian, tile) pair counts for candidate tile shapes: the
counterpart of the repository's tools/probe_tilesize.py.

Replays binning's two counting levels (the tile rectangle, then each tile
row's exact x-interval, render/kernels.row_x_interval with
binning.CULL_QMAX_MARGIN) for a (tile_w, tile_h) grid without building
the instance stream: the instance-rate stages scale with the pairs, the
composite kernels' cost per tile with its area.

    python -m gsjax_torch.tools.probe_tilesize

On the bench scene (tools/common.bench_scene: 500k Gaussians, the origin
view at 1920x1080), one JSON line of the live Gaussians' x-extent
percentiles and one per tile shape (16x16, 32x16, 32x32, 64x16): pairs,
rows, tiles, estimated walks (pairs / 128 + one boundary walk per tile)
and kernel units (walks times the tile's pixels).
"""

from __future__ import annotations

import json

import numpy as np
import torch

from gsjax_torch.render.binning import CULL_QMAX_MARGIN
from gsjax_torch.render.kernels import row_x_interval

TILE_SHAPES = ((16, 16), (32, 16), (32, 32), (64, 16))
CHUNK = 128


def count_pairs(proj, tile_w: int, tile_h: int, width: int, height: int):
    """(pairs, rows, tiles) of a width x height view in tile_w x tile_h
    tiles: the rows each Gaussian's rectangle spans, and per row the tiles
    its exact x-interval meets."""
    tiles_x = -(-width // tile_w)
    tiles_y = -(-height // tile_h)
    mp, ext = proj.mean_pix.detach(), proj.ext.detach()

    def grid(v, hi):
        return torch.clamp(v, 0, hi).to(torch.int32)

    x0 = grid((mp[:, 0] - ext[:, 0]) / tile_w, tiles_x)
    y0 = grid((mp[:, 1] - ext[:, 1]) / tile_h, tiles_y)
    x1 = grid(torch.ceil((mp[:, 0] + ext[:, 0] + 1.0) / tile_w), tiles_x)
    y1 = grid(torch.ceil((mp[:, 1] + ext[:, 1] + 1.0) / tile_h), tiles_y)
    empty = (ext[:, 0] <= 0.0) | (ext[:, 1] <= 0.0)
    x1 = torch.where(empty, x0, x1)
    y1 = torch.where(empty, y0, y1)
    row_counts = y1 - y0
    total_rows = int(row_counts.sum())

    qm = proj.qmax.detach() * CULL_QMAX_MARGIN + 1e-6
    conic = proj.conic.detach()
    ca, cb, cc = conic[:, 0], conic[:, 1], conic[:, 2]
    total = 0
    for j in range(int(row_counts.max()) if row_counts.numel() else 0):
        ty = y0 + j
        valid = ty < y1
        y0s = ty.to(torch.float32) * tile_h - mp[:, 1]
        x_lo, x_hi, nonempty = row_x_interval(y0s, y0s + (tile_h - 1.0), ca, cb, cc, qm)
        rx0 = torch.ceil((mp[:, 0] + x_lo - (tile_w - 1.0)) / tile_w).to(torch.int32)
        rx1 = torch.floor((mp[:, 0] + x_hi) / tile_w).to(torch.int32) + 1
        rx0 = torch.maximum(rx0, x0)
        rx1 = torch.minimum(rx1, x1)
        cnt = torch.where(valid & nonempty, torch.clamp(rx1 - rx0, min=0), 0)
        total += int(cnt.sum())
    return total, total_rows, tiles_x * tiles_y


def run(proj, width: int, height: int, shapes=TILE_SHAPES) -> list[dict]:
    """One row per tile shape."""
    rows = []
    for tw, th in shapes:
        pairs, n_rows, n_tiles = count_pairs(proj, tw, th, width, height)
        walks = pairs / CHUNK + n_tiles
        rows.append({"tool": "probe_tilesize", "tile": f"{tw}x{th}", "pairs": pairs,
                     "rows": n_rows, "tiles": n_tiles, "est_walks": walks,
                     "kernel_units": walks * tw * th})
    return rows


def main(argv=None) -> None:
    import argparse

    from gsjax_torch.render.preprocess import preprocess
    from gsjax_torch.tools.common import HEIGHT, SH_DEGREE, WIDTH, bench_scene, require_card

    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    require_card("probe_tilesize")
    params, aux, camera, _ = bench_scene()
    with torch.no_grad():
        proj = preprocess(
            xyz=params.xyz, sh=params.get_features(), opacity=params.get_opacity(),
            scaling=params.get_scaling(), rotation=params.rotation, camera=camera,
            active_sh_degree=SH_DEGREE, alive=aux.alive)
    ext = proj.ext.cpu().numpy()
    live = ext[:, 0] > 0
    print(json.dumps({"tool": "probe_tilesize", "device": torch.cuda.get_device_name(0),
                      "ext_px_percentiles_5_25_50_75_95": np.percentile(
                          ext[live, 0], [5, 25, 50, 75, 95]).tolist()}), flush=True)
    for row in run(proj, WIDTH, HEIGHT):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
