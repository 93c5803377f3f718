"""Distribution layer: the device mesh, sharded rendering, sharded training.

The port of `gsjax.parallel` to torch.distributed. One process drives one
device (a rank); the ranks form a ("data", "tile") DeviceMesh. The pixel
tile grid is sharded over "tile" (each rank rasterizes a slab of tile rows
against the replicated Gaussians), cameras over "data" (one camera per
data group and step), and the per-Gaussian gradients are summed with
explicit collectives on each dimension's process group.
"""

from gsjax_torch.parallel.mesh import make_mesh, mesh_shape_for
from gsjax_torch.parallel.render import render_sharded
from gsjax_torch.parallel.step import make_sharded_train_step

__all__ = [
    "make_mesh",
    "mesh_shape_for",
    "render_sharded",
    "make_sharded_train_step",
]
