"""The ("data", "tile") device mesh over torch.distributed ranks.

Dimensions, as gsjax's mesh axes:
  data — camera-level data parallelism (each data group trains on its own
         view; parameter gradients are averaged over this dimension).
  tile — tile-slab parallelism within one view (each rank rasterizes a
         horizontal slab of tile rows; per-Gaussian gradients are summed
         over this dimension).

One process per device: rank r drives one device, and the mesh lays the
world's ranks out row-major, rank = data_index * tile + tile_index. On
CUDA the collectives run on NCCL, on the CPU on gloo; each collective
stays on its tensors' device and backend.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

DIMS = ("data", "tile")


def mesh_shape_for(n_devices: int, max_tile: int = 4) -> tuple[int, int]:
    """Pick a (data, tile) factorization of n_devices.

    Prefers the largest tile factor <= max_tile that divides n_devices —
    tile-slab parallelism cuts per-step latency; the remainder goes to data
    parallelism for throughput.
    """
    tile = 1
    for cand in range(min(max_tile, n_devices), 0, -1):
        if n_devices % cand == 0:
            tile = cand
            break
    return n_devices // tile, tile


def backend_for(device_type: str) -> str:
    """The process-group backend that carries collectives of device_type
    tensors: NCCL on CUDA, gloo on the CPU."""
    if device_type == "cuda":
        return "nccl"
    if device_type == "cpu":
        return "gloo"
    raise ValueError(f"device_type must be 'cuda' or 'cpu', not {device_type!r}")


def local_rank(rank: int | None = None) -> int:
    """This process's device index on its host: torchrun's LOCAL_RANK, else
    the global rank (`rank`, or the process group's) modulo the host's CUDA
    devices."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
    return rank % max(torch.cuda.device_count(), 1)


def make_mesh(
    device_type: str,
    data: int | None = None,
    tile: int | None = None,
) -> DeviceMesh:
    """Build a ("data", "tile") mesh over the world's ranks.

    The default process group must be initialized on device_type's backend
    (multihost.maybe_init_distributed, multihost.init_local_group or
    torch.distributed.init_process_group). data x tile must equal the
    world size (ValueError otherwise); omitted factors are inferred as
    gsjax infers them. On "cuda" this rank's device becomes the current
    CUDA device.
    """
    backend = backend_for(device_type)
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh('cuda'): CUDA is not available")
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs a process group: launch under torchrun or the "
            "COORDINATOR_ADDRESS protocol (multihost.maybe_init_distributed), "
            "or start one with multihost.init_local_group")
    if backend not in dist.get_backend():
        raise ValueError(f"a {device_type} mesh needs the {backend} backend; the "
                         f"process group runs {dist.get_backend()}")
    n = dist.get_world_size()
    if data is None and tile is None:
        data, tile = mesh_shape_for(n)
    elif data is None:
        data = n // tile
    elif tile is None:
        tile = n // data
    if data * tile != n:
        raise ValueError(f"mesh {data}x{tile} != {n} devices")
    if device_type == "cuda":
        torch.cuda.set_device(local_rank())
    return DeviceMesh(device_type, torch.arange(n).reshape(data, tile),
                      mesh_dim_names=DIMS)


def dim_size(mesh: DeviceMesh, name: str) -> int:
    """The size of mesh dimension `name` ("data" or "tile")."""
    return mesh.size(DIMS.index(name))
