"""Process-group initialization for the mesh.

The policy layer of gsjax.parallel.multihost: when to join a process
group, and which camera indices this process loads. In the port a process
is one rank driving one device, so gsjax's per-process split is the
per-rank split.
"""

from __future__ import annotations

import os
import socket
from datetime import timedelta

import torch
import torch.distributed as dist

from gsjax_torch.parallel.mesh import backend_for, local_rank

TIMEOUT = timedelta(minutes=10)


def _init(device_type: str, rank: int | None = None, **kwargs) -> None:
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA process group needs CUDA")
        torch.cuda.set_device(local_rank(rank))
    if rank is not None:
        kwargs["rank"] = rank
    dist.init_process_group(backend_for(device_type), timeout=TIMEOUT, **kwargs)


def maybe_init_distributed(device_type: str) -> bool:
    """Join the process group the environment describes, on device_type's
    backend (NCCL for "cuda", gloo for "cpu"). A no-op returning False in
    a single process. Returns True when a group is active.

    Two launch protocols: gsjax's explicit one, COORDINATOR_ADDRESS
    (host:port of rank 0), NUM_PROCESSES and PROCESS_ID
    (gsjax/parallel/multihost.py:16-43), and torchrun's MASTER_ADDR,
    MASTER_PORT, RANK and WORLD_SIZE."""
    if dist.is_initialized():
        return True
    addr = os.environ.get("COORDINATOR_ADDRESS")
    n = os.environ.get("NUM_PROCESSES")
    pid = os.environ.get("PROCESS_ID")
    if addr and n and pid:
        _init(device_type, init_method=f"tcp://{addr}", rank=int(pid),
              world_size=int(n))
        return True
    if all(os.environ.get(k) for k in ("MASTER_ADDR", "MASTER_PORT", "RANK",
                                       "WORLD_SIZE")):
        _init(device_type, int(os.environ["RANK"]), init_method="env://")
        return True
    return False


def free_port() -> int:
    """A free TCP port on the loopback interface."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_local_group(device_type: str) -> int:
    """Start a world-size-1 process group in this process, on a free
    loopback port (tcp://127.0.0.1:<port>): what a 1x1 mesh needs without
    a launcher. Returns the port."""
    port = free_port()
    _init(device_type, 0, init_method=f"tcp://127.0.0.1:{port}", world_size=1)
    return port


def host_local_views(n_total: int) -> range:
    """The camera indices this process loads: round-robin over the
    processes (rank 0 of 1 without a process group)."""
    if not dist.is_initialized():
        return range(0, n_total)
    return range(dist.get_rank(), n_total, dist.get_world_size())
