"""Multi-process set-up for the distributed layer.

Counterpart of ``blocksparse_tpu/parallel/multihost.py``.  The distributed
layer (``distributed.py``) takes any :class:`~.mesh.Mesh`; a mesh whose
entries name several ranks runs its halo rounds over
``torch.distributed`` point-to-point operations.  Every process calls
:func:`init` once (after :func:`cpu_local_cluster` where the process is to
hold CPU shards), then builds the same mesh with :func:`global_row_mesh`
and the same operator, and passes the same full operand
(:func:`replicate`).

Nothing on a machine tells a program of its cluster: :func:`init` takes
the rendezvous address, the process count and this process's rank.
"""

from __future__ import annotations

import numpy as np
import torch

from .mesh import Mesh

__all__ = ["init", "global_row_mesh", "cpu_local_cluster", "replicate"]

_LOCAL_CPU_SHARDS = 0  # set by cpu_local_cluster: CPU shards of this process


def cpu_local_cluster(num_local_devices: int = 4) -> None:
    """Make THIS process one member of a multi-process CPU cluster holding
    ``num_local_devices`` CPU shards: :func:`init` then picks the gloo
    backend and :func:`global_row_mesh` gives every rank that many "cpu"
    entries.  Call it before :func:`init`.

    Exercised end to end by ``tests/test_torch_multihost.py``: 2 or 4 OS
    processes, eight shards in all, halo rounds crossing the process
    boundaries."""
    global _LOCAL_CPU_SHARDS
    if num_local_devices < 1:
        raise ValueError(f"num_local_devices must be >= 1, got "
                         f"{num_local_devices}")
    _LOCAL_CPU_SHARDS = int(num_local_devices)


def init(coordinator_address: str, num_processes: int,
         process_id: int) -> None:
    """``torch.distributed.init_process_group`` over TCP: gloo for a CPU
    cluster (:func:`cpu_local_cluster`), NCCL for a CUDA one.
    ``coordinator_address``: ``host:port`` (or ``tcp://host:port``) of
    rank 0; raises if called twice."""
    import torch.distributed as dist

    if not coordinator_address.startswith("tcp://"):
        coordinator_address = f"tcp://{coordinator_address}"
    backend = "gloo" if _LOCAL_CPU_SHARDS else "nccl"
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card for an NCCL process group; call "
                           "cpu_local_cluster() first for CPU shards")
    dist.init_process_group(backend, init_method=coordinator_address,
                            world_size=num_processes, rank=process_id)


def _rank_devices(rank: int) -> list:
    """The devices rank ``rank`` holds: its CPU shards, or one card."""
    if _LOCAL_CPU_SHARDS:
        return [torch.device("cpu")] * _LOCAL_CPU_SHARDS
    return [torch.device("cuda", rank % torch.cuda.device_count())]


def global_row_mesh(axis: str = "rows") -> Mesh:
    """1-D mesh over every rank's devices (rank 0's first), each entry
    naming its rank: the card of each rank (``cuda:<rank % device
    count>``) unless this process asked for CPU shards."""
    import torch.distributed as dist

    devices, ranks = [], []
    for rank in range(dist.get_world_size()):
        devs = _rank_devices(rank)
        devices += devs
        ranks += [rank] * len(devs)
    return Mesh(np.array(devices, dtype=object), (axis,), ranks=ranks)


def replicate(a, mesh: Mesh) -> torch.Tensor:
    """Host values -> a tensor on this rank's first device of ``mesh``.
    Every process must call this with the SAME values (the
    same-on-all-ranks contract of the distributed products)."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
    return t.to(mesh.local_devices[0])
