"""Device meshes for the distributed layer.

The counterpart of ``jax.sharding.Mesh``, which the JAX distributed layer
takes as given: a numpy object array of ``torch.device`` s of shape ``[S]``
(block-row shards) or ``[S, R]`` (block-row shards x RHS column groups),
with one axis name per dimension.

- One device may hold several shards: ``Mesh(["cpu"] * 8)`` is the analog
  of the JAX test suite's 8 virtual CPU devices, ``Mesh(["cuda:0"] * 4)``
  runs four shards on one card.
- In a multi-process job (``torch.distributed``, see ``multihost.py``)
  every entry also names the rank that holds it (``ranks``, same shape);
  every process builds the same mesh and runs the entries of its own rank.
  Without ``ranks`` every entry belongs to this process.
- A named device that does not exist raises; no other device is swapped
  in.  Only this process's entries are checked: it cannot see the others'.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["Mesh", "process_rank"]


def process_rank() -> int:
    """This process's rank in the default process group, 0 without one."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def _concrete(dev: torch.device) -> torch.device:
    """"cuda" as the current card's index where a card is present."""
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _check_device(dev: torch.device) -> None:
    if dev.type == "cpu":
        return
    if dev.type != "cuda":
        raise ValueError(f"mesh device {dev}: the port runs on 'cpu' or "
                         "'cuda' devices")
    if not torch.cuda.is_available():
        raise RuntimeError(f"mesh device {dev}: no CUDA card is available")
    count = torch.cuda.device_count()
    if dev.index is not None and dev.index >= count:
        raise RuntimeError(f"mesh device {dev}: this process sees {count} "
                           "CUDA device(s)")


class Mesh:
    """``devices``: an array-like of ``torch.device`` s or device strings,
    of shape ``[S]`` or ``[S, R]``; ``axis_names``: one name per dimension
    (the distributed layer shards block rows over one of them and, given
    ``rhs_axis=``, RHS columns over the other); ``ranks``: an int array of
    the same shape, the rank holding each entry (default: this process's
    rank for every entry)."""

    def __init__(self, devices, axis_names=("rows",), ranks=None):
        given = np.asarray(devices, dtype=object)
        shape = given.shape
        arr = np.empty(given.size, dtype=object)
        arr[:] = [_concrete(torch.device(d)) for d in given.flat]
        self.devices = arr.reshape(shape)
        axis_names = tuple(axis_names)
        if self.devices.ndim not in (1, 2) or \
                len(axis_names) != self.devices.ndim:
            raise ValueError(f"a mesh of shape {shape} needs "
                             f"{self.devices.ndim} axis names (1-D or 2-D), "
                             f"got {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"repeated axis name in {axis_names}")
        self.axis_names = axis_names
        here = process_rank()
        self.ranks = (np.full(shape, here, dtype=np.int64) if ranks is None
                      else np.asarray(ranks, dtype=np.int64))
        if self.ranks.shape != self.devices.shape:
            raise ValueError(f"ranks of shape {self.ranks.shape} for a mesh "
                             f"of shape {shape}")
        for dev, rank in zip(self.devices.flat, self.ranks.flat):
            if rank == here:
                _check_device(dev)

    @property
    def shape(self) -> dict:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def multiprocess(self) -> bool:
        """True where entries belong to more than one rank."""
        return len(np.unique(self.ranks)) > 1

    @property
    def local_devices(self) -> list:
        """This process's devices, in mesh order, each once."""
        out = []
        for dev, rank in zip(self.devices.flat, self.ranks.flat):
            if rank == process_rank() and dev not in out:
                out.append(dev)
        return out

    def __repr__(self):
        shape = ", ".join(f"{k}={v}" for k, v in self.shape.items())
        devs = sorted({str(d) for d in self.devices.flat})
        ranks = sorted({int(r) for r in self.ranks.flat})
        return f"Mesh({shape}; devices {devs}; ranks {ranks})"
