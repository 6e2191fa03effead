"""Save and load block operators as one ``.npz`` file.

Counterpart of ``blocksparse_tpu/interop/serialize.py``, with its keys, so
either package loads what the other saved: the construction data (blocks
and index lists, ragged as ``<prefix>_count`` plus ``<prefix>_<i>``) and the
settings ``kind``, ``shape``, ``schedule``, ``backend``, ``precision``
("none" for None), ``granularity`` (its ``repr``), ``scatter``,
``optimize`` ("none" for None) and, where the operator carries measured
autotune winners, ``autotune`` (JSON ``{kind: winner}``).  The port also
writes ``patch`` and ``panel``; the JAX ``load`` reads keys by name and
ignores them.

``autotune``: the port reads it and keeps it on the loaded operator
(``_autotune_reports``), so a round trip writes it back unchanged; it
applies no policy (the port has one engine per device).

bf16: numpy has no bf16, and the JAX package's ``save`` writes bf16 blocks
as raw 2-byte records (``|V2``) that its own ``load`` refuses.  The port
writes a bf16 operator's blocks as their exact float32 copies plus a
``dtype = "bfloat16"`` key: the JAX ``load`` builds a float32 operator with
the same values, the port's ``load`` a bf16 one.  The port's ``load``
also reads a JAX-written ``|V2`` block, by its bits, as bf16.
"""

from __future__ import annotations

import ast
import json

import numpy as np
import torch

from ..formats.block_sparse import BlockSparseMatrix
from ..formats.symmetric import SymmetricBlockMatrix
from ..formats.vbcrs import VariableBlockCompressedRowStorage

__all__ = ["save", "load"]

_FORMATS = {
    "BlockSparseMatrix": BlockSparseMatrix,
    "SymmetricBlockMatrix": SymmetricBlockMatrix,
    "VariableBlockCompressedRowStorage": VariableBlockCompressedRowStorage,
}


def _pack_ragged(prefix: str, arrays, out: dict) -> None:
    out[f"{prefix}_count"] = np.int64(len(arrays))
    for i, a in enumerate(arrays):
        out[f"{prefix}_{i}"] = np.asarray(a)


def _unpack_ragged(prefix: str, data) -> list[np.ndarray]:
    return [data[f"{prefix}_{i}"] for i in range(int(data[f"{prefix}_count"]))]


def save(path, op) -> None:
    """Save a block operator (any of the three formats) to ``path``
    (.npz).  Lazy wrappers raise ``TypeError``: save the base operator."""
    kind = type(op).__name__
    if kind not in _FORMATS:
        raise TypeError(
            f"save supports the three storage formats, got {kind} "
            "(materialize lazy wrappers or save the base operator)")
    meta = dict(
        kind=kind,
        shape=np.asarray(op.shape, dtype=np.int64),
        schedule=np.str_(op.schedule),
        backend=np.str_(op._backend),
        precision=np.str_("none" if op._precision is None
                          else op._precision),
        granularity=np.str_(repr(op._granularity)),
        scatter=np.str_(getattr(op, "_scatter", "atomic")),
        optimize=np.str_("none" if op._optimize is None else op._optimize),
        patch=np.str_(op.patch),
        panel=np.str_(op.panel),
    )
    if op.dtype == torch.bfloat16:
        meta["dtype"] = np.str_("bfloat16")
    reports = getattr(op, "_autotune_reports", None)
    if reports:
        meta["autotune"] = np.str_(json.dumps(
            {kind_: rep["winner"] for kind_, rep in reports.items()}))
    if isinstance(op, SymmetricBlockMatrix):
        nd, no = range(op.ndiagonals), range(op.noffdiagonals)
        _pack_ragged("diag", [op.diagonal(i) for i in nd], meta)
        _pack_ragged("diagidx", [op.diagonalindices(i) for i in nd], meta)
        _pack_ragged("off", [op.offdiagonal(i) for i in no], meta)
        _pack_ragged("rows", [op.blockrowindices(i) for i in no], meta)
        _pack_ragged("cols", [op.blockcolindices(i) for i in no], meta)
    else:
        n = range(op.nblocks)
        _pack_ragged("blocks", [op.block(i) for i in n], meta)
        _pack_ragged("rows", [op.blockrowindices(i) for i in n], meta)
        _pack_ragged("cols", [op.blockcolindices(i) for i in n], meta)
    np.savez_compressed(path, **meta)


def load(path, *, device="cuda", **overrides):
    """Load an operator saved by :func:`save` (of either package) onto
    ``device`` (the card unless the caller passes another).  ``overrides``
    go to the constructor (``precision=``, ``granularity=``, ``dtype=``,
    ...) in place of the saved settings."""
    with np.load(path, allow_pickle=False) as data:
        kind = str(data["kind"])
        if kind not in _FORMATS:
            raise ValueError(f"{path}: unknown operator kind {kind!r}")
        shape = tuple(int(v) for v in data["shape"])
        kwargs = dict(schedule=str(data["schedule"]), device=device)
        if "backend" in data:  # the settings block (absent in old files)
            kwargs["backend"] = str(data["backend"])
            prec = str(data["precision"])
            kwargs["precision"] = None if prec == "none" else prec
            gran = str(data["granularity"])
            kwargs["granularity"] = ("pow2" if gran == "'pow2'"
                                     else ast.literal_eval(gran))
            if kind != "SymmetricBlockMatrix":
                kwargs["scatter"] = str(data["scatter"])
            if "optimize" in data:
                opt = str(data["optimize"])
                kwargs["optimize"] = None if opt == "none" else opt
        for key in ("patch", "panel"):
            if key in data:
                kwargs[key] = str(data[key])
        if "dtype" in data and str(data["dtype"]) == "bfloat16":
            kwargs["dtype"] = torch.bfloat16
        kwargs.update(overrides)
        autotune = (json.loads(str(data["autotune"])) if "autotune" in data
                    else None)
        if kind == "SymmetricBlockMatrix":
            op = SymmetricBlockMatrix(
                _unpack_ragged("diag", data), _unpack_ragged("diagidx", data),
                _unpack_ragged("off", data), _unpack_ragged("rows", data),
                _unpack_ragged("cols", data), shape, **kwargs)
        else:
            op = _FORMATS[kind](
                _unpack_ragged("blocks", data), _unpack_ragged("rows", data),
                _unpack_ragged("cols", data), shape, **kwargs)
    if autotune:
        op._autotune_reports = {
            kind_: {"kind": kind_, "winner": winner, "applied": False,
                    "loaded": True}
            for kind_, winner in autotune.items()}
    return op
