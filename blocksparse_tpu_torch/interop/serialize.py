"""Save and load block operators as one ``.npz`` file.

Counterpart of ``blocksparse_tpu/interop/serialize.py``, with its keys, so
either package loads what the other saved: the construction data (blocks
and index lists, ragged as ``<prefix>_count`` plus ``<prefix>_<i>``) and the
settings ``kind``, ``shape``, ``schedule``, ``backend``, ``precision``
("none" for None), ``granularity`` (its ``repr``), ``scatter``,
``optimize`` ("none" for None) and, where the operator carries measured
autotune winners of the JAX package, ``autotune`` (JSON ``{kind:
winner}``).  The port also writes ``patch``, ``panel`` and, where it
carries winners of its own ``utils/autotune``, ``autotune_torch`` (JSON
``{kind: route}``); the JAX ``load`` reads keys by name and ignores them.

``autotune`` names TPU engines ("xla" / "pallas"), which the JAX ``load``
registers as its policy, so the port never writes its routes there: it
reads the key, keeps it on the loaded operator (``_jax_autotune``, and
unapplied in ``_autotune_reports``) and writes it back unchanged.
``autotune_torch``: ``load`` registers each spmv / spmm winner as the
population policy of the loaded operator's layouts
(``ops/dispatch.set_population_policy``), so its products take the saved
route, as the JAX ``load`` does with its key.

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
from ..ops.dispatch import POLICY_KINDS, layouts_of, set_population_policy
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


def _winners(op) -> tuple[dict, dict]:
    """({kind: winner} of the ``autotune`` key, of ``autotune_torch``):
    the JAX key as it was loaded plus reports naming a TPU engine, and
    the port's own reports."""
    jax_keyed = dict(getattr(op, "_jax_autotune", None) or {})
    mine = {}
    for kind, rep in (getattr(op, "_autotune_reports", None) or {}).items():
        if rep.get("key") == "autotune":
            continue  # loaded from the JAX key: kept in _jax_autotune
        if rep["winner"] in ("xla", "pallas"):
            jax_keyed[kind] = rep["winner"]
        else:
            mine[kind] = rep["winner"]
    return jax_keyed, mine


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
    for key, winners in zip(("autotune", "autotune_torch"), _winners(op)):
        if winners:
            meta[key] = np.str_(json.dumps(winners))
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
        jax_keyed, mine = (json.loads(str(data[key])) if key in data else {}
                           for key in ("autotune", "autotune_torch"))
        if kind == "SymmetricBlockMatrix":
            op = SymmetricBlockMatrix(
                _unpack_ragged("diag", data), _unpack_ragged("diagidx", data),
                _unpack_ragged("off", data), _unpack_ragged("rows", data),
                _unpack_ragged("cols", data), shape, **kwargs)
        else:
            op = _FORMATS[kind](
                _unpack_ragged("blocks", data), _unpack_ragged("rows", data),
                _unpack_ragged("cols", data), shape, **kwargs)
    reports = {kind: {"kind": kind, "winner": winner, "applied": False,
                      "loaded": True, "key": "autotune"}
               for kind, winner in jax_keyed.items()}
    for kind, route in mine.items():
        if kind in POLICY_KINDS:
            for lay in layouts_of(op):
                set_population_policy(lay, kind, route)
        reports[kind] = {"kind": kind, "winner": route, "applied": True,
                         "loaded": True}
    if jax_keyed:
        op._jax_autotune = jax_keyed
    if reports:
        op._autotune_reports = reports
    return op
