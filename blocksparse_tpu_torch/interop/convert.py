"""Carry an operator of the JAX package across into the port.

``from_reference(A)`` is duck-typed on the accessors the JAX formats
answer from host numpy: a ``SymmetricBlockMatrix`` by ``ndiagonals``,
``diagonal(i)``, ``diagonalindices(i)``, ``noffdiagonals``,
``offdiagonal(i)``, ``blockrowindices(i)`` and ``blockcolindices(i)``; a
``VariableBlockCompressedRowStorage`` by ``rowptr``, ``nblocks``,
``block(i)``, ``row_start(i)`` and ``col_start(i)``; a
``BlockSparseMatrix`` by ``nblocks``, ``block(i)`` and the two index
accessors.  It builds the port's operator from the same numpy blocks.
It also carries the preconditioners of ``blocksparse_tpu/precond.py``
across, by class name: a ``DiagonalOperator`` by its 1-D ``d``, and a
``SumOperator`` (the ``M + DiagonalOperator`` that ``block_jacobi``
returns) by its summands ``a`` and ``b``; and a ``ComplexSplitOperator``
by its real children ``re_op`` and ``im_op``.  Complex operators of all
three formats carry across as they are (their blocks are complex numpy),
and so do bf16 ones (their blocks are ml_dtypes bf16 arrays, which the
constructors read by their bits).  A ``DistributedBlockOperator`` of
``blocksparse_tpu/parallel/distributed.py`` carries across onto a port
:class:`~..parallel.mesh.Mesh` of the same shard count (``mesh=``): its
halo plans, send tables and stacked values and tables (its ``_arrays``
and ``_meta``) as they are, not re-planned.  The JAX operator's ``schedule`` (``"auto"``
included), ``backend``, ``optimize`` and, for the general and VBCRS
formats, ``scatter`` are carried across unless ``kwargs`` give them.
This module imports neither jax nor the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..complexops import ComplexSplitOperator
from ..core.operator import SumOperator
from ..formats.block_sparse import (_DTYPES, BlockSparseMatrix, _np_dtype,
                                   is_bf16)
from ..formats.symmetric import SymmetricBlockMatrix
from ..formats.vbcrs import VariableBlockCompressedRowStorage
from ..parallel.distributed import DistributedBlockOperator, _Meta
from ..parallel.partition import HaloPlan
from ..precond import DiagonalOperator

__all__ = ["from_reference"]


def from_reference(A, **kwargs):
    """The port's ``SymmetricBlockMatrix``,
    ``VariableBlockCompressedRowStorage`` or ``BlockSparseMatrix`` holding
    ``A``'s blocks and index lists; ``kwargs`` (``device``, ``dtype``,
    ``precision``, ``schedule``, ``granularity``, ``patch``, ``panel``,
    ...) go to its constructor.  A ``DiagonalOperator`` becomes the port's,
    on ``kwargs["device"]`` (the card unless given) in ``kwargs["dtype"]``
    (its own unless given); a ``SumOperator`` the port's sum of its
    summands, and a ``ComplexSplitOperator`` the port's pair of its
    children, each carried across with ``kwargs``.  A
    ``DistributedBlockOperator`` needs ``mesh=``, a port mesh with the
    JAX operator's axis names and shard count, and takes no other
    ``kwargs``."""
    kind = type(A).__name__
    if kind == "DistributedBlockOperator":
        return _distributed(A, **kwargs)
    if kind == "DiagonalOperator":
        return DiagonalOperator(np.array(A.d, dtype=_np_dtype(kwargs.get("dtype"))),
                                device=kwargs.get("device"))
    if kind == "SumOperator":
        return SumOperator(from_reference(A.a, **kwargs),
                           from_reference(A.b, **kwargs))
    if kind == "ComplexSplitOperator":
        return ComplexSplitOperator(from_reference(A.re_op, **kwargs),
                                    from_reference(A.im_op, **kwargs))
    for key in ("schedule", "backend", "optimize", "scatter"):
        if hasattr(A, f"_{key}"):
            kwargs.setdefault(key, getattr(A, f"_{key}"))
    if hasattr(A, "ndiagonals"):
        d, o = range(A.ndiagonals), range(A.noffdiagonals)
        return SymmetricBlockMatrix(
            [A.diagonal(i) for i in d],
            [A.diagonalindices(i) for i in d],
            [A.offdiagonal(i) for i in o],
            [A.blockrowindices(i) for i in o],
            [A.blockcolindices(i) for i in o],
            tuple(A.shape),
            **kwargs,
        )
    n = A.nblocks
    if hasattr(A, "rowptr"):
        return VariableBlockCompressedRowStorage(
            [A.block(i) for i in range(n)],
            [A.row_start(i) for i in range(n)],
            [A.col_start(i) for i in range(n)],
            tuple(A.shape),
            **kwargs,
        )
    return BlockSparseMatrix(
        [A.block(i) for i in range(n)],
        [A.blockrowindices(i) for i in range(n)],
        [A.blockcolindices(i) for i in range(n)],
        tuple(A.shape),
        **kwargs,
    )


def _host(a) -> np.ndarray:
    """A JAX array as numpy; bf16 as its exact float32 copy."""
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _halo(plan) -> HaloPlan:
    return HaloPlan(S=plan.S, per=plan.per, dists=tuple(plan.dists),
                    send_idx=tuple(_host(t) for t in plan.send_idx),
                    halo_chunks=plan.halo_chunks,
                    chunk_pos=tuple(dict(p) for p in plan.chunk_pos))


def _distributed(A, *, mesh) -> DistributedBlockOperator:
    """The port's operator over ``mesh`` holding ``A``'s plans and arrays."""
    m = A._meta
    np_dtype = np.dtype(m.dtype)
    dtype = torch.bfloat16 if is_bf16(np_dtype) else _DTYPES[np_dtype]
    meta = _Meta(axis=m.axis, shape=tuple(m.shape), dtype=dtype,
                 precision=m.precision, sym=m.sym, rows_per=m.rows_per,
                 cols_per=m.cols_per, Hr=m.Hr, Hc=m.Hc,
                 row_dists=tuple(m.row_dists), col_dists=tuple(m.col_dists),
                 part_kinds=tuple(m.part_kinds),
                 part_chunks=tuple(m.part_chunks), rhs_axis=m.rhs_axis)
    row_send, col_send, parts = A._arrays
    arrays = (tuple(_host(t) for t in row_send),
              tuple(_host(t) for t in col_send),
              tuple(tuple(tuple(None if grp is None else
                                tuple(_host(a) for a in grp) for grp in row)
                          for row in part) for part in parts))
    return DistributedBlockOperator.from_arrays(
        mesh, meta, _halo(A.row_halo), _halo(A.col_halo), arrays)
