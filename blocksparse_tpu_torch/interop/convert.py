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
returns) by its summands ``a`` and ``b``.  This module imports neither jax nor the JAX package.
"""

from __future__ import annotations

import numpy as np

from ..core.operator import SumOperator
from ..formats.block_sparse import BlockSparseMatrix, _np_dtype
from ..formats.symmetric import SymmetricBlockMatrix
from ..formats.vbcrs import VariableBlockCompressedRowStorage
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
    summands, each carried across with ``kwargs``."""
    kind = type(A).__name__
    if kind == "DiagonalOperator":
        return DiagonalOperator(np.array(A.d, dtype=_np_dtype(kwargs.get("dtype"))),
                                device=kwargs.get("device"))
    if kind == "SumOperator":
        return SumOperator(from_reference(A.a, **kwargs),
                           from_reference(A.b, **kwargs))
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
