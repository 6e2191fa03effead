"""Free-function API surface (reference-export parity).

Counterpart of ``blocksparse_tpu/api.py``.  Parity target: the module
exports of src/BlockSparseMatrices.jl:26-28 -- ``rowindices``,
``colindices``, ``eachblockindex``, ``block`` -- plus ``nnz`` and the
colors accessors.

The free functions resolve lazy adjoint/transpose wrappers exactly the way
the reference's wrapper methods do: ``block(A', i)`` returns the adjoint of
the stored block (blockmatrix.jl:150-160), ``rowindices(A', i)`` returns the
underlying ``colindices`` (symmetricblockmatrix.jl:341-365), and
``colors(A')`` returns ``transposecolors(A)`` (blockmatrix.jl:200-206).
"""

from __future__ import annotations

import numpy as np

from .core.operator import AdjointOperator, ConjOperator, TransposeOperator

__all__ = [
    "rowindices",
    "colindices",
    "eachblockindex",
    "block",
    "nnz",
    "colors",
    "transposecolors",
]


def _is_flip(A) -> bool:
    return isinstance(A, (AdjointOperator, TransposeOperator))


def rowindices(A, i: int) -> np.ndarray:
    """Row index list of block ``i`` (adjoint/transpose swap row<->col)."""
    if _is_flip(A):
        return colindices(A.op, i)
    if isinstance(A, ConjOperator):
        return rowindices(A.op, i)
    return A.blockrowindices(i)


def colindices(A, i: int) -> np.ndarray:
    if _is_flip(A):
        return rowindices(A.op, i)
    if isinstance(A, ConjOperator):
        return colindices(A.op, i)
    return A.blockcolindices(i)


def eachblockindex(A):
    if _is_flip(A) or isinstance(A, ConjOperator):
        return eachblockindex(A.op)
    return A.eachblockindex()


def block(A, i: int) -> np.ndarray:
    """Dense block ``i``; wrappers transform the stored block lazily."""
    if isinstance(A, AdjointOperator):
        return np.conj(block(A.op, i)).T
    if isinstance(A, TransposeOperator):
        return block(A.op, i).T
    if isinstance(A, ConjOperator):
        return np.conj(block(A.op, i))
    return A.block(i)


def nnz(A) -> int:
    """Logical nnz; invariant under adjoint/transpose (test parity:
    test_blockmatrix.jl:84-91)."""
    if _is_flip(A) or isinstance(A, ConjOperator):
        return nnz(A.op)
    return A.nnz


def colors(A):
    if _is_flip(A):
        return transposecolors(A.op)
    if isinstance(A, ConjOperator):
        return colors(A.op)
    return A.colors()


def transposecolors(A):
    if _is_flip(A):
        return colors(A.op)
    if isinstance(A, ConjOperator):
        return transposecolors(A.op)
    return A.transposecolors()
