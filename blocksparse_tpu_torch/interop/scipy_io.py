"""COO triplets and scipy conversion: the oracle of the tests and smoke run.

Counterpart of ``rowcolvals`` and ``to_scipy`` in
``blocksparse_tpu/interop/scipy_io.py``.  Duplicate (i, j) entries are
summed, matching the accumulation of overlapping blocks.  Both read the
host copy of the blocks, so no device transfer is involved.
"""

from __future__ import annotations

import numpy as np

from ..core.operator import (
    AdjointOperator,
    ConjOperator,
    LinearOperator,
    ScaledOperator,
    TransposeOperator,
)
from ..formats.block_sparse import BlockSparseMatrix
from ..formats.symmetric import SymmetricBlockMatrix
from ..formats.vbcrs import VariableBlockCompressedRowStorage

__all__ = ["rowcolvals", "to_scipy"]


def _block_triplets(rows, cols, vals):
    """All (i, j, v) triplets of one dense block at (rows x cols)."""
    r = np.repeat(np.asarray(rows), len(cols))
    c = np.tile(np.asarray(cols), len(rows))
    return r, c, np.asarray(vals).ravel()


def rowcolvals(A: LinearOperator):
    """COO triplets (rows, cols, vals) of a block operator; wrappers
    (transpose/adjoint/conj/scaled) transform the base triplets."""
    if isinstance(A, TransposeOperator):
        r, c, v = rowcolvals(A.op)
        return c, r, v
    if isinstance(A, AdjointOperator):
        r, c, v = rowcolvals(A.op)
        return c, r, np.conj(v)
    if isinstance(A, ConjOperator):
        r, c, v = rowcolvals(A.op)
        return r, c, np.conj(v)
    if isinstance(A, ScaledOperator):
        r, c, v = rowcolvals(A.op)
        alpha = A.alpha.item() if hasattr(A.alpha, "item") else A.alpha
        return r, c, alpha * v
    if isinstance(A, SymmetricBlockMatrix):
        # the reference's order: off-diagonals, transposed off-diagonals,
        # diagonals
        offs = range(A.noffdiagonals)
        parts = ([_block_triplets(A.blockrowindices(i), A.blockcolindices(i),
                                  A.offdiagonal(i)) for i in offs]
                 + [_block_triplets(A.blockcolindices(i), A.blockrowindices(i),
                                    A.offdiagonal(i).T) for i in offs]
                 + [_block_triplets(A.diagonalindices(i),
                                    A.diagonalindices(i), A.diagonal(i))
                    for i in range(A.ndiagonals)])
    elif isinstance(A, (BlockSparseMatrix, VariableBlockCompressedRowStorage)):
        parts = [_block_triplets(A.blockrowindices(i), A.blockcolindices(i),
                                 A.block(i))
                 for i in range(A.nblocks)]
    else:
        raise TypeError(f"rowcolvals: unsupported operator type {type(A).__name__}")
    if not parts:
        return (np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64),
                np.zeros(0))
    rs, cs, vs = zip(*parts)
    return np.concatenate(rs), np.concatenate(cs), np.concatenate(vs)


def to_scipy(A: LinearOperator):
    """Assemble as ``scipy.sparse.csc_array`` (duplicates summed)."""
    import scipy.sparse as sp

    r, c, v = rowcolvals(A)
    return sp.coo_array((v, (r, c)), shape=A.shape).tocsc()
