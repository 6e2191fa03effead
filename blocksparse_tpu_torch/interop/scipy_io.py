"""COO triplets, scipy conversion and scipy's entry points.

Counterpart of ``blocksparse_tpu/interop/scipy_io.py``.  ``rowcolvals`` and
``to_scipy`` (alias ``sparse``) are the oracle of the tests and smoke run:
duplicate (i, j) entries are summed, matching the accumulation of
overlapping blocks, and both read the host copy of the blocks, so no device
transfer is involved.  ``from_dense`` and ``from_scipy_blocks`` tile a
dense or scipy matrix into a ``BlockSparseMatrix`` (``device=`` and the
other constructor options through their kwargs); ``as_linear_operator``
hands any operator to ``scipy.sparse.linalg``.
"""

from __future__ import annotations

import numpy as np
import torch

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

__all__ = ["rowcolvals", "to_scipy", "sparse", "from_scipy_blocks",
           "from_dense", "as_linear_operator"]


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


# Julia-parity alias
sparse = to_scipy


def _tile_shape(block_size) -> tuple:
    """Normalize an int or (rows, cols) pair to a tile shape."""
    if np.ndim(block_size) == 0:
        bm = bn = int(block_size)
    else:
        bm, bn = (int(b) for b in block_size)
    if bm < 1 or bn < 1:
        raise ValueError(f"block_size must be positive, got {block_size!r}")
    return bm, bn


def _tiled(shape, block_size, tile_of, dtype, kwargs) -> BlockSparseMatrix:
    """A BlockSparseMatrix of the dense tiles ``tile_of(bi, bj, bm, bn)``
    returns (None for a tile to skip), in row-major tile order."""
    m, n = shape
    bm, bn = _tile_shape(block_size)
    blocks, rows, cols = [], [], []
    for bi in range(0, m, bm):
        for bj in range(0, n, bn):
            tile = tile_of(bi, bj, bm, bn)
            if tile is None:
                continue
            blocks.append(tile)
            rows.append(np.arange(bi, min(bi + bm, m)))
            cols.append(np.arange(bj, min(bj + bn, n)))
    return BlockSparseMatrix(blocks, rows, cols, (m, n), dtype=dtype,
                             **kwargs)


def from_dense(D, block_size, *, tol: float = 0.0, dtype=None,
               **kwargs) -> BlockSparseMatrix:
    """Tile a dense matrix into uniform ``block_size`` tiles (an int or a
    ``(rows, cols)`` pair), keeping tiles with any entry of magnitude
    > ``tol``; kwargs go to the BlockSparseMatrix constructor."""
    D = np.asarray(D)

    def tile_of(bi, bj, bm, bn):
        tile = D[bi:bi + bm, bj:bj + bn]
        return tile if np.any(np.abs(tile) > tol) else None

    return _tiled(D.shape, block_size, tile_of, dtype, kwargs)


def from_scipy_blocks(S, block_size, *, dtype=None,
                      **kwargs) -> BlockSparseMatrix:
    """Tile a scipy sparse matrix into uniform dense ``block_size`` blocks
    (nonempty tiles only; an int or a ``(rows, cols)`` pair); kwargs go to
    the BlockSparseMatrix constructor."""
    import scipy.sparse as sp

    S = sp.csr_array(S)

    def tile_of(bi, bj, bm, bn):
        tile = S[bi:bi + bm, bj:bj + bn]
        return np.asarray(tile.todense()) if tile.nnz else None

    return _tiled(S.shape, block_size, tile_of, dtype, kwargs)


def as_linear_operator(A):
    """Wrap any operator as a ``scipy.sparse.linalg.LinearOperator``.

    ``matvec`` / ``rmatvec`` / ``matmat`` / ``rmatmat`` move their numpy
    input onto ``A.device``, run the product there (the kernels on the
    card) and return the result as numpy: a writable array over the
    product's own fresh host tensor (scipy's iterative solvers write into
    matvec results in place).  An input whose dtype differs from the
    operator's comes out in the promoted dtype, as the products do.
    """
    from scipy.sparse.linalg import LinearOperator as _ScipyLO

    def _dev(v):
        return torch.from_numpy(np.ascontiguousarray(v)).to(A.device)

    def _host(y):
        return y.detach().cpu().numpy()

    return _ScipyLO(
        shape=tuple(A.shape),
        dtype=torch.empty(0, dtype=A.dtype).numpy().dtype,
        matvec=lambda v: _host(A @ _dev(v.reshape(-1))),
        rmatvec=lambda v: _host(A.H @ _dev(v.reshape(-1))),
        matmat=lambda V: _host(A @ _dev(V)),
        rmatmat=lambda V: _host(A.H @ _dev(V)),
    )
