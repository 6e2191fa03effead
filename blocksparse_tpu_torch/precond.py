"""Preconditioners over the block-sparse operator algebra, on tensors.

Counterpart of ``blocksparse_tpu/precond.py``.  Block matrices from BEM
near-field assembly carry their natural preconditioner in their own
structure, the (block-)diagonal; this module extracts it:

- :func:`jacobi`: point-Jacobi ``M^{-1} = diag(A)^{-1}`` as a
  :class:`DiagonalOperator` (one elementwise multiply);
- :func:`block_jacobi`: the inverse of the block-diagonal part of the
  *assembled* matrix over each diagonal block's index set, as a
  :class:`~blocksparse_tpu_torch.formats.block_sparse.BlockSparseMatrix` of
  the small dense inverses, so applying it runs the same kernels as the
  operator (plus a diagonal summand for rows no diagonal block covers).

Both land on ``A.device`` and are accepted as ``M=`` by
:mod:`blocksparse_tpu_torch.solvers`.  The set-up is the JAX package's
host work: the submatrices are sliced from ``to_scipy(A)``, inverted in
float64 numpy (``pinv``, with a warning, for a singular block) and cast to
the operator's dtype.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from .core.operator import LinearOperator, as_tensor
from .formats.block_sparse import BlockSparseMatrix, _resolve_device
from .formats.symmetric import SymmetricBlockMatrix

__all__ = ["DiagonalOperator", "jacobi", "block_jacobi"]


class DiagonalOperator(LinearOperator):
    """``x -> d * x`` for a fixed diagonal vector ``d``, on ``device``: by
    default a tensor ``d`` stays on its own device and numpy goes to the
    card."""

    def __init__(self, d, *, device=None):
        if device is None and not isinstance(d, torch.Tensor):
            device = "cuda"
        d = as_tensor(d)
        self.d = d if device is None else d.to(_resolve_device(device))
        if self.d.ndim != 1:
            raise ValueError(f"diagonal must be 1-D, got ndim={self.d.ndim}")

    @property
    def shape(self):
        n = self.d.shape[0]
        return (n, n)

    @property
    def dtype(self):
        return self.d.dtype

    @property
    def device(self):
        return self.d.device

    def _apply(self, x, transpose, conj):
        d = self.d.conj() if conj else self.d
        return d * x if x.ndim == 1 else d[:, None] * x

    def __repr__(self):
        n = self.d.shape[0]
        return f"DiagonalOperator({n}x{n}, dtype={self.d.dtype})"


def _assembled(A: LinearOperator):
    from .interop.scipy_io import to_scipy

    if A.shape[0] != A.shape[1]:
        raise ValueError(f"preconditioners need a square operator, got {A.shape}")
    return to_scipy(A).tocsr()


def _np_dtype(A: LinearOperator) -> np.dtype:
    return torch.empty(0, dtype=A.dtype).numpy().dtype


def _safe_recip(d: np.ndarray) -> np.ndarray:
    """1/d with zeros mapped to 1 (identity on structurally-empty rows)."""
    out = np.ones_like(d)
    nz = d != 0
    out[nz] = 1.0 / d[nz]
    return out


def _diagonal(d: np.ndarray, A: LinearOperator) -> DiagonalOperator:
    return DiagonalOperator(d.astype(_np_dtype(A)), device=A.device)


def jacobi(A: LinearOperator) -> DiagonalOperator:
    """Point-Jacobi preconditioner ``diag(A)^{-1}`` (zeros -> identity)."""
    return _diagonal(_safe_recip(_assembled(A).diagonal()), A)


def _diagonal_candidates(A: LinearOperator):
    """Index sets of the operator's own diagonal blocks: the stored
    diagonals of a :class:`SymmetricBlockMatrix`; for the general formats,
    blocks whose row and column index lists coincide."""
    if isinstance(A, SymmetricBlockMatrix):
        return [np.asarray(A.diagonalindices(i)) for i in range(A.ndiagonals)]
    sets = []
    for i in A.eachblockindex():
        ri, ci = np.asarray(A.blockrowindices(i)), np.asarray(A.blockcolindices(i))
        if ri.shape == ci.shape and np.array_equal(ri, ci):
            sets.append(ri)
    return sets


def block_jacobi(A: LinearOperator, *, index_sets=None, **kwargs) -> LinearOperator:
    """Block-Jacobi preconditioner from the operator's diagonal blocks.

    ``M = blockdiag(A[I_k, I_k])`` over each diagonal block's index set
    ``I_k`` (overlapping contributions from *other* blocks are included:
    the submatrices are sliced from the assembled matrix, not from the
    stored block values).  Returns ``M^{-1}`` as a
    :class:`BlockSparseMatrix` of the dense inverses on ``A.device``; rows
    not covered by any diagonal block fall back to point-Jacobi through a
    :class:`DiagonalOperator` summand.

    ``index_sets`` overrides the automatic detection (any iterable of
    integer index arrays; overlapping sets are rejected).  Extra kwargs
    (``device=``, ``schedule=``, ``granularity=``, ...) pass through to the
    BlockSparseMatrix constructor.
    """
    S = _assembled(A)
    n = A.shape[0]
    sets = _diagonal_candidates(A) if index_sets is None else [
        np.asarray(s, dtype=np.int64) for s in index_sets
    ]

    covered = np.zeros(n, dtype=bool)
    blocks, rows, cols = [], [], []
    for idx in sets:
        if covered[idx].any():
            if index_sets is not None:
                raise ValueError("index_sets overlap; block-Jacobi needs disjoint sets")
            continue  # auto-detected duplicate coverage: first block wins
        covered[idx] = True
        sub = np.asarray(S[np.ix_(idx, idx)].todense())
        try:
            inv = np.linalg.inv(sub)
        except np.linalg.LinAlgError:
            warnings.warn(
                f"singular {len(idx)}x{len(idx)} diagonal block; using pseudoinverse",
                stacklevel=2,
            )
            inv = np.linalg.pinv(sub)
        blocks.append(inv.astype(_np_dtype(A)))
        rows.append(idx)
        cols.append(idx)

    if not blocks:
        return jacobi(A)

    kwargs.setdefault("device", A.device)
    M = BlockSparseMatrix(blocks, rows, cols, (n, n), **kwargs)
    if covered.all():
        return M
    d = np.where(covered, 0.0, _safe_recip(np.asarray(S.diagonal())))
    return M + _diagonal(d, A)
