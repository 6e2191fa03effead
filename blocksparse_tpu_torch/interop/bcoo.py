"""COO interop, under the JAX package's names.

Counterpart of ``blocksparse_tpu/interop/bcoo.py``, whose general sparse
type is ``jax.experimental.sparse.BCOO``; here it is a 2-D
``torch.sparse_coo_tensor``.  ``to_bcoo`` assembles one from any block
format or lazy wrapper, coalesced (duplicate entries of overlapping blocks
summed, indices sorted row-major: the counterpart of
``BCOO.sum_duplicates().sort_indices()``); ``from_bcoo`` re-blocks one,
coalesced or not, into a :class:`BlockSparseMatrix` through
``from_scipy_blocks``.  Neither runs a sparse product.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.operator import LinearOperator
from ..formats.block_sparse import BlockSparseMatrix
from .scipy_io import from_scipy_blocks, rowcolvals

__all__ = ["to_bcoo", "from_bcoo"]


def to_bcoo(A: LinearOperator) -> torch.Tensor:
    """``A`` as a coalesced 2-D ``torch.sparse_coo_tensor`` of ``A.dtype``
    on ``A.device``, assembled from the host copy of its blocks."""
    r, c, v = rowcolvals(A)
    idx = torch.from_numpy(np.stack([np.asarray(r, np.int64),
                                     np.asarray(c, np.int64)]))
    vals = torch.from_numpy(np.ascontiguousarray(v)).to(A.dtype)
    return torch.sparse_coo_tensor(idx, vals, tuple(A.shape),
                                   check_invariants=True).coalesce().to(
        A.device)


def from_bcoo(mat: torch.Tensor, block_size, *, dtype=None,
              **kwargs) -> BlockSparseMatrix:
    """Re-block a 2-D sparse COO tensor into a :class:`BlockSparseMatrix`
    of uniform ``block_size`` tiles (an int or a ``(rows, cols)`` pair;
    nonempty tiles only; duplicates summed).  ``dtype`` defaults to the
    tensor's values'; ``kwargs`` (``device``, ``schedule``, ``backend``, ...) go to
    the constructor."""
    import scipy.sparse as sp

    if not (isinstance(mat, torch.Tensor) and mat.layout == torch.sparse_coo
            and mat.sparse_dim() == 2 and mat.dense_dim() == 0):
        raise ValueError("from_bcoo takes a 2-D torch.sparse_coo_tensor "
                         "(no dense dimensions)")
    idx = mat._indices().cpu().numpy()
    vals = mat._values().detach().cpu()
    if vals.dtype == torch.bfloat16:
        vals = vals.float()  # exact; the operator stores bf16 again
        dtype = torch.bfloat16 if dtype is None else dtype
    S = sp.coo_array((vals.numpy(), (idx[0], idx[1])), shape=tuple(mat.shape))
    return from_scipy_blocks(S, block_size, dtype=dtype, **kwargs)
