"""Split-complex execution: a complex operator as a pair of real ones.

Counterpart of ``blocksparse_tpu/complexops.py``.  With

    M = R + i I,   x = xr + i xi
    M @ x = (R xr - I xi) + i (I xr + R xi)

a complex product is four real products; ``M.T`` passes the transpose to
both children and ``conj`` flips the sign of ``I``.

On the card a complex operator does not need this: its products run
natively, in the complex instances of kernels B1 and B9's element pass
(``ops/dispatch.py``), which read each complex value once.  The split form
stays as an explicit API: :func:`split_complex` builds it from any complex
format operator, and its children are real port operators, so each of the
four products takes that operator's real route (at f32 r = 1 the stream
kernels B5 / B10 / B8 or B7, at f32 r > 1 the patch kernels B2 / B3, at
f64 the bucket route) at the operator's precision tier.  ``mv_split`` /
``mm_split`` take and return real (re, im) pairs.  The JAX package's
automatic split route and its pytree registration have no counterpart.
"""

from __future__ import annotations

import torch

from .core.operator import LinearOperator, as_tensor
from .formats.block_sparse import BlockSparseMatrix
from .formats.symmetric import SymmetricBlockMatrix
from .formats.vbcrs import VariableBlockCompressedRowStorage

__all__ = ["ComplexSplitOperator", "split_complex"]

_COMPLEX_OF = {torch.float32: torch.complex64, torch.float64: torch.complex128}
_INHERITED = ("schedule", "device", "precision", "patch", "panel")


def split_complex(op, **kwargs) -> "ComplexSplitOperator":
    """The split re/im pair of a complex format operator.

    ``kwargs`` (``device``, ``precision``, ``granularity``, ``schedule``,
    ``patch``, ``panel``, ...) go to the real constructors; ``schedule``,
    ``device``, ``precision``, ``patch`` and ``panel`` default to ``op``'s
    own.
    """
    if not isinstance(op, (SymmetricBlockMatrix, BlockSparseMatrix,
                           VariableBlockCompressedRowStorage)):
        raise TypeError(
            f"split_complex: unsupported operator {type(op).__name__}")
    for key in _INHERITED:
        kwargs.setdefault(key, getattr(op, key))

    def parts(get_block, n):
        blocks = [get_block(i) for i in range(n)]
        return ([b.real.copy() for b in blocks],
                [b.imag.copy() for b in blocks])

    if isinstance(op, SymmetricBlockMatrix):
        dre, dim = parts(op.diagonal, op.ndiagonals)
        ore, oim = parts(op.offdiagonal, op.noffdiagonals)
        di = [op.diagonalindices(i) for i in range(op.ndiagonals)]
        ri = [op.blockrowindices(i) for i in range(op.noffdiagonals)]
        ci = [op.blockcolindices(i) for i in range(op.noffdiagonals)]
        re = SymmetricBlockMatrix(dre, di, ore, ri, ci, op.shape, **kwargs)
        im = SymmetricBlockMatrix(dim, di, oim, ri, ci, op.shape, **kwargs)
    else:
        bre, bim = parts(op.block, op.nblocks)
        rows = [op.blockrowindices(i) for i in range(op.nblocks)]
        cols = [op.blockcolindices(i) for i in range(op.nblocks)]
        cls = type(op)
        re = cls(bre, rows, cols, op.shape, **kwargs)
        im = cls(bim, rows, cols, op.shape, **kwargs)
    return ComplexSplitOperator(re, im)


class ComplexSplitOperator(LinearOperator):
    """A complex operator stored as two real operators (re, im) of one
    shape, dtype and device."""

    def __init__(self, re_op: LinearOperator, im_op: LinearOperator):
        if re_op.shape != im_op.shape:
            raise ValueError(f"re/im shape mismatch: {re_op.shape} vs "
                             f"{im_op.shape}")
        if re_op.dtype != im_op.dtype or re_op.dtype not in _COMPLEX_OF:
            raise TypeError(f"re/im must share a real dtype, got "
                            f"{re_op.dtype} and {im_op.dtype}")
        self.re_op = re_op
        self.im_op = im_op

    @property
    def shape(self):
        return self.re_op.shape

    @property
    def dtype(self) -> torch.dtype:
        return _COMPLEX_OF[self.re_op.dtype]

    @property
    def device(self) -> torch.device:
        return self.re_op.device

    @property
    def schedule(self):
        return self.re_op.schedule

    # -- the split API: real tensors in and out ------------------------------
    def apply_split(self, xr, xi, *, transpose: bool = False,
                    conj: bool = False):
        """``(yr, yi)`` of the mode's product with ``xr + i xi``, all real:
        four real products."""
        sign = -1.0 if conj else 1.0
        r, m = self.re_op, self.im_op
        yr = r._apply(xr, transpose, False) - sign * m._apply(xi, transpose,
                                                              False)
        yi = sign * m._apply(xr, transpose, False) + r._apply(xi, transpose,
                                                              False)
        return yr, yi

    def mv_split(self, xr, xi):
        return self.apply_split(as_tensor(xr), as_tensor(xi))

    def mm_split(self, Xr, Xi):
        return self.apply_split(as_tensor(Xr), as_tensor(Xi))

    # -- complex operands -----------------------------------------------------
    def _apply(self, x, transpose, conj):
        if x.dtype != self.dtype:
            raise TypeError(f"operand dtype {x.dtype} != operator dtype "
                            f"{self.dtype}")
        x = x.resolve_conj()
        yr, yi = self.apply_split(x.real.contiguous(), x.imag.contiguous(),
                                  transpose=transpose, conj=conj)
        return torch.complex(yr, yi)

    def __repr__(self):
        return f"ComplexSplitOperator(re={self.re_op!r}, im={self.im_op!r})"
