"""VBCRS: variable-block compressed row storage (CSR of blocks).

Counterpart of ``blocksparse_tpu/formats/vbcrs.py``: blocks occupy
contiguous row and column ranges given by their start indices (the block's
shape gives the extent); blocks are sorted by (row start, col start) and
grouped into block rows by ``rowptr``.  ``from_block_sparse`` and
``from_symmetric`` convert the other formats (the symmetric one expands
each diagonal block once and each off-diagonal twice, as it is and
transposed).  Construction validates contiguity unless ``check=False``.

A product routes as the JAX package's ``_apply`` does, minus its
split-complex route (``split_complex`` stays as an explicit API,
``complexops.py``), after the population policy's route where one is open
(``formats/stream.py``):

  1. f32, a merged-patch plan exists and ``patch_wins`` -> the patch
     route: kernel B2 for r > 1, kernel B7 for r = 1 (``patch="always"``
     only);
  2. f32, r = 1 -> the stream route (``formats/stream.py``) where
     ``stream_plan_choice`` picks the panel plan (kernel B5, or B10 under
     ``panel="v2"``) or the slab plan (kernel B8) for V or V^T;
  3. otherwise ``apply_operand``: chunked buckets -> one launch of kernel
     B1, element buckets -> one launch of B9's element pass.

As in the JAX package the schedule is recorded but no color sets are built:
every schedule ("serial", "colored", "auto") runs the same routes.  Dtypes:
float32, float64, complex64, complex128 and bfloat16 storage; a complex
product takes route 3, whose conjugate mode carries ``V.conj()`` and
``V.H``.  Operands of another dtype, bf16 storage and the ``backend=`` /
``optimize=`` / ``scatter=`` options behave as in
:class:`~.block_sparse.BlockSparseMatrix`; scipy.sparse blocks densify
before the layout sees them (VBCRS counts dense extents, vbcrs.jl:290-296).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..core import schedule as sched
from ..core.layout import BlockLayout, build_layout, is_contiguous
from ..core.operator import LinearOperator
from ..ops.dispatch import (apply_operand, check_jax_options,
                            check_route_options)
from .block_sparse import (_PRECISIONS, BlockSparseMatrix, _resolve_device,
                           _stage, _torch_dtype, host_values, promoted_apply)
from .stream import StreamRouted
from ..utils.profiling import annotate

__all__ = ["VariableBlockCompressedRowStorage"]


def _as_start(idx, blocklen: int, axis: str, i: int, check: bool) -> int:
    """Accept either a scalar start index or a full contiguous index list."""
    a = np.asarray(idx)
    if a.ndim == 0:
        return int(a)
    a = a.ravel()
    if check:
        if not is_contiguous(a):
            raise ValueError(
                f"block {i}: {axis} indices must be a contiguous range for VBCRS"
            )
        if a.size != blocklen:
            raise ValueError(
                f"block {i}: {axis} index list length {a.size} != block extent {blocklen}"
            )
    return int(a[0]) if a.size else 0


class VariableBlockCompressedRowStorage(StreamRouted, LinearOperator):
    """CSR of blocks with variable block sizes and contiguous ranges
    (format 3).

    ``device``: the card ("cuda") unless the caller passes another.
    ``granularity``: the bucket keys, "pow2" or ``(gm, gk)`` (see
    ``core/layout.build_layout``).  ``precision``: as for
    :class:`BlockSparseMatrix` (the tier reaches kernel B2, this format's
    patch-route SpMM, and B4 through ``batched_mm``; its other products
    run IEEE fp32).
    ``patch`` ("auto" | "always" | "never") and ``panel`` ("v1" | "v2"):
    the route options of :class:`BlockSparseMatrix`; ``schedule``,
    ``scatter``, ``backend``, ``optimize`` and ``dtype`` as there.
    """

    def __init__(
        self,
        blocks: Sequence[np.ndarray],
        rowindices: Sequence,
        colindices: Sequence,
        shape: tuple[int, int] | None = None,
        *,
        device="cuda",
        dtype=None,
        precision: str | None = "highest",
        schedule: str = sched.SERIAL,
        granularity="pow2",
        backend: str = "auto",
        scatter: str = "atomic",
        optimize: str | None = None,
        check: bool = True,
        patch: str = "auto",
        panel: str = "v1",
    ):
        if shape is None:
            raise ValueError("shape=(nrows, ncols) is required")
        if precision not in _PRECISIONS:
            raise ValueError(
                f"unknown precision {precision!r}; expected one of {_PRECISIONS}")
        check_route_options(patch, panel)
        check_jax_options(backend, optimize, scatter)
        self._patch_mode, self._panel = patch, panel
        self._backend, self._scatter = backend, scatter
        self._optimize, self._granularity = optimize, granularity
        self._schedule = sched.normalize_schedule(schedule)
        self._precision = precision
        n = len(blocks)
        with annotate("bsp.construct", format="vbcrs", blocks=n):
            self._device = _resolve_device(device)
            # scipy blocks densify here: VBCRS counts dense extents
            # (vbcrs.jl:290-296), as the JAX package does
            blocks = [b.toarray() if hasattr(b, "toarray") else b
                      for b in blocks]
            (blocks,), np_dtype, bf16 = host_values([blocks], dtype)
            rstarts = np.array(
                [_as_start(rowindices[i], blocks[i].shape[0], "row", i, check)
                 for i in range(n)], dtype=np.int64)
            cstarts = np.array(
                [_as_start(colindices[i], blocks[i].shape[1], "col", i, check)
                 for i in range(n)], dtype=np.int64)

            # sort blocks by (row, col) and build rowptr in one pass
            perm = np.lexsort((cstarts, rstarts))
            blocks = [blocks[i] for i in perm]
            rstarts, cstarts = rstarts[perm], cstarts[perm]
            rowptr, blockrow_starts = [0], []
            for i in range(n):
                if i == 0 or rstarts[i] != rstarts[i - 1]:
                    if i:
                        rowptr.append(i)
                    blockrow_starts.append(int(rstarts[i]))
            rowptr.append(n)
            self._rowptr = tuple(rowptr)
            self._blockrow_starts = tuple(blockrow_starts)
            self._row_starts = tuple(int(v) for v in rstarts)
            self._col_starts = tuple(int(v) for v in cstarts)

            rlists = [np.arange(r, r + b.shape[0])
                      for r, b in zip(rstarts, blocks)]
            clists = [np.arange(c, c + b.shape[1])
                      for c, b in zip(cstarts, blocks)]
            self._layout = build_layout(blocks, rlists, clists, shape,
                                        granularity=granularity,
                                        dtype=np_dtype)
            self._dtype = _torch_dtype([self._layout], dtype, bf16)
            self._buckets = _stage(self._layout, self._device,
                                   torch.bfloat16 if bf16 else None)
            self._patch = None
            self._stream = {}

    # -- converters ---------------------------------------------------------
    @classmethod
    def from_block_sparse(cls, bsm, *, schedule=None, granularity="pow2",
                          **kwargs):
        """Convert a BlockSparseMatrix (blocks must have contiguous ranges);
        ``kwargs`` (``device``, ``dtype``, ``patch``, ``panel``, ...) go to
        the constructor, the device, the dtype and the two route options
        defaulting to ``bsm``'s."""
        n = bsm.nblocks
        for key in ("device", "dtype", "patch", "panel"):
            kwargs.setdefault(key, getattr(bsm, key))
        return cls(
            [bsm.block(i) for i in range(n)],
            [bsm.blockrowindices(i) for i in range(n)],
            [bsm.blockcolindices(i) for i in range(n)],
            bsm.shape,
            schedule=schedule if schedule is not None else bsm.schedule,
            granularity=granularity, **kwargs,
        )

    @classmethod
    def from_symmetric(cls, sbm, *, schedule=None, granularity="pow2",
                       **kwargs):
        """Expand a SymmetricBlockMatrix: diagonals once, off-diagonals twice
        (as they are and transposed); ``kwargs`` as in
        :meth:`from_block_sparse`, defaulting to ``sbm``'s."""
        blocks, rows, cols = [], [], []
        for i in range(sbm.ndiagonals):
            blocks.append(sbm.diagonal(i))
            rows.append(sbm.diagonalindices(i))
            cols.append(sbm.diagonalindices(i))
        for i in range(sbm.noffdiagonals):
            o = sbm.offdiagonal(i)
            r, c = sbm.blockrowindices(i), sbm.blockcolindices(i)
            blocks += [o, o.T]
            rows += [r, c]
            cols += [c, r]
        for key in ("device", "dtype", "patch", "panel"):
            kwargs.setdefault(key, getattr(sbm, key))
        return cls(
            blocks, rows, cols, sbm.shape,
            schedule=schedule if schedule is not None else sbm.schedule,
            granularity=granularity, **kwargs,
        )

    # -- properties ---------------------------------------------------------
    @property
    def shape(self) -> tuple[int, int]:
        return (self._layout.nrows, self._layout.ncols)

    @property
    def dtype(self) -> torch.dtype:
        return self._dtype

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def precision(self):
        return self._precision

    @property
    def layout(self) -> BlockLayout:
        return self._layout

    @property
    def schedule(self) -> str:
        return self._schedule

    patch = BlockSparseMatrix.patch
    panel = BlockSparseMatrix.panel

    @property
    def nblocks(self) -> int:
        return self._layout.nblocks

    @property
    def nblockrows(self) -> int:
        return len(self._rowptr) - 1

    @property
    def rowptr(self) -> tuple[int, ...]:
        return self._rowptr

    @property
    def blockrow_starts(self) -> tuple[int, ...]:
        return self._blockrow_starts

    @property
    def nnz(self) -> int:
        """Dense extents of all blocks."""
        return self._layout.nnz

    # -- reference API parity ----------------------------------------------
    def eachblockindex(self):
        return range(self.nblocks)

    def block(self, i: int) -> np.ndarray:
        """Dense block ``i`` (host copy of the construction values)."""
        return self._layout.extract_block(i)

    def blockrowindices(self, i: int) -> np.ndarray:
        return self._layout.rowindices[i]

    def blockcolindices(self, i: int) -> np.ndarray:
        return self._layout.colindices[i]

    def row_start(self, i: int) -> int:
        return self._row_starts[i]

    def col_start(self, i: int) -> int:
        return self._col_starts[i]

    # -- compute ------------------------------------------------------------
    # the lazy merged-patch plan of the general format, on the same fields
    # (VBCRS ranges are contiguous by construction: only f32 gates it)
    _patch_for = BlockSparseMatrix._patch_for
    _patch_entry = BlockSparseMatrix._patch_entry
    _patch_run = BlockSparseMatrix._patch_run

    def _apply(self, x, transpose: bool, conj: bool):
        return promoted_apply(self._apply_routes, x, self._device,
                              self._dtype, transpose, conj)

    def _bucket_apply(self, x, transpose: bool, conj: bool):
        return apply_operand(self._buckets, self._layout,
                             self.shape[1] if transpose else self.shape[0], x,
                             transpose=transpose, conj=conj,
                             scatter=self._scatter)

    def __repr__(self):
        m, n = self.shape
        return (
            f"VariableBlockCompressedRowStorage({m}x{n}, {self.nblocks} blocks "
            f"in {self.nblockrows} block rows, nnz={self.nnz}, "
            f"dtype={self.dtype}, device={self._device}, "
            f"schedule={self._schedule!r}, patch={self._patch_mode!r}, "
            f"panel={self._panel!r})"
        )
