"""Symmetric block-sparse format: off-diagonal blocks stored once.

Counterpart of ``blocksparse_tpu/formats/symmetric.py``.  Diagonal blocks
sit at ``diagonalindices``; each off-diagonal block is stored once and
applied twice, as it is to ``y[rowindices]`` and transposed to
``y[colindices]``, so the matrix is

    S = D + O + O^T        (O = off-diagonal blocks at (rows, cols))

and S^T = D^T + O + O^T: only the diagonal pass transposes.  S is complex
symmetric, not Hermitian, so ``S.H @ x = conj(S) @ x``: under the
conjugate flag both passes read conjugated values, the diagonal's also
transposed under ``transpose``.  Dtypes: float32, float64, complex64,
complex128 and bfloat16 storage; a complex product takes route 3 below, and
so does every product whose operator or compute dtype is not float32.
Operands of another dtype, bf16 storage and the ``backend=`` /
``optimize=`` options behave as in :class:`~.block_sparse.
BlockSparseMatrix`; as in the JAX package this format has no ``scatter=``
(its off-diagonal pass is the symmetric one, which the sorted scatter does
not cover).

As in the JAX package, all four color sets are computed at construction
whatever the schedule, and the default schedule is "colored".  A product
routes as the JAX package's ``_apply`` does, minus its split-complex route
(``split_complex`` stays as an explicit API, ``complexops.py``), after the
population policy's route where one is open (``formats/stream.py``):

  1. f32, a symmetric patch plan exists and ``patch_wins`` -> the
     symmetric patch route on the plan for S or, with the transposed
     diagonal embedded, for S^T: kernel B3 for r > 1, kernel B7's one-read
     mode for r = 1 (``patch="always"`` only);
  2. f32, r = 1 -> the stream route (``formats/stream.py``) where
     ``stream_plan_choice`` picks the symmetric panel plan (kernel B5, or
     B10 under ``panel="v2"``: fused with the mirror pass, or expanded) or
     the unified slab plan (kernel B8 with its mirror pass), each for S or,
     with the transposed diagonal, for S^T;
  3. otherwise ``apply_symmetric``: the diagonal -> ``apply_operand``,
     chunked off-diagonal buckets -> one launch of kernel B1 in symmetric
     mode, element off-diagonal buckets -> one launch of B9's element pass
     in symmetric mode (the colored element route over ``fusedcolors``
     where its plan wins: two products launches and one rounds launch).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .. import coloring
from ..core import schedule as sched
from ..core.layout import build_layout
from ..core.operator import LinearOperator
from ..core.strip import plan_symmetric
from ..ops.dispatch import (apply_symmetric, check_jax_options,
                            check_route_options)
from ..ops.panel_router import panel_plan_sym, route_bytes
from .block_sparse import (_PRECISIONS, BlockSparseMatrix, _colors_tuple,
                           _resolve_device, _stage, _torch_dtype, host_values,
                           promoted_apply)
from .stream import StreamRouted
from ..utils.profiling import annotate

__all__ = ["SymmetricBlockMatrix"]


class SymmetricBlockMatrix(StreamRouted, LinearOperator):
    """Symmetric block-sparse matrix (format 2).

    ``device``: the card ("cuda") unless the caller passes another.
    ``granularity``: the bucket keys, "pow2" or ``(gm, gk)`` (see
    ``core/layout.build_layout``).  ``precision``: "highest" | "high" |
    None, the tier of the r > 1 products on kernel B3 (3xTF32 for
    "highest" and "high", one TF32 pass for None; the JAX package's tiers);
    every other route runs IEEE precision.  ``patch`` ("auto" | "always" |
    "never") and ``panel`` ("v1" | "v2"): the route options of
    :class:`BlockSparseMatrix`; ``schedule`` ("colored", "serial" or
    "auto"), ``backend``, ``optimize`` and ``dtype`` as there.
    """

    def __init__(
        self,
        diagonals: Sequence[np.ndarray],
        diagonalindices: Sequence[np.ndarray],
        offdiagonals: Sequence[np.ndarray],
        rowindices: Sequence[np.ndarray],
        colindices: Sequence[np.ndarray],
        shape: tuple[int, int] | None = None,
        *,
        device="cuda",
        dtype=None,
        precision: str | None = "highest",
        schedule: str = sched.COLORED,
        granularity="pow2",
        backend: str = "auto",
        optimize: str | None = None,
        patch: str = "auto",
        panel: str = "v1",
    ):
        if shape is None:
            raise ValueError("shape=(nrows, ncols) is required")
        if shape[0] != shape[1]:
            raise ValueError(f"symmetric matrix must be square, got {shape}")
        if precision not in _PRECISIONS:
            raise ValueError(
                f"unknown precision {precision!r}; expected one of {_PRECISIONS}")
        check_route_options(patch, panel)
        check_jax_options(backend, optimize)
        self._patch_mode, self._panel = patch, panel
        self._backend, self._optimize = backend, optimize
        self._granularity = granularity
        self._schedule = sched.normalize_schedule(schedule)
        self._precision = precision
        with annotate("bsp.construct", format="symmetric",
                      blocks=len(diagonals) + len(offdiagonals)):
            self._device = _resolve_device(device)
            (diagonals, offdiagonals), np_dtype, bf16 = host_values(
                [diagonals, offdiagonals], dtype)
            self._dlayout = build_layout(diagonals, diagonalindices,
                                         diagonalindices, shape,
                                         granularity=granularity,
                                         dtype=np_dtype)
            self._olayout = build_layout(offdiagonals, rowindices, colindices,
                                         shape, granularity=granularity,
                                         dtype=np_dtype)
            self._dtype = _torch_dtype([self._dlayout, self._olayout], dtype,
                                       bf16)
            stored = torch.bfloat16 if bf16 else None
            self._dbuckets = _stage(self._dlayout, self._device, stored)
            self._obuckets = _stage(self._olayout, self._device, stored)
            self._dcolors = _colors_tuple(
                coloring.color_blocks(self._dlayout.rowindices))
            self._ocolors = _colors_tuple(
                coloring.color_blocks(self._olayout.rowindices))
            self._tocolors = _colors_tuple(
                coloring.color_blocks(self._olayout.colindices))
            # union row+col conflicts: the one-read pass scatters into both
            self._fused_colors = _colors_tuple(coloring.color_blocks(
                [np.concatenate([r, c]) for r, c in
                 zip(self._olayout.rowindices, self._olayout.colindices)]))
            self._patch = {}
            self._stream = {}

    # -- properties ---------------------------------------------------------
    @property
    def shape(self) -> tuple[int, int]:
        return (self._dlayout.nrows, self._dlayout.ncols)

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
    def schedule(self) -> str:
        return self._schedule

    patch = BlockSparseMatrix.patch
    panel = BlockSparseMatrix.panel

    @property
    def ndiagonals(self) -> int:
        return self._dlayout.nblocks

    @property
    def noffdiagonals(self) -> int:
        return self._olayout.nblocks

    @property
    def nnz(self) -> int:
        """Logical nnz, off-diagonals counted twice."""
        return self._dlayout.nnz + 2 * self._olayout.nnz

    # -- reference API parity ----------------------------------------------
    def diagonal(self, i: int) -> np.ndarray:
        return self._dlayout.extract_block(i)

    def offdiagonal(self, i: int) -> np.ndarray:
        return self._olayout.extract_block(i)

    def diagonalindices(self, i: int) -> np.ndarray:
        return self._dlayout.rowindices[i]

    def blockrowindices(self, i: int) -> np.ndarray:
        return self._olayout.rowindices[i]

    def blockcolindices(self, i: int) -> np.ndarray:
        return self._olayout.colindices[i]

    def diagonalcolors(self):
        return self._dcolors

    def offdiagonalcolors(self):
        return self._ocolors

    def transposeoffdiagonalcolors(self):
        return self._tocolors

    def fusedcolors(self):
        """Colors on the union of row+col index sets (the one-read pass)."""
        return self._fused_colors

    # -- compute ------------------------------------------------------------
    def _patch_for(self, transpose: bool):
        """Lazy symmetric merged-patch plan for S (``transpose`` False) or
        S^T (the transposed diagonal embedded) and its device tensors; None
        if ineligible (non-contiguous lists or non-f32).  Span
        ``bsp.plan.patch``."""
        if transpose not in self._patch:
            from ..core.patch import build_patch_plan
            from ..ops.patch_engine import patch_device_arrays

            with annotate("bsp.plan.patch", transpose=int(transpose),
                          blocks=self._dlayout.nblocks
                          + self._olayout.nblocks):
                plan = build_patch_plan(self._dlayout,
                                        extra_layout=self._olayout,
                                        transpose_main=transpose,
                                        optimize=self._optimize)
                self._patch[transpose] = (
                    plan, None if plan is None
                    else patch_device_arrays(plan, self._device))
        entry = self._patch[transpose]
        return None if entry[0] is None else entry

    def _build_panel(self, transpose: bool):
        return panel_plan_sym(self._dlayout, self._olayout,
                              transpose_diag=transpose, impl=self._panel)

    def _build_strip(self, transpose: bool):
        return plan_symmetric(self._dlayout, self._olayout,
                              transpose_diag=transpose)

    def _panel_bytes(self, plan):
        # the H100 rule's cost, by which panel_plan_sym picked the plan
        return route_bytes(plan)

    def _stream_reads(self):
        # the bucket route reads each stored off-diagonal twice in the JAX
        # package's cost model; the fused streams read it once
        return [(self._dlayout, 1), (self._olayout, 2)]

    _patch_entry = _patch_for

    def _patch_run(self, entry, x, transpose: bool):
        from ..ops.patch_engine import patch_apply

        # the plan embeds S or S^T; it is applied as it is
        return patch_apply(entry[0], entry[1], x, precision=self._precision)

    def _apply(self, x, transpose: bool, conj: bool):
        return promoted_apply(self._apply_routes, x, self._device,
                              self._dtype, transpose, conj)

    def _bucket_apply(self, x, transpose: bool, conj: bool):
        colored = not sched.isserial(self._schedule)
        return apply_symmetric(
            self._dbuckets, self._dlayout, self._obuckets, self._olayout,
            self.shape[0], x, transpose=transpose, conj=conj,
            diag_colors=self._dcolors if colored else None,
            fused_colors=self._fused_colors if colored else None)

    def __repr__(self):
        m, n = self.shape
        return (
            f"SymmetricBlockMatrix({m}x{n}, {self.ndiagonals} diagonal + "
            f"{self.noffdiagonals} off-diagonal blocks, nnz={self.nnz}, "
            f"dtype={self.dtype}, device={self._device}, "
            f"schedule={self._schedule!r}, patch={self._patch_mode!r}, "
            f"panel={self._panel!r})"
        )
