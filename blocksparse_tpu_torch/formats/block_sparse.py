"""General block-sparse format: dense blocks at arbitrary index lists.

Counterpart of ``blocksparse_tpu/formats/block_sparse.py``: dense blocks
placed at arbitrary -- possibly non-contiguous, possibly overlapping --
row/column index lists inside an (M, N) matrix.  Overlapping blocks sum.

The host layout (``core/layout.py``) packs the blocks into shape buckets
(``granularity``: "pow2" or ``(gm, gk)``); the buckets are staged on the
operator's ``device`` at construction.  A product routes as the JAX
package's ``_apply`` does, minus its split-complex route (a TPU
workaround; ``split_complex`` stays as an explicit API,
``complexops.py``):

  1. f32, a merged-patch plan exists and ``patch_wins`` -> the patch
     route: the SpMM kernel B2 for r > 1, the SpMV kernel B7 for r = 1
     (``patch="always"`` only);
  2. f32, r = 1 -> the stream route (``formats/stream.py``) where
     ``stream_plan_choice`` picks the panel plan (kernel B5, or B10 on the
     v2 plan under ``panel="v2"``) or the slab plan (kernel B8) for A or
     A^T;
  3. otherwise ``apply_operand``: chunked buckets -> one launch of kernel
     B1, element buckets -> one launch of B9's element pass (colored
     gather rounds under ``schedule="colored"`` where they win, with
     ``colors`` forward and ``transposecolors`` for transpose products).

Dtypes: float32, float64, complex64 and complex128.  A complex product
takes route 3 (the others are f32), in B1's and the element pass's complex
instances, whose conjugate mode carries ``A.conj()`` and ``A.H``.  The
operand's dtype must equal the operator's.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .. import coloring
from ..core import schedule as sched
from ..core.layout import BlockLayout, build_layout
from ..core.operator import LinearOperator
from ..ops.dispatch import (StagedBuckets, apply_operand,
                            check_route_options, patch_eligible, patch_wins,
                            strip_eligible)
from .stream import StreamRouted

__all__ = ["BlockSparseMatrix"]

_PRECISIONS = ("highest", "high", None)
_DTYPES = {np.dtype(np.float32): torch.float32,
           np.dtype(np.float64): torch.float64,
           np.dtype(np.complex64): torch.complex64,
           np.dtype(np.complex128): torch.complex128}


def _colors_tuple(colors) -> tuple[tuple[int, ...], ...]:
    return tuple(tuple(int(b) for b in group) for group in colors)


def _np_dtype(dtype):
    if dtype is None:
        return None
    if isinstance(dtype, torch.dtype):
        return torch.empty(0, dtype=dtype).numpy().dtype
    return np.dtype(dtype)


def _torch_dtype(layouts, dtype) -> torch.dtype:
    """The operator's dtype: its first stored bucket's, else ``dtype``, else
    float64; float32, float64, complex64 or complex128."""
    vals = [b.values.dtype for lay in layouts for b in lay.buckets]
    np_dt = np.dtype(vals[0] if vals else (_np_dtype(dtype) or np.float64))
    if np_dt not in _DTYPES:
        raise NotImplementedError(
            f"dtype {np_dt} is not ported yet: the port takes float32, "
            "float64, complex64 and complex128 (bf16 storage: ROADMAP)")
    return _DTYPES[np_dt]


def _resolve_device(device) -> torch.device:
    """The concrete device an operator's tensors land on ("cuda" resolves
    to the current card).  A CUDA device with no card present raises: the
    CPU is used only when the caller asks for it."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card is available; operators are built on the card "
            "unless the caller passes device='cpu'")
    return torch.empty(0, device=device).device


def _check_operand(x: torch.Tensor, device, dtype) -> None:
    if x.device != device:
        raise ValueError(
            f"operand on {x.device}, operator on {device}; move one of them "
            "explicitly")
    if x.dtype != dtype:
        raise TypeError(f"operand dtype {x.dtype} != operator dtype {dtype}")


def _stage(layout: BlockLayout, device) -> StagedBuckets:
    """Per bucket: (values, row_idx, col_idx, row_chunk, col_chunk) on
    ``device`` (the chunk tables None for element buckets)."""
    def dev(a):
        return None if a is None else torch.from_numpy(
            np.ascontiguousarray(a)).to(device)
    return StagedBuckets((dev(b.values), dev(b.row_idx), dev(b.col_idx),
                          dev(b.row_chunk_idx), dev(b.col_chunk_idx))
                         for b in layout.buckets)


class BlockSparseMatrix(StreamRouted, LinearOperator):
    """General block-sparse matrix (format 1).

    ``device``: where the operator's tensors live, the card ("cuda") unless
    the caller passes another (``"cpu"`` runs the kernels' plain versions).
    ``precision``: "highest" | "high" | None, the JAX package's tiers.  On
    this format the tier reaches kernel B2 (the patch-route SpMM, its
    transpose and their gradients: 3xTF32 for "highest" and "high", one
    TF32 pass for None) and B4 through ``batched_mm``; its other products (B1 and the SpMV
    kernels) run IEEE fp32 at every tier (see ``ops/patch_engine.py``).
    ``granularity``: the bucket keys, "pow2" or ``(gm, gk)`` (see
    ``core/layout.build_layout``).  ``patch``: "auto" (the route decision), "always" (every f32 product
    takes the patch route where a plan exists, r = 1 included) or "never"
    -- the JAX package's ``BST_PATCH``.  ``panel``: "v1" or "v2", the panel
    plans the stream route builds -- the JAX package's ``BST_PANEL_IMPL``.
    """

    def __init__(
        self,
        blocks: Sequence[np.ndarray],
        rowindices: Sequence[np.ndarray],
        colindices: Sequence[np.ndarray],
        shape: tuple[int, int] | None = None,
        *,
        device="cuda",
        dtype=None,
        precision: str | None = "highest",
        schedule: str = sched.SERIAL,
        granularity="pow2",
        patch: str = "auto",
        panel: str = "v1",
    ):
        if shape is None:
            raise ValueError("shape=(nrows, ncols) is required")
        if precision not in _PRECISIONS:
            raise ValueError(
                f"unknown precision {precision!r}; expected one of {_PRECISIONS}")
        check_route_options(patch, panel)
        self._patch_mode, self._panel = patch, panel
        self._device = _resolve_device(device)
        self._schedule = sched.normalize_schedule(schedule)
        self._precision = precision
        self._layout = build_layout(blocks, rowindices, colindices, shape,
                                    granularity=granularity,
                                    dtype=_np_dtype(dtype))
        self._dtype = _torch_dtype([self._layout], dtype)
        self._buckets = _stage(self._layout, self._device)
        if sched.isserial(self._schedule):
            all_ids = tuple(range(self._layout.nblocks))
            self._colors = self._tcolors = (all_ids,) if all_ids else ()
        else:
            self._colors = _colors_tuple(
                coloring.color_blocks(self._layout.rowindices))
            self._tcolors = _colors_tuple(
                coloring.color_blocks(self._layout.colindices))
        self._patch = None
        self._stream = {}

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

    @property
    def patch(self) -> str:
        """The ``patch=`` option: "auto", "always" or "never"."""
        return self._patch_mode

    @property
    def panel(self) -> str:
        """The ``panel=`` option: "v1" or "v2"."""
        return self._panel

    @property
    def nblocks(self) -> int:
        return self._layout.nblocks

    @property
    def nnz(self) -> int:
        """Logical nnz: sum of unpadded block areas."""
        return self._layout.nnz

    # -- reference API parity ----------------------------------------------
    def eachblockindex(self):
        return range(self._layout.nblocks)

    def block(self, i: int) -> np.ndarray:
        """Unpadded dense block ``i`` (host copy of the construction values)."""
        return self._layout.extract_block(i)

    def blockrowindices(self, i: int) -> np.ndarray:
        return self._layout.rowindices[i]

    def blockcolindices(self, i: int) -> np.ndarray:
        return self._layout.colindices[i]

    def colors(self) -> tuple[tuple[int, ...], ...]:
        """Row-conflict colors; one color holding every block when serial."""
        return self._colors

    def transposecolors(self) -> tuple[tuple[int, ...], ...]:
        """Column-conflict colors; one color holding every block when serial."""
        return self._tcolors

    # -- compute ------------------------------------------------------------
    def _patch_for(self):
        """Lazy merged-patch plan and its device tensors; None if ineligible
        (non-contiguous lists or non-f32).  Transpose products reuse the same
        plan with the gather/scatter roles swapped."""
        if self._patch is None:
            from ..core.patch import build_patch_plan
            from ..ops.patch_engine import patch_device_arrays

            plan = build_patch_plan(self._layout)
            self._patch = (plan, None if plan is None
                           else patch_device_arrays(plan, self._device))
        return None if self._patch[0] is None else self._patch

    def _apply(self, x, transpose: bool, conj: bool):
        _check_operand(x, self._device, self._dtype)
        out_len = self.shape[1] if transpose else self.shape[0]
        r = 1 if x.ndim == 1 else x.shape[1]
        if patch_eligible(x, self._dtype, self._patch_mode):
            entry = self._patch_for()
            if entry is not None and patch_wins(
                    entry[0], [(self._layout, 1)], r, self._patch_mode):
                from ..ops.patch_engine import patch_apply

                return patch_apply(entry[0], entry[1], x, transpose=transpose,
                                   precision=self._precision)
        # the patch and stream routes are f32: conj changes nothing there
        if strip_eligible(x, self._dtype):
            y = self._stream_apply(x, transpose)
            if y is not None:
                return y
        colors = None
        if not sched.isserial(self._schedule):
            colors = self._tcolors if transpose else self._colors
        return apply_operand(self._buckets, self._layout, out_len, x,
                             transpose=transpose, conj=conj, colors=colors)

    def __repr__(self):
        m, n = self.shape
        return (
            f"BlockSparseMatrix({m}x{n}, {self.nblocks} blocks, "
            f"{len(self._buckets)} buckets, nnz={self.nnz}, dtype={self.dtype}, "
            f"device={self._device}, schedule={self._schedule!r}, "
            f"patch={self._patch_mode!r}, panel={self._panel!r})"
        )
