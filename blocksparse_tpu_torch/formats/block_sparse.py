"""General block-sparse format: dense blocks at arbitrary index lists.

Counterpart of ``blocksparse_tpu/formats/block_sparse.py``: dense blocks
placed at arbitrary -- possibly non-contiguous, possibly overlapping --
row/column index lists inside an (M, N) matrix.  Overlapping blocks sum.

The host layout (``core/layout.py``) packs the blocks into shape buckets
(``granularity``: "pow2" or ``(gm, gk)``); the buckets are staged on the
operator's ``device`` at construction.  A product routes as the JAX
package's ``_apply`` does, minus its split-complex route (a TPU
workaround; ``split_complex`` stays as an explicit API,
``complexops.py``), after the route the population policy records for the
operator's blocks where one is open (``utils/autotune.py``,
``formats/stream.py``):

  1. f32, a merged-patch plan exists and ``patch_wins`` -> the patch
     route: the SpMM kernel B2 for r > 1, the SpMV kernel B7 for r = 1
     (``patch="always"`` only);
  2. f32, r = 1 -> the stream route (``formats/stream.py``) where
     ``stream_plan_choice`` picks the panel plan (kernel B5, or B10 on the
     v2 plan under ``panel="v2"``) or the slab plan (kernel B8) for A or
     A^T;
  3. otherwise ``apply_operand``: chunked buckets -> one launch of kernel
     B1, element buckets -> one launch of B9's element pass (the colored
     element route under ``schedule="colored"`` where its plan wins: a
     products pass and one launch of B9's colored rounds, with ``colors``
     forward and ``transposecolors`` for transpose products).

Dtypes: float32, float64, complex64, complex128 and bfloat16 storage.  A
complex product takes route 3 (the others are f32), in B1's and the
element pass's complex instances, whose conjugate mode carries ``A.conj()``
and ``A.H``.  bf16 values (``dtype=torch.bfloat16`` or ``"bfloat16"``, or
blocks given as torch bf16 tensors or ml_dtypes bf16 arrays) are staged on
the device as bf16; the host layout holds their exact float32 copies
(numpy has no bf16), so ``block(i)`` returns float32.

Operands of another dtype (:func:`promoted_apply`): the product comes out in
``torch.promote_types(operator dtype, operand dtype)``, as in the JAX
package.  An integer, bool or float16 operand is cast to that type; a
float64 operand on a float32 operator and a complex128 one on a complex64
operator run the kernels' mixed instances (values widened in registers, no
widened copy stored); a complex operand on a real operator runs one real
product of ``torch.view_as_real(x)`` as ``[n, 2r]``; a real operand on a
complex operator is cast.  Any product whose compute dtype or operator
dtype is not float32 takes route 3.

The JAX constructors' ``backend=`` ("auto" | "xla" | "pallas" |
"pallas-interpret") chose a TPU engine; here it is validated, stored and
saved (``interop/serialize.py``) and changes no route
(``ops/dispatch.py``).  ``optimize=`` ("auto" | "latency" | "throughput" |
None) is the merged-patch plan's grid-group bias, as there.  ``scatter=`` ("atomic" | "sorted") picks the
element buckets' pass: B9's element pass, or its owner mode (bit-identical
from run to run; the chunked buckets still add with B1's atomics).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .. import coloring
from ..core import schedule as sched
from ..core.layout import BlockLayout, build_layout
from ..core.operator import LinearOperator
from ..ops.dispatch import (StagedBuckets, apply_operand, check_jax_options,
                            check_route_options)
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


def is_bf16(dtype) -> bool:
    """``dtype`` names bfloat16: ``torch.bfloat16``, ``"bfloat16"``, or the
    numpy dtype or scalar type of an ml_dtypes bf16 (recognised by name;
    the port does not import ml_dtypes)."""
    if isinstance(dtype, torch.dtype):
        return dtype == torch.bfloat16
    if isinstance(dtype, str):
        return dtype == "bfloat16"
    return "bfloat16" in (getattr(dtype, "name", None),
                          getattr(dtype, "__name__", None),
                          getattr(getattr(dtype, "dtype", None), "name", None))


def _host_block(b) -> tuple[np.ndarray, bool]:
    """(numpy block, was bf16).  A scipy block stays as it is, for the
    layout to densify and count (``core/layout.build_layout``); a torch
    tensor comes to the host; a bf16 block (a torch bf16 tensor, an
    ml_dtypes bf16 array or raw 2-byte records, read by their bits) becomes
    its exact float32 copy."""
    if hasattr(b, "toarray"):
        return b, False
    if isinstance(b, torch.Tensor):
        b = b.detach().cpu()
        if b.dtype == torch.bfloat16:
            return b.float().numpy(), True
        return b.numpy(), False
    a = np.asarray(b)
    if a.dtype.name == "bfloat16" or (a.dtype.kind == "V"
                                      and a.dtype.itemsize == 2):
        bits = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return bits.view(torch.bfloat16).float().numpy(), True
    return a, False


def host_values(groups, dtype):
    """``(groups, layout dtype, bf16)`` for lists of blocks ``groups``: the
    blocks as numpy, the numpy dtype to build the layouts in (None: the
    blocks' own), and whether the operator stores bf16 -- ``dtype`` names
    it, or ``dtype`` is None and every block is bf16.  A bf16 operator's
    blocks are rounded to bf16 and kept as their exact float32 copies:
    numpy has no bf16, and the layout's buckets depend only on shapes and
    indices."""
    conv = [[_host_block(b) for b in g] for g in groups]
    flags = [f for g in conv for _, f in g]
    bf16 = is_bf16(dtype) if dtype is not None else (bool(flags)
                                                     and all(flags))
    if not bf16:
        return [[a for a, _ in g] for g in conv], _np_dtype(dtype), False

    def rounded(a, was_bf16):
        if was_bf16:
            return a
        if hasattr(a, "toarray"):  # scipy: round the stored entries
            a = a.astype(np.float32)
            a.data = rounded(a.data, False)
            return a
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.to(torch.bfloat16).float().numpy()

    return [[rounded(a, f) for a, f in g] for g in conv], np.float32, True


def _torch_dtype(layouts, dtype, bf16: bool = False) -> torch.dtype:
    """The operator's dtype: bfloat16 where ``bf16``, else its first stored
    bucket's, else ``dtype``, else float64; float32, float64, complex64 or
    complex128."""
    if bf16:
        return torch.bfloat16
    vals = [b.values.dtype for lay in layouts for b in lay.buckets]
    np_dt = np.dtype(vals[0] if vals else (_np_dtype(dtype) or np.float64))
    if np_dt not in _DTYPES:
        raise NotImplementedError(
            f"dtype {np_dt} is not ported: the port stores float32, "
            "float64, complex64, complex128 and bfloat16")
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


def promoted_apply(apply, x: torch.Tensor, device, dtype: torch.dtype,
                   transpose: bool, conj: bool) -> torch.Tensor:
    """The product ``apply(x', transpose, conj)`` of an operator of
    ``dtype`` on ``device``, in ``torch.promote_types(dtype, x.dtype)``,
    ``x'`` the operand in the compute dtype: a complex operand on a real
    operator is one real product of ``view_as_real(x)`` as ``[n, 2r]``,
    viewed back as complex (conjugating real values changes nothing);
    otherwise the compute dtype is the result dtype (float32 where that is
    bf16) and ``x`` is cast to it where it differs (an integer, bool or
    narrower operand, or a real operand of a complex operator).  A float64
    operand of a float32 or bf16 operator and a complex128 one of a
    complex64 operator are passed as they are, to the kernels' mixed
    instances.  An operand on another device raises ``ValueError``."""
    if x.device != device:
        raise ValueError(
            f"operand on {x.device}, operator on {device}; move one of them "
            "explicitly")
    out = torch.promote_types(dtype, x.dtype)
    if out.is_complex and not dtype.is_complex:
        xr = torch.view_as_real(x.resolve_conj()).reshape(x.shape[0], -1)
        y = promoted_apply(apply, xr, device, dtype, transpose, conj)
        y = y.reshape(y.shape[0], *x.shape[1:], 2)
        return torch.view_as_complex(y.contiguous())
    compute = torch.float32 if out == torch.bfloat16 else out
    y = apply(x if x.dtype == compute else x.to(compute), transpose, conj)
    return y if y.dtype == out else y.to(out)


def _stage(layout: BlockLayout, device, dtype=None) -> StagedBuckets:
    """Per bucket: (values, row_idx, col_idx, row_chunk, col_chunk) on
    ``device`` (the chunk tables None for element buckets); the values cast
    to ``dtype`` on the host first where given (bf16 storage)."""
    def dev(a, cast=None):
        if a is None:
            return None
        t = torch.from_numpy(np.ascontiguousarray(a))
        return (t if cast is None else t.to(cast)).to(device)
    return StagedBuckets((dev(b.values, dtype), dev(b.row_idx),
                          dev(b.col_idx), dev(b.row_chunk_idx),
                          dev(b.col_chunk_idx))
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
    ``schedule``: "serial", "colored" or "auto" (the colored path, as in
    the JAX package).  ``scatter``: "atomic" (B9's element pass) or
    "sorted" (its owner mode: race-free by row ownership, the same bits on
    every run; the chunked buckets still add with B1's atomics, as the JAX
    chunked path ignores ``scatter``).  ``backend``: the JAX package's TPU
    engine choice, validated, stored and saved; it changes no route on the
    card or the CPU (see ``ops/dispatch.py``).  ``optimize``: the patch
    plan's bias (``core/patch.build_patch_plan``).  ``dtype``: the stored dtype, float32, float64,
    complex64, complex128 or bfloat16 (see the module docstring).
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
        backend: str = "auto",
        scatter: str = "atomic",
        optimize: str | None = None,
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
        self._device = _resolve_device(device)
        self._schedule = sched.normalize_schedule(schedule)
        self._precision = precision
        (blocks,), np_dtype, bf16 = host_values([blocks], dtype)
        self._layout = build_layout(blocks, rowindices, colindices, shape,
                                    granularity=granularity, dtype=np_dtype)
        self._dtype = _torch_dtype([self._layout], dtype, bf16)
        self._buckets = _stage(self._layout, self._device,
                               torch.bfloat16 if bf16 else None)
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
        """Logical nnz: sum of unpadded block areas, a scipy block's
        stored entries in place of its area."""
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
        """Lazy merged-patch plan (shaped by ``optimize``) and its device
        tensors; None if ineligible (non-contiguous lists or non-f32).
        Transpose products reuse the same plan with the gather/scatter roles
        swapped."""
        if self._patch is None:
            from ..core.patch import build_patch_plan
            from ..ops.patch_engine import patch_device_arrays

            plan = build_patch_plan(self._layout, optimize=self._optimize)
            self._patch = (plan, None if plan is None
                           else patch_device_arrays(plan, self._device))
        return None if self._patch[0] is None else self._patch

    def _patch_entry(self, transpose: bool):
        return self._patch_for()

    def _patch_run(self, entry, x, transpose: bool):
        from ..ops.patch_engine import patch_apply

        return patch_apply(entry[0], entry[1], x, transpose=transpose,
                           precision=self._precision)

    def _apply(self, x, transpose: bool, conj: bool):
        return promoted_apply(self._apply_routes, x, self._device,
                              self._dtype, transpose, conj)

    def _bucket_apply(self, x, transpose: bool, conj: bool):
        colors = adjoint = None
        if not sched.isserial(self._schedule):
            colors, adjoint = ((self._tcolors, self._colors) if transpose
                               else (self._colors, self._tcolors))
        return apply_operand(self._buckets, self._layout,
                             self.shape[1] if transpose else self.shape[0], x,
                             transpose=transpose, conj=conj, colors=colors,
                             adjoint_colors=adjoint, scatter=self._scatter)

    def __repr__(self):
        m, n = self.shape
        return (
            f"BlockSparseMatrix({m}x{n}, {self.nblocks} blocks, "
            f"{len(self._buckets)} buckets, nnz={self.nnz}, dtype={self.dtype}, "
            f"device={self._device}, schedule={self._schedule!r}, "
            f"patch={self._patch_mode!r}, panel={self._panel!r})"
        )
