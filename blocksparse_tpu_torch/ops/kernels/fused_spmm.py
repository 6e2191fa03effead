"""Chunk-table block product: CUDA kernel B1, its plain version, its autograd.

The kernel (``csrc/fused_spmm.cu``) replaces
``blocksparse_tpu/ops/pallas/fused_spmm.py::_kernel``.  For each stored block
b of a chunked bucket it adds ``V_b @ x[col chunks]`` into ``y[row chunks]``
(``V_b^T`` with the tables swapped when ``transpose``; both contributions
from one read of ``V_b`` when ``symmetric``).  It takes float32, float64,
complex64 and complex128; ``conj`` (complex only) reads ``conj(V_b)``, so
``transpose`` and ``conj`` together apply ``V_b^H``.

Stored and compute types: the values are read in their stored type and the
product is computed in the operand's type, which is the stored type or a
wider one (:data:`COMPUTE_TYPES`): bf16 values with a float32 or float64
operand, float32 values with a float64 operand, complex64 values with a
complex128 operand.  The kernel widens each value in registers (exact), so
no widened copy of the values exists in device memory; the plain versions
widen the values with ``.to`` (``torch_spmv.widened``).  ``out`` is of the
compute type.

Two entries launch it.  :func:`multi_block_apply` covers every bucket of a
:class:`BucketTable` (a layout's chunked buckets) in one launch and adds
into a given output: the bucket route (``ops/dispatch.py``) makes one such
launch per layout, the port of the JAX engine's ``chunked_multi_apply``
chain.  :func:`chunked_block_apply` is the one-bucket call of the same
kernel (its descriptor passed by value) into a fresh zeroed output.
:class:`BucketTable` also serves the element pass of kernel B9
(``ops/kernels/mask_select.py``), which reads the same descriptors.

Two kinds of instance serve a table (:func:`b1_instance`, a pure function
of the stored and compute dtypes, r and the table's deepest block side).
The tensor-core instances (:data:`MMA_RULES`: the pair, its entry, the
least r and the deepest block the rule sends to it) share one skeleton
(``csrc/b1_mma.cuh``: work items, cp.async ring, modes) and differ in
their arithmetic:

- complex64 values, complex64 operand (``csrc/complex_mma.cu``, entry
  ``bst_fused_spmm_mma_c64``): the real embedding ``view_as_real(V) [M,
  2K] @ B [2K, 2r]``, B's rows ``(Xr, Xi)`` and ``(-Xi, Xr)``, one real
  GEMM in 3xTF32 that gives the interleaved complex product;
- float64 and complex128 (``csrc/dmma.cu``, ``bst_fused_spmm_mma_f64`` /
  ``_c128``): the block's GEMM, or the same embedding, on f64 ``mma.sync``
  (IEEE f64 FMAs: no split, no depth cap);
- bf16 values, float32 operand (``csrc/bf16_mma.cu``,
  ``bst_fused_spmm_mma_bf16_f32``): x split exactly into three bf16 parts,
  three bf16 ``mma.sync`` passes with float32 sums (the product of the
  exact bf16 values with the unrounded operand).

Their plain version is :func:`mma_apply_plain` (the embedding in
:func:`complex_mma_apply_plain`, the GEMM per block, the three-part split
of x with float32 products and sums).  At r = 1 the pair's entry of
:data:`R1_RULES` (:func:`r1_body`) picks the row-stream body
(``csrc/row_stream.cuh``, entry ``bst_fused_spmm_rows_<pair>``: each
block's values read once in stored row order by persistent blocks that
issue the next work item's loads before this one's reductions, warp
shuffles, one atomic per row or column) or the FMA tile core; B9's element
pass reads its own column of the same table.  Every other table, pair and
r runs the FMA tile core (``csrc/tile_core.cuh``): the mixed pairs (bf16
-> float64, float32 -> float64, complex64 -> complex128) and float32
(whose r > 1 products take the patch route, B2 / B3).  Every instance
computes the same function, so :func:`multi_block_apply_plain` is the
plain version of the row-stream body and the tile core alike.

Race-freedom: thread blocks run concurrently and blocks may share output
rows, so the kernel adds into a zeroed output (or the partial sum of the
launches before it) with fp32/fp64 ``atomicAdd`` (a complex value as two,
one per part, or as one float2 ``atomicAdd`` whose parts are atomic on
their own).  The summation order varies from run to run; compare with a
tolerance, not bit for bit.

Precision: the FMA instances run in IEEE fp32/fp64 FMA (four per complex
multiply-add) at every tier (``"highest"``, ``"high"``, ``None``); the
complex64 tensor-core instance runs 3xTF32 and the bf16 one three exact
bf16 passes at every tier; the f64 one is IEEE f64.  All meet the
``"highest"`` tolerance.  Faster tiers are later work.

Routing: a CPU tensor takes the plain version of the instance
(:func:`chunked_block_apply_plain`, and for a table
:func:`multi_block_apply_plain`, the loop of it over the buckets, or
:func:`mma_apply_plain`); a CUDA tensor launches the kernel or raises,
with no fallback from one instance to another.  ``LAUNCHES`` counts
kernel launches, ``SYM_LAUNCHES`` those of them in the symmetric mode,
``MMA_LAUNCHES`` those of the tensor-core instances, ``ROW_LAUNCHES``
those of the row-stream body, and
``ENTRY_LAUNCHES`` every launch of B1 and B9 by entry point (so by stored
and compute dtype: ``bst_fused_spmm_multi_f32_f64``,
``bst_fused_spmm_rows_c64``, ``bst_fused_spmm_mma_bf16_f32``, ...).
"""

from __future__ import annotations

from collections import Counter
from typing import NamedTuple

import torch

from ...utils import build
from ..torch_spmv import (chunk_rows, chunked_bucket_apply, gather_rows,
                          scatter_rows, values_grad)

__all__ = ["BucketTable", "COMPUTE_TYPES", "ENTRY_LAUNCHES", "FMA_PREFIXES",
           "MMA_RULES", "MmaRule", "R1Rule", "R1_RULES", "b1_instance",
           "check_table_call", "chunked_block_apply",
           "chunked_block_apply_plain", "complex_mma_apply_plain",
           "entry_point", "fma_launch", "launch_items", "launch_mode",
           "launch_table", "mma_apply_plain",
           "multi_block_apply", "multi_block_apply_plain",
           "multi_fused_apply", "r1_body", "split3", "TableApply",
           "LAUNCHES", "MMA_LAUNCHES", "ROW_LAUNCHES", "SYM_LAUNCHES"]

LAUNCHES = 0
SYM_LAUNCHES = 0
MMA_LAUNCHES = 0
ROW_LAUNCHES = 0
ENTRY_LAUNCHES: Counter = Counter()  # cleared, never rebound


class MmaRule(NamedTuple):
    """Where a pair's tensor-core instance takes a table: its entry, the
    least r, and the deepest block side (complex columns or rows) it takes,
    or None for any depth."""
    entry: str
    min_r: int
    max_depth: int | None


# (stored, compute) -> the rule of its tensor-core instance.  Each least r
# is the smallest of chip_smoke.py's instance scan (r in 2, 4, ..., 64)
# from which the instance beat the FMA tile core at every larger r of the
# scan on the H100.  The tensor core rounds its float32 sums toward zero,
# an error that grows with the contraction's depth: each cap is the
# deepest block of chip_smoke.py's depth check (64 to 8192, normal values)
# whose error stayed within the 1e-5 tolerance of max|y| on the H100
# (complex64: 7.0e-6 to 8.5e-6 at 512, 1.3e-5 to 1.6e-5 at 1024; bf16:
# 6.4e-6 to 8.0e-6 at 2048, 2.6e-5 at 8192).  f64 sums are IEEE: no cap.
MMA_RULES = {
    (torch.complex64, torch.complex64): MmaRule("bst_fused_spmm_mma_c64", 2,
                                                512),
    (torch.float64, torch.float64): MmaRule("bst_fused_spmm_mma_f64", 2,
                                            None),
    (torch.complex128, torch.complex128): MmaRule("bst_fused_spmm_mma_c128",
                                                  2, None),
    (torch.bfloat16, torch.float32): MmaRule("bst_fused_spmm_mma_bf16_f32", 2,
                                             2048),
}


class R1Rule(NamedTuple):
    """The bodies of a pair's r = 1 launches, ``"rows"`` (the row-stream
    body, ``csrc/row_stream.cuh``) or ``"tile"`` (the FMA tile core): B1's
    over chunked buckets and B9's element pass's over element buckets."""
    b1: str
    b9: str


# (stored, compute) -> the bodies of its r = 1 launches.  Each entry
# follows chip_smoke.py's r = 1 rule scan on the H100 (both bodies on the
# BEM at n = 8192, contiguous for B1, on scattered index lists for B9;
# PERF.md section 6): the row-stream body where it was the faster.
R1_RULES = {
    (torch.float32, torch.float32): R1Rule("rows", "rows"),
    (torch.float64, torch.float64): R1Rule("rows", "rows"),
    (torch.complex64, torch.complex64): R1Rule("rows", "rows"),
    (torch.complex128, torch.complex128): R1Rule("rows", "rows"),
    (torch.bfloat16, torch.float32): R1Rule("rows", "tile"),
    (torch.bfloat16, torch.float64): R1Rule("rows", "rows"),
    (torch.float32, torch.float64): R1Rule("rows", "rows"),
    (torch.complex64, torch.complex128): R1Rule("rows", "rows"),
}

# the entry prefixes of B1 ("B1") and of B9's element pass ("B9") off the
# tensor cores: (the tile core's, the row-stream body's)
FMA_PREFIXES = {"B1": ("bst_fused_spmm_multi", "bst_fused_spmm_rows"),
                "B9": ("bst_element_pass", "bst_element_pass_rows")}

_MODES = {(False, False): 0, (True, False): 1, (False, True): 2}
_CONJ = 4  # mode bit: read conj(V) (tile_core.cuh kConj)
_ROW_TILE = 64  # output rows of a work item (tile_core.cuh kMT)
_SUFFIX = {torch.float32: "f32", torch.float64: "f64",
           torch.complex64: "c64", torch.complex128: "c128",
           torch.bfloat16: "bf16"}
# stored dtype -> the compute dtypes of its kernel instances (the first the
# plain instance's, where there is one; bf16 is always widened)
COMPUTE_TYPES = {
    torch.float32: (torch.float32, torch.float64),
    torch.float64: (torch.float64,),
    torch.complex64: (torch.complex64, torch.complex128),
    torch.complex128: (torch.complex128,),
    torch.bfloat16: (torch.float32, torch.float64),
}


def launch_mode(transpose: bool, symmetric: bool, conj: bool = False) -> int:
    """The kernels' mode: 0 forward, 1 transpose, 2 symmetric, plus 4 to
    read conj(V)."""
    if symmetric and transpose:
        raise ValueError(
            "symmetric fused pass is transpose-invariant; use transpose=False")
    return _MODES[(transpose, symmetric)] | (_CONJ if conj else 0)


def b1_instance(stored: torch.dtype, compute: torch.dtype, r: int,
                depth: int = 0) -> str:
    """The instance of B1 that runs a table of ``stored`` values on an
    operand of ``compute`` dtype with r columns, whose blocks are at most
    ``depth`` rows or columns deep: ``"mma"`` (the pair's tensor-core
    instance) where :data:`MMA_RULES` has the pair, ``r >= min_r`` and the
    depth is within its cap, else ``"fma"`` (the FMA tile core)."""
    rule = MMA_RULES.get((stored, compute))
    if rule is not None and r >= rule.min_r and (
            rule.max_depth is None or depth <= rule.max_depth):
        return "mma"
    return "fma"


def r1_body(kind: str, stored: torch.dtype, compute: torch.dtype) -> str:
    """The body that runs a table of ``stored`` values on an operand of
    ``compute`` dtype at r = 1 in B1 (``kind`` "B1") or B9's element pass
    ("B9"): :data:`R1_RULES`' entry, ``"rows"`` or ``"tile"``."""
    return R1_RULES[(stored, compute)][kind == "B9"]


def fma_launch(kind: str, stored: torch.dtype, compute: torch.dtype,
               r: int) -> tuple:
    """``(entry, rows)`` of a launch of B1 (``kind`` "B1") or of B9's
    element pass ("B9") off the tensor cores at r columns: ``rows`` where
    it takes the row-stream body (r = 1 and :func:`r1_body` says
    ``"rows"``), else the tile core, and that body's entry point."""
    rows = r == 1 and r1_body(kind, stored, compute) == "rows"
    return entry_point(FMA_PREFIXES[kind][rows], stored, compute), rows


def launch_items(table: "BucketTable", mode: int, rows: bool) -> int:
    """The work items of a launch over ``table`` in ``mode``: the
    row-stream body numbers the forward items (64 stored rows of a block)
    in every mode; the tile core numbers the transpose mode's by 64
    columns."""
    return table.items[0 if rows else int((mode & ~_CONJ) == 1)]


def entry_point(prefix: str, dtype: torch.dtype,
                compute: torch.dtype | None = None) -> str:
    """The kernel entry for values stored in ``dtype`` and computed in
    ``compute`` (default ``dtype``): ``prefix``_f32 / _f64 / _c64 / _c128
    where the two agree, ``prefix``_<stored>_<compute> for the mixed
    instances (:data:`COMPUTE_TYPES`); raises ``TypeError`` for any other
    pair."""
    compute = dtype if compute is None else compute
    if compute not in COMPUTE_TYPES.get(dtype, ()):
        raise TypeError(
            f"{prefix}: values dtype {dtype} takes an operand dtype in "
            f"{COMPUTE_TYPES.get(dtype, ())}, got {compute}")
    if compute == dtype:
        return f"{prefix}_{_SUFFIX[dtype]}"
    return f"{prefix}_{_SUFFIX[dtype]}_{_SUFFIX[compute]}"


class BucketTable:
    """The descriptor table of a multi-bucket launch.

    ``buckets``: per bucket ``(values [nb, mp, kp], row table, column
    table, chunk)``: the chunk tables ``[nb, mp / C]`` / ``[nb, kp / C]``
    of a chunked bucket (B1), or the element tables ``[nb, mp]`` /
    ``[nb, kp]`` with chunk 1 (B9's element pass).  ``dtype`` is the
    values' stored dtype and ``compute_dtypes`` the operand dtypes a launch
    over the table takes (:data:`COMPUTE_TYPES`).  ``table`` is an int64
    ``[n, 9]`` tensor on the buckets' device, one row per bucket as the
    kernels read it (``csrc/tile_core.cuh::BucketDesc``): the addresses of
    its values and tables, the number of its first work item in the
    forward / symmetric and in the transpose numbering (``first``), mp, kp,
    C, nb.  A work item is one (block, 64-row output tile); ``items`` holds
    the totals of the two numberings.

    The table holds raw addresses, so it keeps the tensors alive
    (``buckets``); an operator builds it once, at its first bucket-route
    product (eager, before any CUDA-graph capture of the product), and a
    re-staged bucket set gets a table of its own (``ops/dispatch.py``).
    """

    def __init__(self, buckets):
        self.buckets = tuple(buckets)
        if not self.buckets:
            raise ValueError("a bucket table needs at least one bucket")
        vals0 = self.buckets[0][0]
        self.dtype, self.device = vals0.dtype, vals0.device
        first, items, rows = ([], []), [0, 0], []
        for vals, rtab, ctab, chunk in self.buckets:
            if vals.ndim != 3 or not vals.is_contiguous():
                raise ValueError(
                    f"values must be contiguous [nb, mp, kp], got "
                    f"{tuple(vals.shape)}")
            nb, mp, kp = vals.shape
            if chunk < 1 or mp % chunk or kp % chunk:
                raise ValueError(
                    f"chunk {chunk} must divide the tile ({mp}, {kp})")
            for name, t, extent in (("row", rtab, mp), ("column", ctab, kp)):
                if tuple(t.shape) != (nb, extent // chunk):
                    raise ValueError(
                        f"{name} table {tuple(t.shape)} does not match tile "
                        f"({nb}, {mp}, {kp}) at chunk {chunk}")
                if t.dtype != torch.int32 or not t.is_contiguous():
                    raise TypeError(f"{name} table must be contiguous int32")
            if vals.dtype != self.dtype or {vals.device, rtab.device,
                                            ctab.device} != {self.device}:
                raise ValueError("buckets of one table must share dtype and "
                                 "device")
            rows.append([vals.data_ptr(), rtab.data_ptr(), ctab.data_ptr(),
                         items[0], items[1], mp, kp, chunk, nb])
            for side, extent in enumerate((mp, kp)):
                first[side].append(items[side])
                items[side] += nb * -(-extent // _ROW_TILE)
        self.compute_dtypes = COMPUTE_TYPES.get(self.dtype, ())
        self.owners = {}  # B9's owner tables (mask_select.owner_table)
        self.offsets = {}  # B9's scratch offsets (mask_select.scratch_offsets)
        self.first = (tuple(first[0]), tuple(first[1]))
        self.items = tuple(items)
        # the deepest block side: the longest contraction of any mode
        self.depth = max(max(b[0].shape[1:]) for b in self.buckets)
        self.table = torch.tensor(rows, dtype=torch.int64, device=self.device)

    @property
    def values(self) -> tuple:
        return tuple(b[0] for b in self.buckets)

    def __len__(self) -> int:
        return len(self.buckets)


def check_table_call(table: BucketTable, x, out, symmetric: bool) -> None:
    """Raise on operands a launch over ``table`` does not take."""
    if x.ndim not in (1, 2) or out.ndim != x.ndim or \
            out.shape[1:] != x.shape[1:]:
        raise ValueError(f"x {tuple(x.shape)} and out {tuple(out.shape)} must "
                         "be [n] and [out_len], or [n, r] and [out_len, r]")
    if x.dtype != out.dtype or x.dtype not in table.compute_dtypes:
        raise TypeError(f"x dtype {x.dtype} / out dtype {out.dtype}: both "
                        f"must be one of {table.compute_dtypes}, the compute "
                        f"dtypes of values dtype {table.dtype}")
    devs = {table.device, x.device, out.device}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devs))}")
    if not out.is_contiguous():
        raise ValueError("out must be contiguous: the kernels add into it")
    if symmetric and x.shape[0] != out.shape[0]:
        raise ValueError(
            f"symmetric pass needs a square operand: x rows {x.shape[0]} "
            f"!= out_len {out.shape[0]}")


def launch_table(prefix: str, table: BucketTable, x, out, mode: int,
                 rows: bool = False) -> bool:
    """Launch the entry point of ``prefix`` for the table's values and
    ``x``'s dtype (:func:`entry_point`) over every bucket of ``table`` on
    CUDA tensors (checked by the caller), adding into ``out``; False where
    there was nothing to launch.  ``rows``: ``prefix`` names a row-stream
    entry (r = 1), whose work items are the forward ones in every mode."""
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    name = entry_point(prefix, table.dtype, x.dtype)
    xm = x.resolve_conj().contiguous()
    r = 1 if x.ndim == 1 else x.shape[1]
    items = launch_items(table, mode, rows)
    if not (items and r and out.shape[0]):
        return False
    build.launch(name, x.device, table.table.data_ptr(),
                 len(table), items, xm.data_ptr(), out.data_ptr(), r,
                 xm.shape[0], out.shape[0], mode)
    ENTRY_LAUNCHES[name] += 1
    return True


def multi_block_apply_plain(table: BucketTable, x, *, out,
                            transpose: bool = False, symmetric: bool = False,
                            conj: bool = False) -> torch.Tensor:
    """Plain version of the multi-bucket launch: ``out`` += each bucket's
    :func:`chunked_block_apply_plain`, in place; returns ``out``."""
    for vals, rtab, ctab, chunk in table.buckets:
        out += chunked_block_apply_plain(vals, rtab, ctab, chunk, x,
                                         out.shape[0], transpose=transpose,
                                         symmetric=symmetric, conj=conj)
    return out


def _embedded(xg: torch.Tensor, conj: bool) -> torch.Tensor:
    """The real embedding's B of gathered complex rows ``xg`` [nb, K, r]:
    real [nb, 2K, 2r], row 2k x's row k as (Xr, Xi) per column, row
    2k + 1 (-Xi, Xr) ((Xi, -Xr) under ``conj``)."""
    nb, K, r = xg.shape
    xr = torch.view_as_real(xg.resolve_conj())
    odd = torch.stack([-xr[..., 1], xr[..., 0]], dim=-1)
    if conj:
        odd = -odd
    return torch.stack([xr, odd], dim=2).reshape(nb, 2 * K, 2 * r)


def _halves(table: BucketTable, dtype: torch.dtype, transpose: bool,
            symmetric: bool):
    """Per bucket and half of its product: (values in ``dtype`` as the
    contraction's A [nb, M, K], the element rows of x it reads, those of y
    it adds into)."""
    for vals, rtab, ctab, chunk in table.buckets:
        vals = vals.to(dtype).resolve_conj()
        rows, cols = chunk_rows(rtab, chunk), chunk_rows(ctab, chunk)
        if not transpose:
            yield vals, cols, rows
        if transpose or symmetric:
            yield vals.transpose(1, 2), rows, cols


def complex_mma_apply_plain(table: BucketTable, x, *, out,
                            transpose: bool = False, symmetric: bool = False,
                            conj: bool = False) -> torch.Tensor:
    """Plain version of the complex tensor-core instances: per bucket, the
    real embedding ``view_as_real(V) [nb, M, 2K] @ B [nb, 2K, 2r]``
    (:func:`_embedded`; transposed, ``view_as_real(V^T)``) read as the
    interleaved complex product and added into ``out`` in place through
    the row tables; returns ``out``.  Any complex dtype: complex64's
    instance, and complex128's, its float64 analogue."""
    xm = x[:, None] if x.ndim == 1 else x
    om = out[:, None] if out.ndim == 1 else out
    r = xm.shape[1]
    for v, src, dst in _halves(table, x.dtype, transpose, symmetric):
        nb = v.shape[0]
        a = torch.view_as_real(v.contiguous()).reshape(nb, v.shape[1], -1)
        y = torch.bmm(a, _embedded(gather_rows(xm, src), conj))
        y = torch.view_as_complex(y.reshape(nb, v.shape[1], r, 2))
        om += scatter_rows(om.shape[0], dst, y)
    return out


def split3(x: torch.Tensor) -> tuple:
    """float32 ``x`` as three bf16 tensors ``(h, m, l)`` whose sum is x
    exactly: ``h = bf16(x)``, ``m = bf16(x - h)``, ``l = bf16(x - h - m)``
    (round to nearest even; 8 + 8 + 8 significant bits of x's 24)."""
    h = x.to(torch.bfloat16)
    rest = x - h.float()
    m = rest.to(torch.bfloat16)
    return h, m, (rest - m.float()).to(torch.bfloat16)


def mma_apply_plain(table: BucketTable, x, *, out, transpose: bool = False,
                    symmetric: bool = False,
                    conj: bool = False) -> torch.Tensor:
    """Plain version of the tensor-core instance of ``table``'s values and
    ``x``'s dtype (:data:`MMA_RULES`), adding into ``out`` in place through
    the row tables; returns ``out``.  Complex values: the real embedding
    (:func:`complex_mma_apply_plain`); bf16 values with a float32 operand:
    the three bf16 parts of x (:func:`split3`), each part's product with
    the exact values in float32, summed in float32; float64: the GEMM per
    block."""
    if table.dtype.is_complex:
        return complex_mma_apply_plain(table, x, out=out, transpose=transpose,
                                       symmetric=symmetric, conj=conj)
    xm = x[:, None] if x.ndim == 1 else x
    om = out[:, None] if out.ndim == 1 else out
    parts = ([p.to(x.dtype) for p in split3(xm)]
             if table.dtype == torch.bfloat16 else [xm])
    for v, src, dst in _halves(table, x.dtype, transpose, symmetric):
        y = torch.bmm(v, gather_rows(parts[0], src))
        for part in parts[1:]:
            y += torch.bmm(v, gather_rows(part, src))
        om += scatter_rows(om.shape[0], dst, y)
    return out


def _launch_mma(table: BucketTable, x, out, mode: int) -> bool:
    """One launch of the tensor-core instance of ``table``'s values and
    ``x``'s dtype (:data:`MMA_RULES`; CUDA tensors, checked by the caller)
    over ``table``, adding into ``out``; False where there was nothing to
    launch."""
    name = MMA_RULES[(table.dtype, x.dtype)].entry
    xm = x.resolve_conj().contiguous()
    r = 1 if x.ndim == 1 else x.shape[1]
    if not (any(table.items) and r and out.shape[0]):
        return False
    build.launch(name, x.device, table.table.data_ptr(), len(table),
                 table.items[0], table.items[1], xm.data_ptr(),
                 out.data_ptr(), r, xm.shape[0], out.shape[0], mode)
    ENTRY_LAUNCHES[name] += 1
    return True


def multi_block_apply(table: BucketTable, x, *, out, transpose: bool = False,
                      symmetric: bool = False,
                      conj: bool = False) -> torch.Tensor:
    """Add every bucket of ``table`` applied to ``x`` ([n] or [n, r]) into
    ``out`` ([out_len] or [out_len, r]) in one launch of the instance
    :func:`b1_instance` picks (at r = 1 the body :func:`r1_body` picks);
    returns ``out``.  ``conj``: the buckets' conjugates (nothing changes for
    real values)."""
    global LAUNCHES, SYM_LAUNCHES, MMA_LAUNCHES, ROW_LAUNCHES
    conj = conj and table.dtype.is_complex
    mode = launch_mode(transpose, symmetric, conj)
    check_table_call(table, x, out, symmetric)
    r = 1 if x.ndim == 1 else x.shape[1]
    mma = b1_instance(table.dtype, x.dtype, r, table.depth) == "mma"
    if x.device.type == "cpu":
        plain = mma_apply_plain if mma else multi_block_apply_plain
        return plain(table, x, out=out, transpose=transpose,
                     symmetric=symmetric, conj=conj)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    rows = fma_launch("B1", table.dtype, x.dtype, r)[1]
    if _launch_mma(table, x, out, mode) if mma else launch_table(
            FMA_PREFIXES["B1"][rows], table, x, out, mode, rows=rows):
        LAUNCHES += 1
        SYM_LAUNCHES += symmetric
        MMA_LAUNCHES += mma
        ROW_LAUNCHES += rows
    return out


class TableApply(torch.autograd.Function):
    """``out += (every bucket of table) @ x`` in place through ``launch``
    (:func:`multi_block_apply`, or B9's ``element_apply`` or colored
    route), with exact cotangents in torch's convention (``y = M x`` gives
    ``M^H g``): ``out``'s is the output's, x's the launch ``adjoint``
    (None: ``launch`` itself) in the other mode with the conj flag flipped
    (the symmetric mode is its own transpose, so its adjoint is its
    conjugate), whose own adjoint is ``launch``; each bucket's values' the
    torch ops on the gathered rows (``torch_spmv.values_grad``)."""

    @staticmethod
    def forward(ctx, out, x, table, launch, adjoint, transpose, symmetric,
                conj, *vals):
        ctx.mark_dirty(out)
        ctx.save_for_backward(x, *vals)
        ctx.cfg = (table, launch, adjoint or launch, transpose, symmetric,
                   conj)
        return launch(table, x, out=out, transpose=transpose,
                      symmetric=symmetric, conj=conj)

    @staticmethod
    def backward(ctx, g):
        x, *vals = ctx.saved_tensors
        table, launch, adjoint, transpose, symmetric, conj = ctx.cfg
        g = g.contiguous()
        dx = None
        if ctx.needs_input_grad[1]:
            dx = TableApply.apply(g.new_zeros(x.shape), g, table, adjoint,
                                  launch, not transpose and not symmetric,
                                  symmetric, not conj, *vals)
        # in the compute dtype, returned in each value's stored dtype
        dvals = [values_grad(g, x, chunk_rows(rtab, chunk),
                             chunk_rows(ctab, chunk), transpose=transpose,
                             symmetric=symmetric, conj=conj).to(v.dtype)
                 if ctx.needs_input_grad[8 + i] else None
                 for i, (v, rtab, ctab, chunk) in enumerate(table.buckets)]
        return (g if ctx.needs_input_grad[0] else None, dx, None, None, None,
                None, None, None, *dvals)


def multi_fused_apply(table: BucketTable, x, *, out, transpose: bool = False,
                      symmetric: bool = False,
                      conj: bool = False) -> torch.Tensor:
    """:func:`multi_block_apply` with autograd (in ``x``, ``out`` and the
    table's values)."""
    return TableApply.apply(out, x, table, multi_block_apply, None,
                            transpose, symmetric, conj, *table.values)


def chunked_block_apply_plain(vals, row_chunk, col_chunk, chunk: int, x,
                              out_len: int, *, transpose: bool = False,
                              symmetric: bool = False,
                              conj: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernel: same tables, same result."""
    return chunked_bucket_apply(vals, row_chunk, col_chunk, chunk, out_len, x,
                                transpose=transpose, symmetric=symmetric,
                                conj=conj)


def _check(vals, row_chunk, col_chunk, chunk, x, out_len, symmetric):
    if vals.ndim != 3:
        raise ValueError(f"vals must be [nb, mp, kp], got {tuple(vals.shape)}")
    nb, mp, kp = vals.shape
    if chunk < 1 or mp % chunk or kp % chunk:
        raise ValueError(f"chunk {chunk} must divide the tile ({mp}, {kp})")
    if tuple(row_chunk.shape) != (nb, mp // chunk) or \
            tuple(col_chunk.shape) != (nb, kp // chunk):
        raise ValueError(
            f"chunk tables {tuple(row_chunk.shape)}, {tuple(col_chunk.shape)} "
            f"do not match tile ({nb}, {mp}, {kp}) at chunk {chunk}")
    if x.ndim not in (1, 2):
        raise ValueError(f"x must be [n] or [n, r], got {tuple(x.shape)}")
    entry_point("bst_fused_spmm", vals.dtype, x.dtype)  # raises on a bad pair
    if symmetric and x.shape[0] != out_len:
        raise ValueError(
            f"symmetric pass needs a square operand: x rows {x.shape[0]} "
            f"!= out_len {out_len}")
    devs = {t.device for t in (vals, row_chunk, col_chunk, x)}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devs))}")


def chunked_block_apply(vals, row_chunk, col_chunk, chunk: int, x,
                        out_len: int, *, transpose: bool = False,
                        symmetric: bool = False,
                        conj: bool = False) -> torch.Tensor:
    """Fused chunk-granular block product of one bucket: [out_len] or
    [out_len, r] in ``x``'s dtype (the values' or a wider one,
    :data:`COMPUTE_TYPES`).  ``conj``: the bucket's conjugate (nothing
    changes for real values)."""
    global LAUNCHES, SYM_LAUNCHES
    conj = conj and vals.dtype.is_complex
    mode = launch_mode(transpose, symmetric, conj)
    _check(vals, row_chunk, col_chunk, chunk, x, out_len, symmetric)
    if x.device.type == "cpu":
        return chunked_block_apply_plain(
            vals, row_chunk, col_chunk, chunk, x, out_len,
            transpose=transpose, symmetric=symmetric, conj=conj)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    fn_name = entry_point("bst_fused_spmm", vals.dtype, x.dtype)
    for name, t in (("row_chunk", row_chunk), ("col_chunk", col_chunk)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    vec = x.ndim == 1
    xm = (x[:, None] if vec else x).resolve_conj().contiguous()
    n_in, r = xm.shape
    vals = vals.resolve_conj().contiguous()
    row_chunk, col_chunk = row_chunk.contiguous(), col_chunk.contiguous()
    nb, mp, kp = vals.shape
    y = torch.zeros((out_len, r), dtype=x.dtype, device=x.device)
    if nb and r and out_len:
        build.launch(fn_name, x.device, vals.data_ptr(), row_chunk.data_ptr(),
                     col_chunk.data_ptr(), xm.data_ptr(), y.data_ptr(), nb, mp,
                     kp, chunk, r, n_in, out_len, mode)
        ENTRY_LAUNCHES[fn_name] += 1
        LAUNCHES += 1
        SYM_LAUNCHES += symmetric
    return y[:, 0] if vec else y
