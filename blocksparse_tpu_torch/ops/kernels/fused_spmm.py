"""Chunk-table block product: CUDA kernel B1, its plain version, its autograd.

The kernel (``csrc/fused_spmm.cu``) replaces
``blocksparse_tpu/ops/pallas/fused_spmm.py::_kernel``.  For each stored block
b of a chunked bucket it adds ``V_b @ x[col chunks]`` into ``y[row chunks]``
(``V_b^T`` with the tables swapped when ``transpose``; both contributions
from one read of ``V_b`` when ``symmetric``).

Two entries launch it.  :func:`multi_block_apply` covers every bucket of a
:class:`BucketTable` (a layout's chunked buckets) in one launch and adds
into a given output: the bucket route (``ops/dispatch.py``) makes one such
launch per layout, the port of the JAX engine's ``chunked_multi_apply``
chain.  :func:`chunked_block_apply` is the one-bucket call of the same
kernel (its descriptor passed by value) into a fresh zeroed output.
:class:`BucketTable` also serves the element pass of kernel B9
(``ops/kernels/mask_select.py``), which reads the same descriptors.

Race-freedom: thread blocks run concurrently and blocks may share output
rows, so the kernel adds into a zeroed output (or the partial sum of the
launches before it) with fp32/fp64 ``atomicAdd``.  The summation order
varies from run to run; compare with a tolerance, not bit for bit.

Precision: every tier (``"highest"``, ``"high"``, ``None``) runs in IEEE
fp32/fp64 FMA, with no TF32, which meets the ``"highest"`` tolerance.
Faster tiers are later work.

Routing: a CPU tensor takes the plain version
(:func:`chunked_block_apply_plain`, and for a table
:func:`multi_block_apply_plain`, the loop of it over the buckets); a CUDA
tensor launches the kernel or raises.  ``LAUNCHES`` counts kernel
launches, ``SYM_LAUNCHES`` those of them in the symmetric mode.
"""

from __future__ import annotations

import torch

from ...utils import build
from ..torch_spmv import chunk_rows, chunked_bucket_apply, values_grad

__all__ = ["BucketTable", "check_table_call", "chunked_block_apply",
           "chunked_block_apply_plain", "launch_mode",
           "launch_table", "multi_block_apply",
           "multi_block_apply_plain", "multi_fused_apply", "TableApply",
           "LAUNCHES", "SYM_LAUNCHES"]

LAUNCHES = 0
SYM_LAUNCHES = 0

_MODES = {(False, False): 0, (True, False): 1, (False, True): 2}
_ROW_TILE = 64  # output rows of a work item (tile_core.cuh kMT)


def launch_mode(transpose: bool, symmetric: bool) -> int:
    """The kernels' mode: 0 forward, 1 transpose, 2 symmetric."""
    if symmetric and transpose:
        raise ValueError(
            "symmetric fused pass is transpose-invariant; use transpose=False")
    return _MODES[(transpose, symmetric)]


class BucketTable:
    """The descriptor table of a multi-bucket launch.

    ``buckets``: per bucket ``(values [nb, mp, kp], row table, column
    table, chunk)``: the chunk tables ``[nb, mp / C]`` / ``[nb, kp / C]``
    of a chunked bucket (B1), or the element tables ``[nb, mp]`` /
    ``[nb, kp]`` with chunk 1 (B9's element pass).  ``table`` is an int64
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
        self.first = (tuple(first[0]), tuple(first[1]))
        self.items = tuple(items)
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
    if x.dtype != table.dtype or out.dtype != table.dtype:
        raise TypeError(f"x dtype {x.dtype} / out dtype {out.dtype} != values "
                        f"dtype {table.dtype}")
    devs = {table.device, x.device, out.device}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devs))}")
    if not out.is_contiguous():
        raise ValueError("out must be contiguous: the kernels add into it")
    if symmetric and x.shape[0] != out.shape[0]:
        raise ValueError(
            f"symmetric pass needs a square operand: x rows {x.shape[0]} "
            f"!= out_len {out.shape[0]}")


def launch_table(prefix: str, table: BucketTable, x, out, mode: int) -> bool:
    """Launch entry point ``prefix``_f32 / _f64 over every bucket of
    ``table`` on CUDA tensors (checked by the caller), adding into ``out``;
    False where there was nothing to launch."""
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    suffix = {torch.float32: "f32", torch.float64: "f64"}.get(table.dtype)
    if suffix is None:
        raise TypeError(f"{prefix} takes float32/float64, got {table.dtype}")
    xm = x.contiguous()
    r = 1 if x.ndim == 1 else x.shape[1]
    items = table.items[mode == 1]
    if not (items and r and out.shape[0]):
        return False
    build.launch(f"{prefix}_{suffix}", x.device, table.table.data_ptr(),
                 len(table), items, xm.data_ptr(), out.data_ptr(), r,
                 xm.shape[0], out.shape[0], mode)
    return True


def multi_block_apply_plain(table: BucketTable, x, *, out,
                            transpose: bool = False,
                            symmetric: bool = False) -> torch.Tensor:
    """Plain version of the multi-bucket launch: ``out`` += each bucket's
    :func:`chunked_block_apply_plain`, in place; returns ``out``."""
    for vals, rtab, ctab, chunk in table.buckets:
        out += chunked_block_apply_plain(vals, rtab, ctab, chunk, x,
                                         out.shape[0], transpose=transpose,
                                         symmetric=symmetric)
    return out


def multi_block_apply(table: BucketTable, x, *, out, transpose: bool = False,
                      symmetric: bool = False) -> torch.Tensor:
    """Add every bucket of ``table`` applied to ``x`` ([n] or [n, r]) into
    ``out`` ([out_len] or [out_len, r]) in one launch; returns ``out``."""
    global LAUNCHES, SYM_LAUNCHES
    mode = launch_mode(transpose, symmetric)
    check_table_call(table, x, out, symmetric)
    if x.device.type == "cpu":
        return multi_block_apply_plain(table, x, out=out, transpose=transpose,
                                       symmetric=symmetric)
    if launch_table("bst_fused_spmm_multi", table, x, out, mode):
        LAUNCHES += 1
        SYM_LAUNCHES += symmetric
    return out


class TableApply(torch.autograd.Function):
    """``out += (every bucket of table) @ x`` in place through ``launch``
    (:func:`multi_block_apply`, or B9's ``element_apply``), with exact
    cotangents: ``out``'s is the output's, x's the same launch in the
    other mode (the symmetric mode is its own adjoint), each bucket's
    values' the torch ops on the gathered rows
    (``torch_spmv.values_grad``)."""

    @staticmethod
    def forward(ctx, out, x, table, launch, transpose, symmetric, *vals):
        ctx.mark_dirty(out)
        ctx.save_for_backward(x, *vals)
        ctx.cfg = (table, launch, transpose, symmetric)
        return launch(table, x, out=out, transpose=transpose,
                      symmetric=symmetric)

    @staticmethod
    def backward(ctx, g):
        x, *vals = ctx.saved_tensors
        table, launch, transpose, symmetric = ctx.cfg
        g = g.contiguous()
        dx = None
        if ctx.needs_input_grad[1]:
            dx = TableApply.apply(g.new_zeros(x.shape), g, table, launch,
                                  not transpose and not symmetric, symmetric,
                                  *vals)
        dvals = [values_grad(g, x, chunk_rows(rtab, chunk),
                             chunk_rows(ctab, chunk), transpose=transpose,
                             symmetric=symmetric)
                 if ctx.needs_input_grad[6 + i] else None
                 for i, (_v, rtab, ctab, chunk) in enumerate(table.buckets)]
        return (g if ctx.needs_input_grad[0] else None, dx, None, None, None,
                None, *dvals)


def multi_fused_apply(table: BucketTable, x, *, out, transpose: bool = False,
                      symmetric: bool = False) -> torch.Tensor:
    """:func:`multi_block_apply` with autograd (in ``x``, ``out`` and the
    table's values)."""
    return TableApply.apply(out, x, table, multi_block_apply, transpose,
                            symmetric, *table.values)


def chunked_block_apply_plain(vals, row_chunk, col_chunk, chunk: int, x,
                              out_len: int, *, transpose: bool = False,
                              symmetric: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernel: same tables, same result."""
    return chunked_bucket_apply(vals, row_chunk, col_chunk, chunk, out_len, x,
                                transpose=transpose, symmetric=symmetric)


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
    if x.dtype != vals.dtype:
        raise TypeError(f"x dtype {x.dtype} != values dtype {vals.dtype}")
    if symmetric and x.shape[0] != out_len:
        raise ValueError(
            f"symmetric pass needs a square operand: x rows {x.shape[0]} "
            f"!= out_len {out_len}")
    devs = {t.device for t in (vals, row_chunk, col_chunk, x)}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devs))}")


def chunked_block_apply(vals, row_chunk, col_chunk, chunk: int, x,
                        out_len: int, *, transpose: bool = False,
                        symmetric: bool = False) -> torch.Tensor:
    """Fused chunk-granular block product of one bucket: [out_len] or
    [out_len, r]."""
    global LAUNCHES, SYM_LAUNCHES
    mode = launch_mode(transpose, symmetric)
    _check(vals, row_chunk, col_chunk, chunk, x, out_len, symmetric)
    if x.device.type == "cpu":
        return chunked_block_apply_plain(
            vals, row_chunk, col_chunk, chunk, x, out_len,
            transpose=transpose, symmetric=symmetric)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if vals.dtype == torch.float32:
        fn_name = "bst_fused_spmm_f32"
    elif vals.dtype == torch.float64:
        fn_name = "bst_fused_spmm_f64"
    else:
        raise TypeError(f"fused_spmm kernel takes float32/float64, got {vals.dtype}")
    for name, t in (("row_chunk", row_chunk), ("col_chunk", col_chunk)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    vec = x.ndim == 1
    xm = (x[:, None] if vec else x).contiguous()
    n_in, r = xm.shape
    vals = vals.contiguous()
    row_chunk, col_chunk = row_chunk.contiguous(), col_chunk.contiguous()
    nb, mp, kp = vals.shape
    y = torch.zeros((out_len, r), dtype=vals.dtype, device=x.device)
    if nb and r and out_len:
        build.launch(fn_name, x.device, vals.data_ptr(), row_chunk.data_ptr(),
                     col_chunk.data_ptr(), xm.data_ptr(), y.data_ptr(), nb, mp,
                     kp, chunk, r, n_in, out_len, mode)
        LAUNCHES += 1
        SYM_LAUNCHES += symmetric
    return y[:, 0] if vec else y
