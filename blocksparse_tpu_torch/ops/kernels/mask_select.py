"""Element gather, scatter-add and element pass: CUDA kernel B9, plain
versions, autograd.

The kernels (``csrc/mask_select.cu``) replace
``blocksparse_tpu/ops/pallas/mask_select.py::_gather_kernel`` and
``::_scatter_kernel``: the gather ``out = x[idx]`` and the scatter-add
``y[idx] += v`` of the element engine, i.e. products of element buckets
(``chunk == 1``, arbitrary index lists).

- :func:`element_apply`: the bucket route's element pass
  (``ops/dispatch.py``), every element bucket of a layout in one launch
  over a :class:`~.fused_spmm.BucketTable`, f32, f64, complex64 and
  complex128, forward, transpose or symmetric (``V @ x[cols]`` into
  ``y[rows]``, ``V^T @ x[rows]`` into ``y[cols]``, or both from one read
  of V), each also with ``conj`` (complex: ``conj(V)`` in place of V),
  adding into a given output.  Its plain version, :func:`element_apply_plain`, is the
  per-bucket gather -> einsum -> scatter-add chain
  (:func:`mask_gather_plain` / :func:`mask_scatter_add_plain` on vectors).
- :func:`mask_gather` / :func:`mask_scatter_add`: one gather or one
  scatter-add of f32 vectors (f32 only, as the TPU kernels); the colored element pass
  (``ops/torch_spmv.bucket_apply`` with ``mask_gs=True``) gathers with them.

Sentinel convention (``core/layout.py``): an index at or past ``n`` gathers
0, and one at or past ``out_len`` scatters nowhere.

Race-freedom: indices repeat, so the scatter-add and the element pass add
into a zeroed output (the scatter's allocated here with ``torch.zeros``;
the element pass's given, possibly holding the partial sum of the launches
before it) with fp32/fp64 ``atomicAdd`` (a complex value as two, one per
part); the summation order varies from run to run.

Routing: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises.  ``GATHER_LAUNCHES``, ``SCATTER_LAUNCHES`` and
``ELEMENT_LAUNCHES`` count kernel launches, ``ELEMENT_SYM_LAUNCHES`` the
element passes in the symmetric mode.  :func:`gather_apply` and
:func:`scatter_apply` add autograd (each is the other's adjoint, so a
backward pass runs the other kernel), :func:`element_fused_apply` too (its
x cotangent is the element pass in the transposed mode with the conj flag
flipped; the symmetric mode is its own transpose).
"""

from __future__ import annotations

import torch

from ...utils import build
from ..torch_spmv import gather_rows, scatter_rows
from .fused_spmm import (BucketTable, TableApply, check_table_call,
                         launch_mode, launch_table)

__all__ = ["element_apply", "element_apply_plain", "element_fused_apply",
           "mask_gather", "mask_gather_plain", "mask_scatter_add",
           "mask_scatter_add_plain", "gather_apply", "scatter_apply",
           "ELEMENT_LAUNCHES", "ELEMENT_SYM_LAUNCHES", "GATHER_LAUNCHES",
           "SCATTER_LAUNCHES"]

GATHER_LAUNCHES = 0
SCATTER_LAUNCHES = 0
ELEMENT_LAUNCHES = 0
ELEMENT_SYM_LAUNCHES = 0


def mask_gather_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of the gather: ``x[idx]`` (shape of ``idx``), indices
    >= n read 0."""
    return gather_rows(x[:, None], idx)[..., 0]


def mask_scatter_add_plain(v: torch.Tensor, idx: torch.Tensor,
                           out_len: int) -> torch.Tensor:
    """Plain version of the scatter-add: ``y = zeros(out_len); y[idx] += v``,
    indices >= out_len dropped."""
    return scatter_rows(out_len, idx, v.reshape(-1, 1))[:, 0]


def _check(vec: torch.Tensor, idx: torch.Tensor, name: str,
           numel: int | None = None) -> None:
    if vec.ndim != 1:
        raise ValueError(f"{name} must be 1-D, got {tuple(vec.shape)}")
    if numel is not None and numel != vec.numel():
        raise ValueError(f"{name} has {vec.numel()} elements, indices {numel}")
    if vec.device != idx.device:
        raise ValueError(
            f"tensors on different devices: {vec.device}, {idx.device}")


def _cuda_check(vec: torch.Tensor, idx: torch.Tensor) -> None:
    if vec.device.type != "cuda":
        raise ValueError(f"no kernel for device {vec.device}")
    if vec.dtype != torch.float32:
        raise TypeError(f"mask_select kernels take float32, got {vec.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"indices must be int32, got {idx.dtype}")


def mask_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out = x[idx]`` (shape of ``idx``) for a 1-D ``x``; indices >= n
    read 0."""
    global GATHER_LAUNCHES
    _check(x, idx, "x")
    if x.device.type == "cpu":
        return mask_gather_plain(x, idx)
    _cuda_check(x, idx)
    x, flat = x.contiguous(), idx.contiguous()
    out = torch.empty(idx.shape, dtype=x.dtype, device=x.device)
    if flat.numel():
        build.launch("bst_mask_gather_f32", x.device, x.data_ptr(),
                     x.shape[0], flat.data_ptr(), flat.numel(),
                     out.data_ptr())
        GATHER_LAUNCHES += 1
    return out


def mask_scatter_add(v: torch.Tensor, idx: torch.Tensor,
                     out_len: int) -> torch.Tensor:
    """``y = zeros(out_len); y[idx] += v`` for 1-D ``v`` and ``idx`` of as
    many elements; indices >= out_len dropped."""
    global SCATTER_LAUNCHES
    _check(v, idx, "v", numel=idx.numel())
    if v.device.type == "cpu":
        return mask_scatter_add_plain(v, idx, out_len)
    _cuda_check(v, idx)
    v, flat = v.contiguous(), idx.contiguous()
    y = torch.zeros(out_len, dtype=v.dtype, device=v.device)
    if flat.numel() and out_len:
        build.launch("bst_mask_scatter_add_f32", v.device, v.data_ptr(),
                     flat.data_ptr(), flat.numel(), y.data_ptr(), out_len)
        SCATTER_LAUNCHES += 1
    return y


class _Gather(torch.autograd.Function):
    """d(x[idx]) / dx is the scatter-add of the cotangent."""

    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.n = x.shape[0]
        return mask_gather(x, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        dx = None
        if ctx.needs_input_grad[0]:
            dx = _Scatter.apply(g.reshape(-1), idx.reshape(-1), ctx.n)
        return dx, None


class _Scatter(torch.autograd.Function):
    """d(scatter-add of v) / dv is the gather of the cotangent."""

    @staticmethod
    def forward(ctx, v, idx, out_len):
        ctx.save_for_backward(idx)
        return mask_scatter_add(v, idx, out_len)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        dv = None
        if ctx.needs_input_grad[0]:
            dv = _Gather.apply(g.contiguous(), idx)
        return dv, None, None


def gather_apply(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """:func:`mask_gather` with autograd."""
    return _Gather.apply(x, idx)


def scatter_apply(v: torch.Tensor, idx: torch.Tensor,
                  out_len: int) -> torch.Tensor:
    """:func:`mask_scatter_add` with autograd."""
    return _Scatter.apply(v, idx, out_len)


def element_apply_plain(table: BucketTable, x: torch.Tensor, *, out,
                        transpose: bool = False, symmetric: bool = False,
                        conj: bool = False) -> torch.Tensor:
    """Plain version of the element pass: per bucket, gather -> einsum ->
    scatter-add into ``out`` in place (the element engine's chain, through
    :func:`mask_gather_plain` / :func:`mask_scatter_add_plain` for a vector
    ``x``), with ``conj(V)`` under ``conj``; returns ``out``."""
    out_len = out.shape[0]
    vec = x.ndim == 1

    def gather(idx):
        return mask_gather_plain(x, idx)[..., None] if vec \
            else gather_rows(x, idx)

    def scatter(idx, upd):
        if vec:
            return mask_scatter_add_plain(upd.reshape(-1), idx.reshape(-1),
                                          out_len)
        return scatter_rows(out_len, idx, upd)

    for vals, ridx, cidx, _chunk in table.buckets:
        if conj:
            vals = vals.conj()
        if transpose:
            out += scatter(cidx, torch.einsum("bmk,bmr->bkr", vals,
                                              gather(ridx)))
        else:
            out += scatter(ridx, torch.einsum("bmk,bkr->bmr", vals,
                                              gather(cidx)))
        if symmetric:
            out += scatter(cidx, torch.einsum("bmk,bmr->bkr", vals,
                                              gather(ridx)))
    return out


def element_apply(table: BucketTable, x: torch.Tensor, *, out,
                  transpose: bool = False, symmetric: bool = False,
                  conj: bool = False) -> torch.Tensor:
    """Add every element bucket of ``table`` (chunk 1: element index
    tables) applied to ``x`` ([n] or [n, r]) into ``out`` ([out_len] or
    [out_len, r]) in one launch; returns ``out``.  ``conj``: the buckets'
    conjugates (nothing changes for real values)."""
    global ELEMENT_LAUNCHES, ELEMENT_SYM_LAUNCHES
    conj = conj and table.dtype.is_complex
    mode = launch_mode(transpose, symmetric, conj)
    if any(b[3] != 1 for b in table.buckets):
        raise ValueError("the element pass takes element buckets (chunk 1)")
    check_table_call(table, x, out, symmetric)
    if x.device.type == "cpu":
        return element_apply_plain(table, x, out=out, transpose=transpose,
                                   symmetric=symmetric, conj=conj)
    if launch_table("bst_element_pass", table, x, out, mode):
        ELEMENT_LAUNCHES += 1
        ELEMENT_SYM_LAUNCHES += symmetric
    return out


def element_fused_apply(table: BucketTable, x: torch.Tensor, *, out,
                        transpose: bool = False, symmetric: bool = False,
                        conj: bool = False) -> torch.Tensor:
    """:func:`element_apply` with autograd (in ``x``, ``out`` and the
    table's values; x's cotangent is the element pass in the transposed
    mode with the conj flag flipped)."""
    return TableApply.apply(out, x, table, element_apply, transpose,
                            symmetric, conj, *table.values)
