"""Chunk-table block product: CUDA kernel B1, its plain version, its autograd.

The kernel (``csrc/fused_spmm.cu``) replaces
``blocksparse_tpu/ops/pallas/fused_spmm.py::_kernel``.  For each stored block
b of a chunked bucket it adds ``V_b @ x[in chunks]`` into ``y[out chunks]``
(``V_b^T`` with the tables swapped when ``transpose``; both contributions
from one read of ``V_b`` when ``symmetric``).

Race-freedom: thread blocks run concurrently and blocks may share output
rows, so the kernel adds into a zeroed output (allocated here with
``torch.zeros``) with fp32/fp64 ``atomicAdd``.  The summation order varies
from run to run; compare with a tolerance, not bit for bit.

Precision: every tier (``"highest"``, ``"high"``, ``None``) runs in IEEE
fp32/fp64 FMA, with no TF32, which meets the ``"highest"`` tolerance.
Faster tiers are later work.

Routing: a CPU tensor takes :func:`chunked_block_apply_plain`; a CUDA tensor
launches the kernel or raises.  ``LAUNCHES`` counts kernel launches,
``SYM_LAUNCHES`` those of them in the symmetric mode.
"""

from __future__ import annotations

import torch

from ...utils import build
from ..torch_spmv import chunk_rows, chunked_bucket_apply, gather_rows

__all__ = ["chunked_block_apply", "chunked_block_apply_plain", "fused_apply",
           "LAUNCHES", "SYM_LAUNCHES"]

LAUNCHES = 0
SYM_LAUNCHES = 0

_MODES = {(False, False): 0, (True, False): 1, (False, True): 2}


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
    """Fused chunk-granular block product: [out_len] or [out_len, r]."""
    global LAUNCHES, SYM_LAUNCHES
    if symmetric and transpose:
        raise ValueError(
            "symmetric fused pass is transpose-invariant; use transpose=False")
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
    out_tab, in_tab = (col_chunk, row_chunk) if transpose else (row_chunk, col_chunk)
    out_tab, in_tab = out_tab.contiguous(), in_tab.contiguous()
    nb, mp, kp = vals.shape
    y = torch.zeros((out_len, r), dtype=vals.dtype, device=x.device)
    if nb and r and out_len:
        build.launch(fn_name, x.device, vals.data_ptr(), out_tab.data_ptr(),
                     in_tab.data_ptr(), xm.data_ptr(), y.data_ptr(), nb, mp,
                     kp, chunk, r, n_in, out_len,
                     _MODES[(transpose, symmetric)])
        LAUNCHES += 1
        SYM_LAUNCHES += symmetric
    return y[:, 0] if vec else y


class _FusedApply(torch.autograd.Function):
    """Exact cotangents of the linear product (mirrors the JAX package's
    ``dispatch._pallas_vjp_bwd``): dx is the same kernel in the other mode,
    dvals is torch ops on the gathered chunks."""

    @staticmethod
    def forward(ctx, vals, row_chunk, col_chunk, x, chunk, out_len, transpose,
                symmetric):
        ctx.save_for_backward(vals, row_chunk, col_chunk, x)
        ctx.cfg = (chunk, transpose, symmetric)
        return chunked_block_apply(vals, row_chunk, col_chunk, chunk, x,
                                   out_len, transpose=transpose,
                                   symmetric=symmetric)

    @staticmethod
    def backward(ctx, g):
        vals, rc, cc, x = ctx.saved_tensors
        chunk, transpose, symmetric = ctx.cfg
        g = g.contiguous()
        dvals = dx = None
        if ctx.needs_input_grad[3]:
            dx = _FusedApply.apply(vals, rc, cc, g, chunk, x.shape[0],
                                   not transpose and not symmetric, symmetric)
        if ctx.needs_input_grad[0]:
            gm = g[:, None] if g.ndim == 1 else g
            xm = x[:, None] if x.ndim == 1 else x
            rows, cols = chunk_rows(rc, chunk), chunk_rows(cc, chunk)
            if symmetric:
                dvals = (torch.einsum("bmr,bkr->bmk", gather_rows(gm, rows),
                                      gather_rows(xm, cols))
                         + torch.einsum("bmr,bkr->bmk", gather_rows(xm, rows),
                                        gather_rows(gm, cols)))
            elif transpose:
                dvals = torch.einsum("bmr,bkr->bmk", gather_rows(xm, rows),
                                     gather_rows(gm, cols))
            else:
                dvals = torch.einsum("bmr,bkr->bmk", gather_rows(gm, rows),
                                     gather_rows(xm, cols))
        return dvals, None, None, dx, None, None, None, None


def fused_apply(vals, row_chunk, col_chunk, chunk: int, x, out_len: int, *,
                transpose: bool = False, symmetric: bool = False):
    """:func:`chunked_block_apply` with autograd."""
    return _FusedApply.apply(vals, row_chunk, col_chunk, x, chunk, out_len,
                             transpose, symmetric)
