"""Batched merged-patch SpMM: CUDA kernel B4, its plain version, its autograd.

The kernel (``csrc/batched_spmm.cu``) replaces the forward mode of
``blocksparse_tpu/ops/batched.py::_kern_batched``: P same-structure patch
SpMMs in one launch.  The P operators share one patch plan's tables (``cc``
[nb, KP/32], ``rs`` [nb]) and stack their values [P, nb, MP, KP]; for every
product p and slot b

  forward    Y[p, rs[b] : rs[b] + MP] += V[p, b] @ concat_j X[p, cc[b, j]*32 : +32]
  transpose  the 32-row chunks cc[b, j] of Y[p] += V[p, b]^T @ X[p, rs[b] : +MP]

X is [P, n_in, r] and Y [P, n_out, r]: rows past X's end read zero and rows
past Y's end are dropped (the JAX wrapper padded both and cut Y).  Any r is
taken in one launch, so the JAX package's ``R_SLICE`` split is not needed.
The transpose mode (the backward's dX) runs kernel B2's transposed product
with its product axis (``ops/patch_engine.transpose_spmm``: one prologue
and one ``csrc/patch_spmm_tr.cu`` launch for all P products, counted in
``patch_engine.XT_LAUNCHES`` and ``TR_LAUNCHES``).

Race-freedom: the kernel adds into a zeroed output with fp32
``atomicAdd(float4*)``; the summation order varies from run to run.

Precision: the kernel runs on the tensor cores at ``precision``'s tier
(``ops/patch_engine.TIERS``): 3xTF32 for "highest" (the wrapper's
default) and "high", one TF32 pass for None.  The plain version is exact
in the operands' dtype at every tier.

Routing: CPU tensors take :func:`batched_spmm_plain`; CUDA tensors launch
the kernels or raise.  ``LAUNCHES`` counts B4's launches.

Gradient: :func:`batched_spmm_apply` mirrors the JAX package's
``_batched_bwd``: dX is the product in the other mode, dvals torch ops on
the gathered rows.
"""

from __future__ import annotations

import torch

from ...core.patch import CC
from ...utils import build
from ..patch_engine import (_aligned, _window_rows, precision_tier,
                            transpose_spmm)
from ..torch_spmv import chunk_rows

__all__ = ["batched_spmm", "batched_spmm_plain", "batched_spmm_apply",
           "LAUNCHES"]

LAUNCHES = 0


def _gather(X: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """X[:, idx] for [P, n, r] ``X``; indices >= n read zero."""
    n = X.shape[1]
    ext = torch.cat([X, X.new_zeros((X.shape[0], 1, X.shape[2]))], dim=1)
    return ext[:, idx.long().clamp(max=n)]


def _scatter(n_out: int, idx: torch.Tensor, upd: torch.Tensor) -> torch.Tensor:
    """Y = zeros(P, n_out, r); Y[:, idx] += upd, rows >= n_out dropped."""
    P, r = upd.shape[0], upd.shape[-1]
    acc = upd.new_zeros((P, n_out + 1, r))
    acc.index_add_(1, idx.reshape(-1).long().clamp(max=n_out),
                   upd.reshape(P, -1, r))
    return acc[:, :n_out]


def batched_spmm_plain(vals, cc, rs, X, n_out: int, *,
                       transpose: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same tables with a leading
    P dimension on the values, X and Y."""
    win, cols = _window_rows(rs, vals.shape[2]), chunk_rows(cc, CC)
    if transpose:
        yt = torch.einsum("pbmk,pbmr->pbkr", vals, _gather(X, win))
        return _scatter(n_out, cols, yt)
    yp = torch.einsum("pbmk,pbkr->pbmr", vals, _gather(X, cols))
    return _scatter(n_out, win, yp)


def _check(vals, cc, rs, X) -> bool:
    """Validate the tensors; True when the kernel is to run (CUDA), False
    for the plain version (CPU)."""
    if vals.ndim != 4 or vals.shape[3] % CC:
        raise ValueError(f"vals must be [P, nb, MP, KP] with KP % {CC} == 0, "
                         f"got {tuple(vals.shape)}")
    P, nb, MP, KP = vals.shape
    if tuple(cc.shape) != (nb, KP // CC) or tuple(rs.shape) != (nb,):
        raise ValueError(f"tables {tuple(cc.shape)}, {tuple(rs.shape)} do not "
                         f"match vals {tuple(vals.shape)}")
    if X.ndim != 3 or X.shape[0] != P:
        raise ValueError(f"X must be [P={P}, n, r], got {tuple(X.shape)}")
    if X.dtype != vals.dtype:
        raise TypeError(f"X dtype {X.dtype} != values dtype {vals.dtype}")
    devs = {t.device for t in (vals, cc, rs, X)}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devs))}")
    if X.device.type == "cpu":
        return False
    if X.device.type != "cuda":
        raise ValueError(f"no kernel for device {X.device}")
    if vals.dtype != torch.float32:
        raise TypeError(f"the batched SpMM kernel is float32, got {vals.dtype}")
    if cc.dtype != torch.int32 or rs.dtype != torch.int32:
        raise TypeError(f"plan tables must be int32, got {cc.dtype}, {rs.dtype}")
    return True


def batched_spmm(vals, cc, rs, X, n_out: int, *, transpose: bool = False,
                 precision="highest") -> torch.Tensor:
    """Y [P, n_out, r] = the P products of one patch plan's tables with
    their stacked values, applied to X [P, n_in, r], at ``precision``'s
    tier on CUDA tensors (the forward on kernel B4, the transpose on B2's
    transposed product), the plain version on CPU tensors."""
    global LAUNCHES
    tier = precision_tier(precision)
    if not _check(vals, cc, rs, X):
        return batched_spmm_plain(vals, cc, rs, X, n_out, transpose=transpose)
    if transpose:
        return transpose_spmm(vals, cc, rs, X, n_out, tier)
    P, nb, MP, KP = vals.shape
    X = _aligned(X.contiguous())
    vals = _aligned(vals.contiguous())
    cc, rs = cc.contiguous(), rs.contiguous()
    n_in, r = X.shape[1], X.shape[2]
    Y = torch.zeros((P, n_out, r), dtype=torch.float32, device=X.device)
    if P and nb and r and n_out:
        build.launch("bst_batched_spmm_f32", X.device, vals.data_ptr(),
                     cc.data_ptr(), rs.data_ptr(), X.data_ptr(), Y.data_ptr(),
                     P, nb, MP, KP, r, n_in, n_out, tier)
        LAUNCHES += 1
    return Y


class _BatchedSpmm(torch.autograd.Function):
    """Exact cotangents (mirrors the JAX package's ``_batched_bwd``): dX is
    the product in the other mode, dvals torch ops on the gathered rows."""

    @staticmethod
    def forward(ctx, vals, cc, rs, X, n_out, transpose, precision="highest"):
        ctx.save_for_backward(vals, cc, rs, X)
        ctx.transpose, ctx.precision = transpose, precision
        return batched_spmm(vals, cc, rs, X, n_out, transpose=transpose,
                            precision=precision)

    @staticmethod
    def backward(ctx, g):
        vals, cc, rs, X = ctx.saved_tensors
        g = g.contiguous()
        dvals = dX = None
        if ctx.needs_input_grad[3]:
            dX = _BatchedSpmm.apply(vals, cc, rs, g, X.shape[1],
                                    not ctx.transpose, ctx.precision)
        if ctx.needs_input_grad[0]:
            win, cols = _window_rows(rs, vals.shape[2]), chunk_rows(cc, CC)
            a, b = (X, g) if ctx.transpose else (g, X)
            dvals = torch.einsum("pbmr,pbkr->pbmk", _gather(a, win),
                                 _gather(b, cols))
        return dvals, None, None, dX, None, None, None


def batched_spmm_apply(vals, cc, rs, X, n_out: int, *,
                       transpose: bool = False,
                       precision="highest") -> torch.Tensor:
    """:func:`batched_spmm` with autograd in X and the stacked values; the
    backward's dX runs at the same tier."""
    return _BatchedSpmm.apply(vals, cc, rs, X, n_out, transpose, precision)
