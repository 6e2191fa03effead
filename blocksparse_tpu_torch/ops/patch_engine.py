"""Merged-patch SpMM (r > 1): CUDA kernel B2, its plain version, its autograd.

Counterpart of the r > 1 part of ``blocksparse_tpu/ops/patch_engine.py``.
The kernel (``csrc/patch_spmm.cu``) replaces ``_kern_fwd`` / ``_kern_tr``:

  forward    Y[rs[b] : rs[b] + MP] += V_b @ concat_j X[cc[b, j]*32 : +32]
  transpose  the 32-row chunks cc[b, j] of Y += V_b^T @ X[rs[b] : rs[b] + MP]

The transpose product swaps the gather/scatter roles over the same storage.

Buffers: the JAX wrapper padded X and Y to ``(NC + 1) * 32`` and
``(NR + MC) * 8`` rows and cut Y afterwards.  Here X and Y keep their true
row counts: rows past X's end read zero (sentinel chunk NC and the ends of
row windows) and rows past Y's end are dropped, which gives the same
result without the copies.

Race-freedom: slots run concurrently and may share output rows, so the
kernel adds into a zeroed output (``torch.zeros``) with fp32 ``atomicAdd``;
the summation order varies from run to run.

Precision: all tiers run in IEEE fp32 FMA (no TF32), which meets the
``"highest"`` tolerance; faster tiers are later work.

Not ported yet (ROADMAP): the symmetric fused kernel ``_kern_mir`` (B3),
the r = 1 one-read kernels (B7) and the one-hot SpMV engine.
"""

from __future__ import annotations

import torch

from ..core.patch import CC, PatchPlan
from ..utils import build
from .torch_spmv import chunk_rows, gather_rows, scatter_rows

__all__ = ["patch_device_arrays", "patch_apply", "patch_spmm",
           "patch_spmm_plain", "bucket_spmm", "bucket_spmm_plain",
           "LAUNCHES"]

LAUNCHES = 0


def patch_device_arrays(plan: PatchPlan, device) -> tuple:
    """Per bucket: (vals f32, cc int32, rs int32, mk int32) on ``device``."""
    return tuple(
        (torch.from_numpy(b.vals).to(device),
         torch.from_numpy(b.col_chunk).to(device),
         torch.from_numpy(b.row_start).to(device),
         torch.from_numpy(b.mirror_kc).to(device))
        for b in plan.buckets
    )


def _window_rows(rs: torch.Tensor, MP: int) -> torch.Tensor:
    return rs.long()[:, None] + torch.arange(MP, device=rs.device)


def bucket_spmm_plain(vals, cc, rs, X, n_out: int, *,
                      transpose: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernel for one bucket."""
    MP = vals.shape[1]
    win, cols = _window_rows(rs, MP), chunk_rows(cc, CC)
    if transpose:
        yt = torch.einsum("bmk,bmr->bkr", vals, gather_rows(X, win))
        return scatter_rows(n_out, cols, yt)
    yp = torch.einsum("bmk,bkr->bmr", vals, gather_rows(X, cols))
    return scatter_rows(n_out, win, yp)


def bucket_spmm(vals, cc, rs, X, n_out: int, *,
                transpose: bool = False) -> torch.Tensor:
    """Y [n_out, r] = one patch bucket applied to X [n_in, r].

    The kernel takes float32 (the plan's dtype); the plain CPU path takes
    any floating dtype."""
    global LAUNCHES
    if vals.ndim != 3 or vals.shape[2] % CC:
        raise ValueError(f"vals must be [nb, MP, KP] with KP % {CC} == 0, "
                         f"got {tuple(vals.shape)}")
    nb, MP, KP = vals.shape
    if tuple(cc.shape) != (nb, KP // CC) or tuple(rs.shape) != (nb,):
        raise ValueError(f"tables {tuple(cc.shape)}, {tuple(rs.shape)} do not "
                         f"match vals {tuple(vals.shape)}")
    if X.ndim != 2:
        raise ValueError(f"X must be [n, r], got {tuple(X.shape)}")
    if X.dtype != vals.dtype:
        raise TypeError(f"X dtype {X.dtype} != values dtype {vals.dtype}")
    devs = {t.device for t in (vals, cc, rs, X)}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devs))}")
    if X.device.type == "cpu":
        return bucket_spmm_plain(vals, cc, rs, X, n_out, transpose=transpose)
    if X.device.type != "cuda":
        raise ValueError(f"no kernel for device {X.device}")
    if vals.dtype != torch.float32:
        raise TypeError(f"the patch SpMM kernel is float32, got {vals.dtype}")
    if cc.dtype != torch.int32 or rs.dtype != torch.int32:
        raise TypeError(f"cc/rs must be int32, got {cc.dtype}, {rs.dtype}")
    X = X.contiguous()
    vals, cc, rs = vals.contiguous(), cc.contiguous(), rs.contiguous()
    n_in, r = X.shape
    Y = torch.zeros((n_out, r), dtype=torch.float32, device=X.device)
    if nb and r and n_out:
        build.launch("bst_patch_spmm_f32", X.device, vals.data_ptr(),
                     cc.data_ptr(), rs.data_ptr(), X.data_ptr(), Y.data_ptr(),
                     nb, MP, KP, r, n_in, n_out, int(transpose))
        LAUNCHES += 1
    return Y


class _PatchSpmm(torch.autograd.Function):
    """Exact cotangents (mirrors the JAX package's
    ``patch_engine._spmm_vjp_bwd``): dX is the same kernel in the other
    mode, dvals is torch ops on the gathered rows."""

    @staticmethod
    def forward(ctx, vals, cc, rs, X, n_out, transpose):
        ctx.save_for_backward(vals, cc, rs, X)
        ctx.transpose = transpose
        return bucket_spmm(vals, cc, rs, X, n_out, transpose=transpose)

    @staticmethod
    def backward(ctx, g):
        vals, cc, rs, X = ctx.saved_tensors
        g = g.contiguous()
        dvals = dX = None
        if ctx.needs_input_grad[3]:
            dX = _PatchSpmm.apply(vals, cc, rs, g, X.shape[0],
                                  not ctx.transpose)
        if ctx.needs_input_grad[0]:
            win, cols = _window_rows(rs, vals.shape[1]), chunk_rows(cc, CC)
            if ctx.transpose:
                dvals = torch.einsum("bmr,bkr->bmk", gather_rows(X, win),
                                     gather_rows(g, cols))
            else:
                dvals = torch.einsum("bmr,bkr->bmk", gather_rows(g, win),
                                     gather_rows(X, cols))
        return dvals, None, None, dX, None, None


def _n_out(plan: PatchPlan, transpose: bool) -> int:
    if plan.symmetric:
        raise NotImplementedError(
            "symmetric patch plans need the fused mirror kernel, which is not "
            "ported yet (ROADMAP: B3)")
    return plan.ncols if transpose else plan.nrows


def patch_spmm(plan: PatchPlan, dev, X, *, transpose: bool = False):
    """Y = A @ X (A^T @ X when ``transpose``); X: [n, r] f32."""
    n_out = _n_out(plan, transpose)
    Y = None
    for vals, cc, rs, _mk in dev:
        part = _PatchSpmm.apply(vals, cc, rs, X, n_out, transpose)
        Y = part if Y is None else Y + part
    if Y is None:
        return X.new_zeros((n_out, X.shape[1]))
    return Y


def patch_spmm_plain(plan: PatchPlan, dev, X, *, transpose: bool = False):
    """Plain version of :func:`patch_spmm` (counterpart of the JAX
    package's ``patch_spmm_xla``), on any device."""
    n_out = _n_out(plan, transpose)
    Y = X.new_zeros((n_out, X.shape[1]))
    for vals, cc, rs, _mk in dev:
        Y = Y + bucket_spmm_plain(vals, cc, rs, X, n_out, transpose=transpose)
    return Y


def patch_apply(plan: PatchPlan, dev, x, *, transpose: bool = False):
    """Entry point for matrix products; the r = 1 vector paths of the JAX
    package are not ported."""
    if x.ndim != 2:
        raise ValueError(f"patch_apply takes [n, r], got {tuple(x.shape)}")
    return patch_spmm(plan, dev, x, transpose=transpose)
