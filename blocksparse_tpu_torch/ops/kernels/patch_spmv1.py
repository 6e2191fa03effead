"""Merged-patch SpMV (r = 1): CUDA kernel B7, its plain versions, autograd.

The kernel (``csrc/patch_spmv1.cu``) replaces
``blocksparse_tpu/ops/patch_engine.py::_kern1_f``, ``::_kern1_t`` and
``::_kern1_m`` together with the one-hot chunk gathers and scatters that
``patch_spmv_kernel`` ran around them: one launch applies one bucket of a
patch plan (``core/patch.py``) to a vector, gathering x and adding into y
itself.  Modes, for slot b with row window ``rs[b] + m`` and columns
``cc[b, k // 32] * 32 + k % 32``:

  f  y[window] += V_b @ x[columns]                        (A x)
  t  y[columns] += V_b^T @ x[window]                      (A^T x)
  m  both from one read of V_b, the second only on chunks j < mk[b]
     (a symmetric plan: its stored off-diagonal chunks, the JAX ``flag``)
  a  the transpose of m, which the backward pass runs for dx

x indices past len(x) read zero and y indices past ``n_out`` are dropped.
The JAX package's ``patch_kernel_ok`` (G % 8 == 0, a Mosaic tiling rule) has
no counterpart: the kernel takes any slot count.

Race-freedom: slots run concurrently and share output rows and columns,
so the kernel adds into a zeroed output with fp32 ``atomicAdd``; the
summation order varies from run to run.

Routing: a CPU tensor takes the plain version (:func:`patch_spmv1_plain`);
a CUDA tensor launches the kernel or raises.  ``LAUNCHES`` counts B7's
launches.  :func:`spmv1_plain` is the per-slot contraction alone, with the
JAX kernel's signature, so the tests can hold it against
``_spmv_kernel_raw``.

Gradient: :func:`patch_spmv1_apply` mirrors the JAX ``_spmv1_bwd`` around
the whole product: dx is kernel B7 in the transposed role (f and t swap, m
and a swap), dvals is torch ops on the gathered vectors.
"""

from __future__ import annotations

import torch

from ...core.patch import CC
from ...utils import build
from ..torch_spmv import chunk_rows

__all__ = ["spmv1_plain", "patch_spmv1_plain", "patch_spmv1",
           "patch_spmv1_apply", "MODES", "LAUNCHES"]

LAUNCHES = 0   # kernel B7

MODES = {"f": 0, "t": 1, "m": 2, "a": 3}
_ADJOINT = {"f": "t", "t": "f", "m": "a", "a": "m"}
_DROP = torch.iinfo(torch.int64).max // 2   # an index past any vector


def spmv1_plain(vals, xg, xr, mode: str):
    """The per-slot contractions of the JAX ``_spmv_kernel_raw``:
    ``f`` -> V xg [nb, MP], ``t`` -> V^T xr [nb, KP], ``m`` -> both."""
    if mode == "f":
        return torch.einsum("bmk,bk->bm", vals, xg)
    if mode == "t":
        return torch.einsum("bmk,bm->bk", vals, xr)
    if mode == "m":
        return (torch.einsum("bmk,bk->bm", vals, xg),
                torch.einsum("bmk,bm->bk", vals, xr))
    raise ValueError(f"unknown mode {mode!r}; expected 'f', 't' or 'm'")


def _sides(vals, cc, rs, mk, mode: str):
    """(window rows [nb, MP], the forward pass's column indices, the
    transposed pass's column indices) -- None for a pass the mode lacks;
    masked chunks index past any vector."""
    MP = vals.shape[1]
    win = rs.long()[:, None] + torch.arange(MP, device=rs.device)
    cols = chunk_rows(cc, CC)
    if mode == "f":
        return win, cols, None
    if mode == "t":
        return win, None, cols
    j = torch.arange(cols.shape[1], device=cc.device) // CC
    mir = torch.where(j[None, :] < mk.long()[:, None], cols, _DROP)
    return (win, cols, mir) if mode == "m" else (win, mir, cols)


def _gather(x, idx):
    n = x.shape[0]
    return torch.cat([x, x.new_zeros(1)])[idx.clamp(max=n)]


def _scatter(n: int, idx, upd):
    return upd.new_zeros(n + 1).index_add_(
        0, idx.reshape(-1).clamp(max=n), upd.reshape(-1))[:n]


def patch_spmv1_plain(vals, cc, rs, mk, x, n_out: int, mode: str):
    """Plain PyTorch version of kernel B7 for one bucket: direct chunk
    gathers and ``index_add_`` where the JAX package used one-hot matmuls;
    any floating dtype."""
    win, fcols, tcols = _sides(vals, cc, rs, mk, mode)
    V = vals.to(x.dtype)
    y = x.new_zeros(n_out)
    if fcols is not None:
        y = y + _scatter(n_out, win, spmv1_plain(V, _gather(x, fcols), None,
                                                 "f"))
    if tcols is not None:
        y = y + _scatter(n_out, tcols, spmv1_plain(V, None, _gather(x, win),
                                                   "t"))
    return y


def _check(vals, cc, rs, mk, x, mode: str) -> bool:
    """Validate one bucket's tensors; True when the kernel is to run (CUDA
    tensors), False for the plain version (CPU tensors)."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {list(MODES)}")
    if vals.ndim != 3 or vals.shape[2] % CC:
        raise ValueError(f"vals must be [nb, MP, KP] with KP % {CC} == 0, "
                         f"got {tuple(vals.shape)}")
    nb, MP, KP = vals.shape
    if tuple(cc.shape) != (nb, KP // CC) or tuple(rs.shape) != (nb,):
        raise ValueError(f"tables {tuple(cc.shape)}, {tuple(rs.shape)} do not "
                         f"match vals {tuple(vals.shape)}")
    tables = (cc, rs)
    if mode in ("m", "a"):
        if mk is None or tuple(mk.shape) != (nb,):
            raise ValueError(f"mode {mode!r} needs mk of shape ({nb},)")
        tables += (mk,)
    if x.ndim != 1:
        raise ValueError(f"x must be a vector [n], got {tuple(x.shape)}")
    if x.dtype != vals.dtype:
        raise TypeError(f"x dtype {x.dtype} != values dtype {vals.dtype}")
    devs = {t.device for t in (vals, x, *tables)}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devs))}")
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if vals.dtype != torch.float32:
        raise TypeError(f"the patch SpMV kernel is float32, got {vals.dtype}")
    if MP % 8 or KP % 128:
        raise ValueError(f"the patch SpMV kernel takes MP % 8 == 0 and "
                         f"KP % 128 == 0, got {MP}x{KP}")
    if any(t.dtype != torch.int32 for t in tables):
        raise TypeError(f"plan tables must be int32, got "
                        f"{[t.dtype for t in tables]}")
    return True


def patch_spmv1(vals, cc, rs, mk, x, n_out: int, mode: str) -> torch.Tensor:
    """y [n_out] = one patch bucket applied to x [n_in] in ``mode``: kernel
    B7 for CUDA tensors, its plain version for CPU tensors."""
    global LAUNCHES
    if not _check(vals, cc, rs, mk, x, mode):
        return patch_spmv1_plain(vals, cc, rs, mk, x, n_out, mode)
    x, vals = x.contiguous(), vals.contiguous()
    cc, rs = cc.contiguous(), rs.contiguous()
    mk = mk.contiguous() if mode in ("m", "a") else None
    nb, MP, KP = vals.shape
    y = torch.zeros(n_out, dtype=torch.float32, device=x.device)
    if nb and n_out:
        build.launch("bst_patch_spmv1_f32", x.device, vals.data_ptr(),
                     cc.data_ptr(), rs.data_ptr(),
                     None if mk is None else mk.data_ptr(), x.data_ptr(),
                     y.data_ptr(), nb, MP, KP, x.shape[0], n_out, MODES[mode])
        LAUNCHES += 1
    return y


class _PatchSpmv1(torch.autograd.Function):
    """Exact cotangents (the JAX ``_spmv1_bwd`` around the whole product):
    dx is kernel B7 in the transposed role, dvals torch ops on the gathered
    vectors."""

    @staticmethod
    def forward(ctx, vals, cc, rs, mk, x, n_out, mode):
        ctx.save_for_backward(vals, cc, rs, mk, x)
        ctx.mode = mode
        return patch_spmv1(vals, cc, rs, mk, x, n_out, mode)

    @staticmethod
    def backward(ctx, g):
        vals, cc, rs, mk, x = ctx.saved_tensors
        g = g.contiguous()
        dvals = dx = None
        if ctx.needs_input_grad[4]:
            dx = _PatchSpmv1.apply(vals, cc, rs, mk, g, x.shape[0],
                                   _ADJOINT[ctx.mode])
        if ctx.needs_input_grad[0]:
            win, fcols, tcols = _sides(vals, cc, rs, mk, ctx.mode)
            dvals = torch.zeros_like(vals)
            if fcols is not None:   # y[win] += V x[fcols]
                dvals = dvals + _gather(g, win)[:, :, None] * \
                    _gather(x, fcols)[:, None, :]
            if tcols is not None:   # y[tcols] += V^T x[win]
                dvals = dvals + _gather(x, win)[:, :, None] * \
                    _gather(g, tcols)[:, None, :]
        return dvals, None, None, None, dx, None, None


def patch_spmv1_apply(vals, cc, rs, mk, x, n_out: int, mode: str):
    """:func:`patch_spmv1` with autograd in ``x`` and ``vals``."""
    return _PatchSpmv1.apply(vals, cc, rs, mk, x, n_out, mode)
