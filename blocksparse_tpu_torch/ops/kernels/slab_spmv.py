"""Slab SpMV: CUDA kernel B8, its plain version, its autograd.

The kernel (``csrc/slab_spmv.cu``) replaces
``blocksparse_tpu/ops/pallas/slab_spmv.py::_kernel_plain``,
``::_kernel_mirror`` and their core-split variants ``_kernel_plain_mc`` /
``_kernel_mirror_mc``: one launch streams a slab plan (``core/strip.py``)
and returns y = A @ x; a mirror plan adds ``flag``-weighted transposed
products of its tiles from the same read of their values.

Device tensors (:func:`plan_device_arrays`): the values, and per tile the
row id inside the slab's window (RW = padding), the column chunk and the
mirror flag, read off the plan's one-hots ``rs``/``cs`` once at staging.
The one-hots themselves never reach the device.

Race-freedom: warps add their row sums and mirrored sums into a zeroed
output with fp32 ``atomicAdd`` (``csrc/tile_stream.cuh``), where the TPU's
core split kept one private output copy per core; the summation order
varies from run to run.

Routing: a CPU tensor takes :func:`slab_apply_plain`; a CUDA tensor
launches the kernel or raises.  ``LAUNCHES`` counts kernel launches,
``MIRROR_LAUNCHES`` those of them on a mirror plan.

Gradient: :func:`slab_apply` wraps the product in an autograd Function
whose backward runs the plain version's autograd on the same tables, giving
dx and, where the values require it, dvals (the JAX VJP writes the same
cotangents out in XLA).
"""

from __future__ import annotations

import numpy as np
import torch

from ...core.strip import CC, RC, StripPlan
from ...utils import build
from .panel_spmv import _default_tpw

__all__ = ["plan_device_arrays", "slab_spmv", "slab_apply_plain",
           "slab_apply", "LAUNCHES", "MIRROR_LAUNCHES"]

LAUNCHES = 0
MIRROR_LAUNCHES = 0


def plan_device_arrays(plan: StripPlan, device) -> tuple:
    """(vals [S*TS, 8, 128] f32, rid8 [S*TS], cid [S*TS], flag [S*TS] f32,
    b8 [S]) on ``device``, ids int32: each tile's row in the slab window
    (RW where its ``rs`` column is empty: padding) and column chunk (0 for
    padding) from the one-hots."""
    RW = plan.rs.shape[1]
    rid8 = np.where(plan.rs.any(axis=1), plan.rs.argmax(axis=1), RW)
    cid = np.where(plan.cs.any(axis=2), plan.cs.argmax(axis=2), 0)

    def t(a, dtype):
        return torch.from_numpy(
            np.ascontiguousarray(a, dtype=dtype)).to(device)
    return (t(plan.vals, np.float32), t(rid8.reshape(-1), np.int32),
            t(cid.reshape(-1), np.int32), t(plan.flag.reshape(-1), np.float32),
            t(plan.b8, np.int32))


def slab_apply_plain(plan: StripPlan, dev, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same tables, y = A @ x in
    ``x``'s dtype."""
    vals, rid8, cid, flag, b8 = dev
    S, TS, RW = plan.S, plan.TS, plan.rs.shape[1]
    V = vals.to(x.dtype).view(S, TS, RC, CC)
    rid = rid8.view(S, TS).long()
    live = rid < RW
    cols = cid.view(S, TS).long()[..., None] * CC + torch.arange(
        CC, device=x.device)                                     # [S, TS, 128]
    xe = torch.cat([x, x.new_zeros(1)])
    yf = torch.einsum("stmk,stk->stm", V,
                      xe[torch.where(cols < plan.ncols, cols, plan.ncols)])
    rows = ((b8.long()[:, None] + rid) * RC)[..., None] + torch.arange(
        RC, device=x.device)                                     # [S, TS, 8]
    rows = torch.where(live[..., None] & (rows < plan.nrows), rows, plan.nrows)
    y = x.new_zeros(plan.nrows + 1).index_add(0, rows.reshape(-1),
                                              yf.reshape(-1))
    if plan.mirror:
        w = flag.to(x.dtype).view(S, TS, 1)
        yt = torch.einsum("stmk,stm->stk", V, xe[rows] * w)
        ycols = torch.where(live[..., None] & (cols < plan.nrows), cols,
                            plan.nrows)
        y = y.index_add(0, ycols.reshape(-1), yt.reshape(-1))
    return y[:plan.nrows]


def _check(plan: StripPlan, dev, x: torch.Tensor) -> None:
    if x.ndim != 1 or x.shape[0] != plan.ncols:
        raise ValueError(
            f"slab plan takes x of shape ({plan.ncols},), got {tuple(x.shape)}")
    devs = {t.device for t in dev} | {x.device}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devs))}")


def slab_spmv(plan: StripPlan, dev, x: torch.Tensor, *,
              tiles_per_warp: int | None = None) -> torch.Tensor:
    """y = A @ x for a slab plan: kernel B8 on a CUDA tensor, the plain
    version on a CPU tensor."""
    global LAUNCHES, MIRROR_LAUNCHES
    _check(plan, dev, x)
    if x.device.type == "cpu":
        return slab_apply_plain(plan, dev, x)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    vals, rid8, cid, flag, b8 = dev
    if x.dtype != torch.float32 or vals.dtype != torch.float32 or \
            flag.dtype != torch.float32:
        raise TypeError(f"slab kernel takes float32, got {x.dtype}/{vals.dtype}")
    for name, t in (("rid8", rid8), ("cid", cid), ("b8", b8)):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise TypeError(f"{name} must be contiguous int32")
    ntiles = plan.S * plan.TS
    tpw = tiles_per_warp or _default_tpw(ntiles)
    x = x.contiguous()
    y = torch.zeros(plan.nrows, dtype=torch.float32, device=x.device)
    build.launch("bst_slab_spmv_f32", x.device, vals.data_ptr(),
                 rid8.data_ptr(), cid.data_ptr(), flag.data_ptr(),
                 b8.data_ptr(), x.data_ptr(), y.data_ptr(), ntiles, plan.TS,
                 plan.rs.shape[1], plan.ncols, plan.nrows, int(plan.mirror),
                 tpw)
    LAUNCHES += 1
    MIRROR_LAUNCHES += plan.mirror
    return y


class _SlabApply(torch.autograd.Function):
    """Forward: :func:`slab_spmv`.  Backward: the plain version's autograd
    on the same tables (dx = A^T g, and dvals where asked)."""

    @staticmethod
    def forward(ctx, vals, x, plan, rest):
        ctx.save_for_backward(vals, x)
        ctx.plan, ctx.rest = plan, rest
        return slab_spmv(plan, (vals,) + rest, x)

    @staticmethod
    def backward(ctx, g):
        vals, x = ctx.saved_tensors
        need = ctx.needs_input_grad[:2]
        with torch.enable_grad():
            v = vals.detach().requires_grad_(need[0])
            xx = x.detach().requires_grad_(need[1])
            y = slab_apply_plain(ctx.plan, (v,) + ctx.rest, xx)
            wrt = [t for t, n in zip((v, xx), need) if n]
            got = iter(torch.autograd.grad(y, wrt, g))
        return (next(got) if need[0] else None,
                next(got) if need[1] else None, None, None)


def slab_apply(plan: StripPlan, dev, x: torch.Tensor) -> torch.Tensor:
    """:func:`slab_spmv` with autograd in ``x`` and the plan's values."""
    return _SlabApply.apply(dev[0], x, plan, tuple(dev[1:]))
