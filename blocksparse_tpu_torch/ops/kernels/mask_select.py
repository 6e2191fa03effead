"""Element gather and scatter-add: CUDA kernel B9, plain versions, autograd.

The kernels (``csrc/mask_select.cu``) replace
``blocksparse_tpu/ops/pallas/mask_select.py::_gather_kernel`` and
``::_scatter_kernel``: the gather ``out = x[idx]`` and the scatter-add
``y[idx] += v`` of the element engine (``ops/torch_spmv.bucket_apply`` with
``mask_gs=True``) for f32 vectors, i.e. SpMV with element buckets.

Sentinel convention (``core/layout.py``): an index at or past ``n`` gathers
0, and one at or past ``out_len`` scatters nowhere.

Race-freedom: indices repeat, so the scatter kernel adds into a zeroed output
(allocated here with ``torch.zeros``) with fp32 ``atomicAdd``; the summation
order varies from run to run.

Routing: a CPU tensor takes the plain version (:func:`mask_gather_plain`,
:func:`mask_scatter_add_plain`); a CUDA tensor launches the kernel or
raises.  ``GATHER_LAUNCHES`` and ``SCATTER_LAUNCHES`` count kernel launches.
:func:`gather_apply` and :func:`scatter_apply` add autograd: each is the
other's adjoint, so a backward pass runs the other kernel.
"""

from __future__ import annotations

import torch

from ...utils import build
from ..torch_spmv import gather_rows, scatter_rows

__all__ = ["mask_gather", "mask_gather_plain", "mask_scatter_add",
           "mask_scatter_add_plain", "gather_apply", "scatter_apply",
           "GATHER_LAUNCHES", "SCATTER_LAUNCHES"]

GATHER_LAUNCHES = 0
SCATTER_LAUNCHES = 0


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
