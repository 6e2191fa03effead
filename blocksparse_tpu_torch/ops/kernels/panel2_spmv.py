"""Panel v2 SpMV: CUDA kernel B10, its plain version, its autograd.

The kernel (``csrc/panel2_spmv.cu``) replaces
``blocksparse_tpu/ops/pallas/panel2_spmv.py::_k_fwd`` and ``::_k_sym`` with
the x gather (``_gather_xs2``) and the mirror map-back of its ``_launch``:
one launch streams a v2 panel plan (``core/panel2.py``) and returns
y = A @ x; a mirror plan also adds each stored off-diagonal's transposed
product from the same read of its values.

Device tensors (:func:`panel2_device_arrays`): the values, the per-tile row
and compact-chunk ids, the segment table and, for mirror plans, the target
table ``tgt`` in the plan's own [S, CW*NSEG] order (the JAX package's
[S, NSEG, CW] relayout served Mosaic and is not made).

Design: kernel B5's bulk-copy ring (``csrc/panel_ring.cuh``) on the v2
geometry: persistent blocks over ranges of the tile stream, one producer
warp feeding 1-D bulk copies of the live tiles and each stage's tables --
per tile NSEG x bases ``segid * seg`` and, on a mirror plan, y bases
``tgt * seg`` (-1 for the sentinels NC and n_yseg) -- into its ring
slots, a slab's mirrored sums kept in shared memory.
:func:`panel2_geometry` reports the launch a plan gets.

Race-freedom: every sum goes into a zeroed output with fp32 atomics (a
block's mirrored sums meet in shared memory first); the summation order
varies from run to run.  ``tiles_per_block`` moves sums between registers,
shared memory and atomics without changing the product.

Routing: a CPU tensor takes the plain version (:func:`panel2_apply_plain`,
the counterpart of the JAX ``_xla_forward``); a CUDA tensor launches the
kernel or raises.  ``LAUNCHES`` counts B10's launches, ``MIRROR_LAUNCHES``
those of them on a mirror plan.

Gradient: :func:`panel2_apply` wraps the product in B5's autograd Function
(``panel_spmv.StreamApply``), whose backward runs the plain version's
autograd on the same tables (the JAX ``_panel2_vjp_bwd`` likewise
differentiates ``_xla_forward``), giving dx and, where the values require
it, dvals.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...core.panel2 import Panel2Plan
from ...core.strip import CC, RC
from ...utils import build
from .panel_spmv import PANEL_MODES, StreamApply

__all__ = ["panel2_device_arrays", "panel2_spmv", "panel2_apply_plain",
           "panel2_apply", "panel2_geometry", "LAUNCHES", "MIRROR_LAUNCHES"]

LAUNCHES = 0          # kernel B10
MIRROR_LAUNCHES = 0


def panel2_device_arrays(plan: Panel2Plan, device) -> tuple:
    """(vals [S*TS, 8, 128] f32, rid8 [S*TS], cid8 [S*TS], segid
    [S*CW*NSEG], tgt [S*CW*NSEG] or None, b8 [S]) on ``device``."""
    def flat(a):
        return None if a is None else torch.from_numpy(
            np.ascontiguousarray(a).reshape(-1)).to(device)
    vals = torch.from_numpy(np.ascontiguousarray(plan.vals)).to(device)
    return (vals, flat(plan.rid8), flat(plan.cid8), flat(plan.segid),
            flat(plan.tgt), flat(plan.b8))


def _lane_index(plan: Panel2Plan, table: torch.Tensor, sentinel: int,
                limit: int) -> torch.Tensor:
    """x / y index of every lane [S, CW, 128] for a segment table
    (entries >= ``sentinel`` dropped); ``limit`` for dropped lanes and
    indices >= ``limit``."""
    seg = plan.seg
    t = table.view(plan.S, plan.CW * plan.nseg).long()
    idx = (t[..., None] * seg + torch.arange(seg, device=t.device)).view(
        plan.S, plan.CW, CC)
    live = (t < sentinel)[..., None].expand(-1, -1, seg).reshape(
        plan.S, plan.CW, CC)
    return torch.where(live & (idx < limit), idx, limit)


def panel2_apply_plain(plan: Panel2Plan, dev, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel B10: the same tables, y = A @ x in
    ``x``'s dtype."""
    vals, rid8, cid8, segid, tgt, b8 = dev
    S, TS, CW = plan.S, plan.TS, plan.CW
    V = vals.to(x.dtype).view(S, TS, RC, CC)
    xe = torch.cat([x, x.new_zeros(1)])
    xs = xe[_lane_index(plan, segid, plan.NC, plan.ncols)]    # [S, CW, 128]
    xs = torch.cat([xs, xs.new_zeros(S, 1, CC)], dim=1)        # CW = padding
    cid = cid8.view(S, TS).long()[..., None].expand(-1, -1, CC)
    yf = torch.einsum("stmk,stk->stm", V, torch.gather(xs, 1, cid))
    rid = rid8.view(S, TS).long()
    rows = ((b8.long()[:, None] + rid) * RC)[..., None] + torch.arange(
        RC, device=rid.device)
    rows = torch.where((rid < plan.RW)[..., None] & (rows < plan.nrows),
                       rows, plan.nrows)
    y = x.new_zeros(plan.nrows + 1).index_add(0, rows.reshape(-1),
                                              yf.reshape(-1))
    if plan.mirror:
        yt = torch.einsum("stmk,stm->stk", V, xe[rows])
        ym = x.new_zeros(S, CW + 1, CC).scatter_add(1, cid, yt)[:, :CW]
        tix = _lane_index(plan, tgt, plan.n_yseg, plan.nrows)
        y = y.index_add(0, tix.reshape(-1), ym.reshape(-1))
    return y[:plan.nrows]


def _check(plan: Panel2Plan, dev, x: torch.Tensor) -> None:
    if x.ndim != 1 or x.shape[0] != plan.ncols:
        raise ValueError(
            f"panel v2 plan takes x of shape ({plan.ncols},), got "
            f"{tuple(x.shape)}")
    if plan.mirror and dev[4] is None:
        raise ValueError("mirror plan staged without its tgt table")
    devs = {t.device for t in dev if t is not None} | {x.device}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devs))}")


def panel2_geometry(plan: Panel2Plan) -> dict:
    """The launch B10 takes for ``plan`` on the current card, as the
    kernel's C entry decides it (as :func:`panel_spmv.panel_geometry` for
    B5): ring ``stages``, ``mode`` (one of ``PANEL_MODES``), dynamic
    shared-memory bytes, ``blocks``, ``tiles_per_block`` and ``per_sm``.
    Builds the kernels' library."""
    out = (ctypes.c_longlong * 6)()
    build.check(build.load_library().bst_panel2_spmv_geometry(
        plan.S * plan.TS, plan.CW, plan.seg, int(plan.mirror), out),
        "bst_panel2_spmv_geometry")
    return {"stages": out[0], "mode": PANEL_MODES[out[1]], "smem": out[2],
            "blocks": out[3], "tiles_per_block": out[4], "per_sm": out[5]}


def panel2_spmv(plan: Panel2Plan, dev, x: torch.Tensor, *,
                tiles_per_block: int | None = None) -> torch.Tensor:
    """y = A @ x for a v2 panel plan: kernel B10 on a CUDA tensor, the plain
    version on a CPU tensor.  ``tiles_per_block``: the range of the tile
    stream each block takes (default: the kernel's geometry)."""
    global LAUNCHES, MIRROR_LAUNCHES
    _check(plan, dev, x)
    if x.device.type == "cpu":
        return panel2_apply_plain(plan, dev, x)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    vals, rid8, cid8, segid, tgt, b8 = dev
    if x.dtype != torch.float32 or vals.dtype != torch.float32:
        raise TypeError(f"panel v2 kernel takes float32, got "
                        f"{x.dtype}/{vals.dtype}")
    for name, t in (("rid8", rid8), ("cid8", cid8), ("segid", segid),
                    ("tgt", tgt), ("b8", b8)):
        if t is not None and (t.dtype != torch.int32 or not t.is_contiguous()):
            raise TypeError(f"{name} must be contiguous int32")
    x = x.contiguous()
    y = torch.zeros(plan.nrows, dtype=torch.float32, device=x.device)
    mirror = plan.mirror
    build.launch("bst_panel2_spmv_f32", x.device, vals.data_ptr(),
                 rid8.data_ptr(), cid8.data_ptr(), segid.data_ptr(),
                 tgt.data_ptr() if mirror else None, b8.data_ptr(),
                 x.data_ptr(), y.data_ptr(), plan.S * plan.TS, plan.TS,
                 plan.CW, plan.RW, plan.seg, plan.NC, plan.ncols, plan.nrows,
                 int(mirror), tiles_per_block or 0)
    LAUNCHES += 1
    MIRROR_LAUNCHES += mirror
    return y


def panel2_apply(plan: Panel2Plan, dev, x: torch.Tensor) -> torch.Tensor:
    """:func:`panel2_spmv` with autograd in ``x`` and the plan's values."""
    return StreamApply.apply(dev[0], x, plan, tuple(dev[1:]), panel2_spmv,
                             panel2_apply_plain)
