"""Panel SpMV: CUDA kernels B5 and B6, their plain versions, their autograd.

The kernel (``csrc/panel_spmv.cu``) replaces
``blocksparse_tpu/ops/pallas/panel_spmv.py::_pkern_plain`` and
``::_pkern_mirror`` with the x gather and mirror map-back of its ``_launch``:
one launch streams a panel plan (``core/panel.py``) and returns y = A @ x;
a mirror plan also adds each stored off-diagonal's transposed product from
the same read of its values.

Kernel B6 (``bst_panel_spmv_batched_f32``, same source) replaces
``::_pkern_plain_b`` and ``::_pkern_mirror_b`` with the gather and map-back
of ``_launch_batched``: P operators that share one plan's id tables and
differ in their values (stacked [P, S*TS, 8, 128]) applied to x [P, ncols]
in one launch, the grid's second dimension picking the product.  The JAX
package's ``_gather_xs_batched`` and its ``_BATCHED_GATHER_ROWS`` switch
work around XLA's gather and have no counterpart.

Device tensors (:func:`panel_device_arrays`): the values, the per-tile row
and compact-chunk ids, the segment table and, for mirror plans, the
per-segment map-back target ``otgt`` (the JAX package's one-hot ``omap`` is
never built); :func:`panel_id_tables` stages the tables alone.  The shift
grids travel as one packed integer.

Design (``csrc/panel_ring.cuh``, shared with kernel B10): persistent
blocks over contiguous ranges of the tile stream, one producer warp
feeding a ring of shared-memory stages with 1-D bulk copies of the live
tiles and each stage's tables (read a stage ahead) in its ring slot, a
slab's mirrored sums kept in shared memory.  :func:`panel_geometry`
reports the launch a plan gets: ring stages, mirror mode (sums in shared
memory, or direct atomics where the plan's CW leaves too little room),
blocks per SM, blocks and tiles per block.

Race-freedom: every sum goes into a zeroed output with fp32 atomics (a
block's mirrored sums meet in shared memory first); the summation order
varies from run to run.  ``tiles_per_block`` moves sums between registers,
shared memory and atomics without changing the product.  B6 keeps the
``tile_stream.cuh`` core (``tiles_per_warp``, as B8): on the
real-size batches the ring was slower.

Routing: a CPU tensor takes the plain version (:func:`panel_apply_plain`,
:func:`panel_apply_batched_plain`); a CUDA tensor launches the kernel or
raises.  ``LAUNCHES`` counts B5's launches, ``MIRROR_LAUNCHES`` those of them
on a mirror plan; ``BATCHED_LAUNCHES`` and ``BATCHED_MIRROR_LAUNCHES`` count
B6's the same way.

Gradient: :func:`panel_apply` and :func:`panel_apply_batched` wrap the
product in an autograd Function whose backward runs the plain version's
autograd on the same tables (the JAX VJPs likewise differentiate their XLA
forward), giving dx and, where the values require it, dvals.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...core.panel import NSEG, SEG, PanelPlan
from ...core.strip import CC, RC
from ...utils import build

__all__ = ["panel_device_arrays", "panel_id_tables", "panel_geometry",
           "PANEL_MODES", "panel_spmv",
           "panel_apply_plain", "panel_apply", "panel_spmv_batched",
           "panel_apply_batched_plain", "panel_apply_batched", "LAUNCHES",
           "MIRROR_LAUNCHES", "BATCHED_LAUNCHES", "BATCHED_MIRROR_LAUNCHES"]

LAUNCHES = 0                  # kernel B5
MIRROR_LAUNCHES = 0
BATCHED_LAUNCHES = 0          # kernel B6
BATCHED_MIRROR_LAUNCHES = 0


def panel_id_tables(plan: PanelPlan, device) -> tuple:
    """(rid8 [S*TS], cid8 [S*TS], segid [S*CW*4], otgt [S*CW*4] or None,
    b8 [S]) int32 on ``device``."""
    def flat(a):
        return None if a is None else torch.from_numpy(
            np.ascontiguousarray(a).reshape(-1)).to(device)
    return (flat(plan.rid8), flat(plan.cid8), flat(plan.segid),
            flat(plan.otgt), flat(plan.b8))


def panel_device_arrays(plan: PanelPlan, device) -> tuple:
    """(vals [S*TS, 8, 128] f32,) + :func:`panel_id_tables` on ``device``."""
    vals = torch.from_numpy(np.ascontiguousarray(plan.vals)).to(device)
    return (vals,) + panel_id_tables(plan, device)


def _lane_index(plan: PanelPlan, seg: torch.Tensor, limit: int):
    """x / y index of every lane for a segment table ``seg`` [S, CW*4]
    (entries >= NG*NC32 or < 0 are dropped); ``limit`` for dropped lanes
    and indices >= ``limit``."""
    ng, nc32 = len(plan.grids_used), plan.NC32
    seg = seg.view(plan.S, plan.CW * NSEG).long()
    live = (seg >= 0) & (seg < ng * nc32)
    seg = torch.where(live, seg, 0)
    base = (seg % nc32) * SEG
    for gi, g in enumerate(plan.grids_used):    # device ops only: capturable
        if g:
            base = base + (seg // nc32 == gi) * g
    lane = torch.arange(SEG, device=seg.device)
    idx = (base[..., None] + lane).view(plan.S, plan.CW, CC)
    live = live[..., None].expand(-1, -1, SEG).reshape(plan.S, plan.CW, CC)
    return torch.where(live & (idx < limit), idx, limit)


def _rows(plan, rid8, b8):
    """Output row of every tile row [S, TS, 8]; padding tiles and rows past
    nrows at ``nrows``."""
    rid = rid8.view(plan.S, plan.TS).long()
    rows = ((b8.long()[:, None] + rid) * RC)[..., None] + torch.arange(
        RC, device=rid.device)
    ok = (rid < plan.RW)[..., None] & (rows < plan.nrows)
    return torch.where(ok, rows, plan.nrows)


def panel_apply_plain(plan: PanelPlan, dev, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same tables, y = A @ x in
    ``x``'s dtype."""
    vals, rid8, cid8, segid, otgt, b8 = dev
    S, TS, CW = plan.S, plan.TS, plan.CW
    V = vals.to(x.dtype).view(S, TS, RC, CC)
    xe = torch.cat([x, x.new_zeros(1)])
    xs = xe[_lane_index(plan, segid, plan.ncols)]              # [S, CW, 128]
    xs = torch.cat([xs, xs.new_zeros(S, 1, CC)], dim=1)        # CW = padding
    cid = cid8.view(S, TS).long()[..., None].expand(-1, -1, CC)
    yf = torch.einsum("stmk,stk->stm", V, torch.gather(xs, 1, cid))
    rows = _rows(plan, rid8, b8)
    y = x.new_zeros(plan.nrows + 1).index_add(0, rows.reshape(-1),
                                              yf.reshape(-1))
    if plan.mirror:
        yt = torch.einsum("stmk,stm->stk", V, xe[rows])
        ym = x.new_zeros(S, CW + 1, CC).scatter_add(1, cid, yt)[:, :CW]
        y = y.index_add(0, _lane_index(plan, otgt, plan.nrows).reshape(-1),
                        ym.reshape(-1))
    return y[:plan.nrows]


def _check(plan: PanelPlan, dev, x: torch.Tensor) -> None:
    if x.ndim != 1 or x.shape[0] != plan.ncols:
        raise ValueError(
            f"panel plan takes x of shape ({plan.ncols},), got {tuple(x.shape)}")
    _check_tables(plan, dev, x)


def _check_tables(plan: PanelPlan, dev, x: torch.Tensor) -> None:
    if plan.mirror and dev[4] is None:
        raise ValueError("mirror plan staged without its otgt table")
    devs = {t.device for t in dev if t is not None} | {x.device}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devs))}")


def _kernel_args(plan: PanelPlan, dev, x: torch.Tensor) -> int:
    """Check what the kernels take; returns the packed shift grids."""
    vals, rid8, cid8, segid, otgt, b8 = dev
    if x.dtype != torch.float32 or vals.dtype != torch.float32:
        raise TypeError(f"panel kernel takes float32, got {x.dtype}/{vals.dtype}")
    for name, t in (("rid8", rid8), ("cid8", cid8), ("segid", segid),
                    ("otgt", otgt), ("b8", b8)):
        if t is not None and (t.dtype != torch.int32 or not t.is_contiguous()):
            raise TypeError(f"{name} must be contiguous int32")
    if len(plan.grids_used) > 8 or any(not 0 <= g < 32 for g in plan.grids_used):
        raise ValueError(f"grid shifts {plan.grids_used} do not pack")
    return sum(g << (5 * i) for i, g in enumerate(plan.grids_used))


def _default_tpw(ntiles: int) -> int:
    """Tiles per warp of the ``tile_stream.cuh`` kernels (B6, B8):
    about four thousand warps in flight, 1-16 tiles each."""
    return max(1, min(16, ntiles // 4096))


PANEL_MODES = ("plain", "mirror", "mirror direct")


def panel_geometry(plan: PanelPlan) -> dict:
    """The launch B5 takes for ``plan`` on the current card, as the
    kernel's C entry decides it: ring ``stages``, ``mode`` (one of
    :data:`PANEL_MODES`), dynamic shared-memory bytes, ``blocks``,
    ``tiles_per_block`` and ``per_sm`` (blocks resident on one
    multiprocessor).  Builds the kernels' library."""
    out = (ctypes.c_longlong * 6)()
    build.check(build.load_library().bst_panel_spmv_geometry(
        plan.S * plan.TS, plan.CW, int(plan.mirror), out),
        "bst_panel_spmv_geometry")
    return {"stages": out[0], "mode": PANEL_MODES[out[1]], "smem": out[2],
            "blocks": out[3], "tiles_per_block": out[4], "per_sm": out[5]}


def panel_spmv(plan: PanelPlan, dev, x: torch.Tensor, *,
               tiles_per_block: int | None = None) -> torch.Tensor:
    """y = A @ x for a panel plan: kernel B5 on a CUDA tensor, the plain
    version on a CPU tensor.  ``tiles_per_block``: the range of the tile
    stream each block takes (default: the kernel's geometry)."""
    global LAUNCHES, MIRROR_LAUNCHES
    _check(plan, dev, x)
    if x.device.type == "cpu":
        return panel_apply_plain(plan, dev, x)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    grids = _kernel_args(plan, dev, x)
    vals, rid8, cid8, segid, otgt, b8 = dev
    ntiles = plan.S * plan.TS
    x = x.contiguous()
    y = torch.zeros(plan.nrows, dtype=torch.float32, device=x.device)
    mirror = plan.mirror
    build.launch("bst_panel_spmv_f32", x.device, vals.data_ptr(),
                 rid8.data_ptr(), cid8.data_ptr(), segid.data_ptr(),
                 otgt.data_ptr() if mirror else None, b8.data_ptr(),
                 x.data_ptr(), y.data_ptr(), ntiles, plan.TS, plan.CW,
                 plan.RW, plan.NC32, len(plan.grids_used), grids, plan.ncols,
                 plan.nrows, int(mirror), tiles_per_block or 0)
    LAUNCHES += 1
    MIRROR_LAUNCHES += mirror
    return y


class StreamApply(torch.autograd.Function):
    """Forward: a stream kernel's wrapper ``spmv(plan, dev, x)``.
    Backward: its plain version ``plain(plan, dev, x)``'s autograd on the
    same tables (dx = A^T g, and dvals where asked).  Serves B5 here and
    B10 (``panel2_spmv.py``)."""

    @staticmethod
    def forward(ctx, vals, x, plan, rest, spmv, plain):
        ctx.save_for_backward(vals, x)
        ctx.plan, ctx.rest, ctx.plain = plan, rest, plain
        return spmv(plan, (vals,) + rest, x)

    @staticmethod
    def backward(ctx, g):
        vals, x = ctx.saved_tensors
        need = ctx.needs_input_grad[:2]
        with torch.enable_grad():
            v = vals.detach().requires_grad_(need[0])
            xx = x.detach().requires_grad_(need[1])
            y = ctx.plain(ctx.plan, (v,) + ctx.rest, xx)
            wrt = [t for t, n in zip((v, xx), need) if n]
            got = iter(torch.autograd.grad(y, wrt, g))
        return (next(got) if need[0] else None,
                next(got) if need[1] else None, None, None, None, None)


def panel_apply(plan: PanelPlan, dev, x: torch.Tensor) -> torch.Tensor:
    """:func:`panel_spmv` with autograd in ``x`` and the plan's values."""
    return StreamApply.apply(dev[0], x, plan, tuple(dev[1:]), panel_spmv,
                             panel_apply_plain)


# -- kernel B6: P operators over one plan's tables ----------------------------

def panel_apply_batched_plain(plan: PanelPlan, tables, vals_b: torch.Tensor,
                              xb: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel B6: :func:`panel_apply_plain` of each
    product's values and x over the shared ``tables``
    (:func:`panel_id_tables`), stacked [P, nrows]."""
    return torch.stack([panel_apply_plain(plan, (vals_b[p],) + tuple(tables),
                                          xb[p])
                        for p in range(xb.shape[0])])


def panel_spmv_batched(plan: PanelPlan, tables, vals_b: torch.Tensor,
                       xb: torch.Tensor, *,
                       tiles_per_warp: int | None = None) -> torch.Tensor:
    """y [P, nrows], y[p] = A_p @ xb[p] for the P operators whose values
    ``vals_b`` [P, S*TS, 8, 128] share the plan's ``tables``: kernel B6 on
    CUDA tensors, the plain version on CPU tensors."""
    global BATCHED_LAUNCHES, BATCHED_MIRROR_LAUNCHES
    tables = tuple(tables)
    P = xb.shape[0]
    if xb.ndim != 2 or xb.shape[1] != plan.ncols:
        raise ValueError(f"panel plan takes xb of shape (P, {plan.ncols}), "
                         f"got {tuple(xb.shape)}")
    if tuple(vals_b.shape) != (P,) + tuple(plan.vals.shape):
        raise ValueError(f"vals_b {tuple(vals_b.shape)} does not stack "
                         f"{P} planes of {tuple(plan.vals.shape)}")
    dev = (vals_b,) + tables
    _check_tables(plan, dev, xb)
    if xb.device.type == "cpu":
        return panel_apply_batched_plain(plan, tables, vals_b, xb)
    if xb.device.type != "cuda":
        raise ValueError(f"no kernel for device {xb.device}")
    grids = _kernel_args(plan, dev, xb)
    rid8, cid8, segid, otgt, b8 = tables
    ntiles = plan.S * plan.TS
    tpw = tiles_per_warp or _default_tpw(P * ntiles)
    xb, vals_b = xb.contiguous(), vals_b.contiguous()
    y = torch.zeros((P, plan.nrows), dtype=torch.float32, device=xb.device)
    mirror = plan.mirror
    if P:
        build.launch("bst_panel_spmv_batched_f32", xb.device,
                     vals_b.data_ptr(), rid8.data_ptr(), cid8.data_ptr(),
                     segid.data_ptr(), otgt.data_ptr() if mirror else None,
                     b8.data_ptr(), xb.data_ptr(), y.data_ptr(), P, ntiles,
                     plan.TS, plan.CW, plan.RW, plan.NC32,
                     len(plan.grids_used), grids, plan.ncols, plan.nrows,
                     int(mirror), tpw)
        BATCHED_LAUNCHES += 1
        BATCHED_MIRROR_LAUNCHES += mirror
    return y


class _PanelApplyBatched(torch.autograd.Function):
    """Forward: :func:`panel_spmv_batched`.  Backward: the plain version's
    autograd on the same tables (dx = A_p^T g[p], and dvals where asked)."""

    @staticmethod
    def forward(ctx, vals_b, xb, plan, tables):
        ctx.save_for_backward(vals_b, xb)
        ctx.plan, ctx.tables = plan, tables
        return panel_spmv_batched(plan, tables, vals_b, xb)

    @staticmethod
    def backward(ctx, g):
        vals_b, xb = ctx.saved_tensors
        need = ctx.needs_input_grad[:2]
        with torch.enable_grad():
            v = vals_b.detach().requires_grad_(need[0])
            xx = xb.detach().requires_grad_(need[1])
            y = panel_apply_batched_plain(ctx.plan, ctx.tables, v, xx)
            wrt = [t for t, n in zip((v, xx), need) if n]
            got = iter(torch.autograd.grad(y, wrt, g))
        return (next(got) if need[0] else None,
                next(got) if need[1] else None, None, None)


def panel_apply_batched(plan: PanelPlan, tables, vals_b: torch.Tensor,
                        xb: torch.Tensor) -> torch.Tensor:
    """:func:`panel_spmv_batched` with autograd in ``xb`` and the stacked
    values."""
    return _PanelApplyBatched.apply(vals_b, xb, plan, tuple(tables))
