"""Batched multi-operand products: P same-structure products in one launch.

Counterpart of ``blocksparse_tpu/ops/batched.py``, for workloads with many
right-hand-side *operators* (frequency sweeps over one BEM near-field
structure: P operators with equal sparsity and different values, each
applied to its own operand).

  - :func:`batched_mm`: ``[ops[p] @ Xs[p] for p]`` through kernel B4
    (``ops/kernels/batched_spmm.py``) over the operators' shared merged-patch
    plan tables and their stacked values;
  - :func:`batched_mv`: ``[ops[p] @ xs[p] for p]`` through kernel B6
    (``ops/kernels/panel_spmv.py``) over their shared panel-plan tables
    (v1 plans; operators built with ``panel="v2"`` loop).

A batch takes its kernel when P >= 2, every operator and the operand are
float32, the operators are of one type and lie with the operand on one
device, and the structure checks pass (``_stacked_entry``,
``_stacked_panel_entry``, the JAX package's rules).  On a CUDA device that
is one kernel launch; on the CPU the kernels' plain versions run, the
counterpart of the JAX package's ``pallas-interpret`` route.  Any other
batch loops over ``op @ X[p]`` with the same result.  The route is chosen
from the structure before anything is launched; a kernel that fails raises.

The stacked values are cached per batch of operators (strong references, so
ids are not reused while cached; eight batches, least recently used first
out).  A batch copies its P value streams onto the device once; where an
operator's stream route has already staged its panel plan, that plan's
device tensors are reused.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from ..core.operator import as_tensor
from ..core.panel import PanelPlan
from .kernels.batched_spmm import batched_spmm_apply
from .kernels.panel_spmv import panel_apply_batched, panel_id_tables

__all__ = ["batched_mm", "batched_mv"]

_STACK_CACHE: "OrderedDict" = OrderedDict()
_STACK_CACHE_MAX = 8

# Per-product value-stream cap of the batched panel route, the JAX
# package's constant verbatim: measured on a TPU v5e, where the batched
# kernel lost ~2.7x against the loop at 57.8 MB/product.  It awaits
# measurement on the H100 (ROADMAP D18); chip_smoke.py phase 9 times B6
# against the loop above it.
_BATCHED_PANEL_TILE_CAP = 24 << 20


def _cache_get(key):
    hit = _STACK_CACHE.get(key)
    if hit is None:
        return None
    _STACK_CACHE.move_to_end(key)
    return hit


def _cache_put(key, ops, result):
    _STACK_CACHE[key] = (tuple(ops), result)
    while len(_STACK_CACHE) > _STACK_CACHE_MAX:
        _STACK_CACHE.popitem(last=False)


def _same_structure(plans) -> bool:
    """Equal patch tables.  The JAX package also compares ``row_chunk``,
    which is a function of ``row_start``; the port's plan does not carry
    it."""
    b0 = plans[0].buckets[0]
    for p in plans[1:]:
        b = p.buckets[0]
        if (b.MP, b.KP, b.G, b.nb) != (b0.MP, b0.KP, b0.G, b0.nb):
            return False
        if not (np.array_equal(b.col_chunk, b0.col_chunk)
                and np.array_equal(b.row_start, b0.row_start)
                and np.array_equal(b.mirror_kc, b0.mirror_kc)):
            return False
    return True


def _stacked_entry(ops):
    """(plan, vals [P, nb, MP, KP], cc, rs) for kernel B4, or None where the
    batch loops: a symmetric operand, no patch plan, a plan of more than
    one bucket, or unequal tables."""
    key = tuple(id(op) for op in ops)
    hit = _cache_get(key)
    if hit is not None:
        return hit[1]
    entries = [None if hasattr(op, "_dlayout")
               or not hasattr(op, "_patch_for") else op._patch_for()
               for op in ops]
    if any(e is None for e in entries):
        result = None
    else:
        plans = [e[0] for e in entries]
        if (any(p.symmetric for p in plans) or len(plans[0].buckets) != 1
                or not _same_structure(plans)):
            result = None
        else:
            vals_stack = torch.stack([e[1][0][0] for e in entries])
            _, cc, rs, _ = entries[0][1][0]
            result = (plans[0], vals_stack, cc, rs)
    _cache_put(key, ops, result)
    return result


def _same_panel_structure(plans) -> bool:
    """Equal panel geometry and id tables.  Beyond the JAX package's
    checks this compares the mirror target table ``otgt`` (the JAX package
    shares the first plan's one-hot ``omap`` without comparing it)."""
    p0 = plans[0]
    for p in plans[1:]:
        if (p.S, p.TS, p.CW, p.RW, p.n8p, p.NC32, p.mirror,
                tuple(p.grids_used)) != (
                p0.S, p0.TS, p0.CW, p0.RW, p0.n8p, p0.NC32, p0.mirror,
                tuple(p0.grids_used)):
            return False
        if not (np.array_equal(p.segid, p0.segid)
                and np.array_equal(p.rid8, p0.rid8)
                and np.array_equal(p.cid8, p0.cid8)
                and np.array_equal(p.b8, p0.b8)
                and (p.otgt is None) == (p0.otgt is None)
                and (p.otgt is None or np.array_equal(p.otgt, p0.otgt))):
            return False
    return True


def _panel_stack(ops, plans):
    """(plan, tables, vals [P, S*TS, 8, 128]) of same-structure panel plans
    on the operators' device: the first plan's id tables and every plan's
    values, each reused from the operator's staged panel plan where the
    stream route staged one."""
    device = ops[0].device
    staged = [op._staged_panel(False) for op in ops]
    tables = (staged[0][1:] if staged[0] is not None
              else panel_id_tables(plans[0], device))
    vals_b = torch.empty((len(ops),) + plans[0].vals.shape,
                         dtype=torch.float32, device=device)
    for p, (plan, dev) in enumerate(zip(plans, staged)):
        vals_b[p].copy_(dev[0] if dev is not None
                        else torch.from_numpy(plan.vals))
    return plans[0], tables, vals_b


def _stacked_panel_entry(ops):
    """:func:`_panel_stack` of the operators' panel plans for A (each
    operator's, whatever its own route decision), or None where the batch
    loops: no panel plan, a v2 plan (``panel="v2"``: kernel B6 streams v1
    plans only), a plan above the cap, or unequal structure.

    The JAX package reaches its batched kernel with v2 plans and fails
    there (``Panel2Plan`` has no ``NC32``); here the plan type decides
    before anything is launched."""
    key = ("mv",) + tuple(id(op) for op in ops)
    hit = _cache_get(key)
    if hit is not None:
        return hit[1]
    plans = [op._panel_for(False) if hasattr(op, "_panel_for") else None
             for op in ops]
    if any(p is None or not isinstance(p, PanelPlan) for p in plans):
        result = None
    elif (plans[0].tile_bytes > _BATCHED_PANEL_TILE_CAP
          or not _same_panel_structure(plans)):
        result = None
    else:
        result = _panel_stack(ops, plans)
    _cache_put(key, ops, result)
    return result


def _eligible(ops, X: torch.Tensor) -> bool:
    """The checks made before the structure: P >= 2, f32 operators and
    operand of one operator type, all on the operand's device."""
    return (len(ops) >= 2
            and X.dtype == torch.float32
            and all(type(op) is type(ops[0]) for op in ops)
            and all(op.dtype == torch.float32 for op in ops)
            and all(getattr(op, "device", None) == X.device for op in ops))


def _stacked_operand(X, ndim: int, what: str, P: int) -> torch.Tensor:
    if isinstance(X, (list, tuple)):
        X = torch.stack([as_tensor(x) for x in X])
    X = as_tensor(X)
    if X.shape[0] != P:
        raise ValueError(
            f"{what}: {P} operators but {'Xs' if ndim == 3 else 'xs'} has "
            f"leading dim {X.shape[0]}")
    if X.ndim != ndim:
        raise ValueError(f"{what} expects "
                         + ("Xs of shape [P, n, r]" if ndim == 3
                            else "xs of shape [P, n]"))
    return X


def batched_mv(ops, xs):
    """``[ops[p] @ xs[p] for p]`` in one launch of kernel B6 where possible.

    ``ops``: same-structure f32 operators (equal panel index structure;
    values may differ).  ``xs``: [P, n] tensor or a list of [n].  Returns
    [P, m].  Loops over the operators when the batch is ineligible.
    Differentiable in ``xs``.
    """
    ops = list(ops)
    P = len(ops)
    xs = _stacked_operand(xs, 2, "batched_mv", P)
    entry = _stacked_panel_entry(ops) if _eligible(ops, xs) else None
    if entry is None:
        return torch.stack([op @ xs[p] for p, op in enumerate(ops)])
    plan, tables, vals_b = entry
    return panel_apply_batched(plan, tables, vals_b, xs)


def batched_mm(ops, Xs, *, precision=None):
    """``[ops[p] @ Xs[p] for p]`` in one launch of kernel B4 where possible.

    ``ops``: same-structure f32 operators (equal index tables; values may
    differ).  ``Xs``: [P, n, r] tensor or a list of [n, r].  Returns
    [P, m, r].  Loops over the operators when the batch is ineligible
    (different structures, symmetric operands, non-f32).  Differentiable in
    ``Xs``: the dX of the batch is one launch of B2's transposed product
    with its product axis (and one of its prologue).  ``precision``: the
    tier of both ("highest" / "high": 3xTF32, None: one TF32 pass on the
    card); None takes ``ops[0].precision``, as the JAX package does.  The
    loop runs each operator's own route.
    """
    ops = list(ops)
    P = len(ops)
    Xs = _stacked_operand(Xs, 3, "batched_mm", P)
    entry = _stacked_entry(ops) if _eligible(ops, Xs) else None
    if entry is None:
        return torch.stack([op @ Xs[p] for p, op in enumerate(ops)])
    plan, vals_stack, cc, rs = entry
    if Xs.shape[1] != plan.ncols:   # B4 would read zeros past X's end
        raise ValueError(f"batched_mm: operators take {plan.ncols} rows, "
                         f"Xs has {Xs.shape[1]}")
    if precision is None:
        precision = getattr(ops[0], "precision", "highest")
    return batched_spmm_apply(vals_stack, cc, rs, Xs, plan.nrows,
                              precision=precision)
