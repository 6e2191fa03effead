"""The formats' one door to the panel engines: plans and their product.

Counterpart of ``blocksparse_tpu/ops/panel_router.py``.  ``impl`` stands for
the JAX package's ``BST_PANEL_IMPL``: "v1" (the default) builds the panel
plans of ``core/panel.py``, run by kernel B5; "v2" the SEG-parametric plans
of ``core/panel2.py``, run by kernel B10.  :func:`panel_arrays` and
:func:`panel_run` dispatch on the plan's type, as the JAX router does, so
a cached plan runs on its own kernel whatever option built it.

A symmetric operand's v1 plan is chosen by the port's own rule
(:func:`symmetric_choice`), measured on the H100 with kernel B5, not by
the JAX package's v5e cost model (``core/panel.py::panel_plan_symmetric``),
and the stream route charges the plan that same cost (:func:`route_bytes`).
"""

from __future__ import annotations

from ..core.panel import (PanelPlan, panel_plan_from_layout,
                          symmetric_candidates)
from ..core.panel2 import (Panel2Plan, panel2_plan_from_layout,
                           panel2_plan_symmetric)
from ..core.strip import CC, RC
from .kernels.panel2_spmv import panel2_apply, panel2_device_arrays
from .kernels.panel_spmv import panel_apply, panel_device_arrays

__all__ = ["panel_plan_general", "panel_plan_sym", "panel_arrays",
           "panel_run", "b5_cost", "route_bytes", "symmetric_choice",
           "MIRROR_FACTOR"]

# Kernel B5's time per byte of live tiles on a fused mirror plan over its
# time per byte on a plain plan.  chip_smoke.py phase 5 measures it on the
# symmetric real size's two candidate plans and prints it beside this
# value: 1.21-1.23 on an NVIDIA H100 80GB HBM3 at 700 W (0.093 ms for
# 214.4 MB fused against 0.124-0.125 ms for 350.6 MB expanded, CUDA-graph
# replay).  It was measured in the shared-memory mirror mode; plans whose
# CW sends B5 to the direct-atomic mode (``panel_spmv.panel_geometry``)
# are charged the same factor, unmeasured.
MIRROR_FACTOR = 1.2


def b5_cost(plan) -> float:
    """Bytes kernel B5 reads per product, as the H100 rule charges them:
    the live tiles (padding tiles are not copied), times
    :data:`MIRROR_FACTOR` on a mirror plan, and the id tables it stages
    (rid8 and cid8 of every tile, segid and, on a mirror plan, otgt)."""
    live = plan.nt * RC * CC * 4 * (MIRROR_FACTOR if plan.mirror else 1.0)
    tables = plan.rid8.nbytes + plan.cid8.nbytes + plan.segid.nbytes
    return live + tables + (0 if plan.otgt is None else plan.otgt.nbytes)


def symmetric_choice(fused, expanded):
    """The cheaper of a symmetric operand's fused and expanded v1 plans
    (:func:`core.panel.symmetric_candidates`) by :func:`b5_cost`; None
    where both are None.  Ties go to the expanded plan, as in the JAX
    rule."""
    cands = [p for p in (expanded, fused) if p is not None]
    return min(cands, key=b5_cost) if cands else None


def route_bytes(plan) -> float | None:
    """A symmetric operand's panel plan as the stream route charges it
    (``dispatch.stream_plan_choice``'s ``panel_bytes``): a v1 plan the
    :func:`b5_cost` that picked it, which counts ``otgt`` and not the JAX
    package's one-hot map-back; None (the JAX rule's bytes) for a v2 plan
    or no plan."""
    return b5_cost(plan) if isinstance(plan, PanelPlan) else None


def panel_plan_general(layout, *, transpose: bool, impl: str = "v1"):
    if impl == "v2":
        return panel2_plan_from_layout(layout, transpose=transpose)
    return panel_plan_from_layout(layout, transpose=transpose)


def panel_plan_sym(dlayout, olayout, *, transpose_diag: bool,
                   impl: str = "v1"):
    if impl == "v2":
        return panel2_plan_symmetric(dlayout, olayout,
                                     transpose_diag=transpose_diag)
    return symmetric_choice(*symmetric_candidates(
        dlayout, olayout, transpose_diag=transpose_diag))


def panel_arrays(plan, device) -> tuple:
    """The plan's device tensors on ``device``."""
    if isinstance(plan, Panel2Plan):
        return panel2_device_arrays(plan, device)
    return panel_device_arrays(plan, device)


def panel_run(plan, dev, x):
    """y = A @ x on the plan's kernel (B10 for a v2 plan, else B5)."""
    if isinstance(plan, Panel2Plan):
        return panel2_apply(plan, dev, x)
    return panel_apply(plan, dev, x)
