"""The formats' one door to the panel engine: plans and their product.

Counterpart of ``blocksparse_tpu/ops/panel_router.py`` with its default
implementation only: the v1 panel plans of ``core/panel.py`` run by kernel
B5.  The v2 plans (``BST_PANEL_IMPL=v2``, kernel B10) are not ported; they
would plug in here.
"""

from __future__ import annotations

from ..core.panel import panel_plan_from_layout, panel_plan_symmetric
from .kernels.panel_spmv import panel_apply

__all__ = ["panel_plan_general", "panel_plan_sym", "panel_run"]


def panel_plan_general(layout, *, transpose: bool):
    return panel_plan_from_layout(layout, transpose=transpose)


def panel_plan_sym(dlayout, olayout, *, transpose_diag: bool):
    return panel_plan_symmetric(dlayout, olayout,
                                transpose_diag=transpose_diag)


def panel_run(plan, dev, x):
    return panel_apply(plan, dev, x)
