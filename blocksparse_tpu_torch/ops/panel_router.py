"""The formats' one door to the panel engines: plans and their product.

Counterpart of ``blocksparse_tpu/ops/panel_router.py``.  ``impl`` stands for
the JAX package's ``BST_PANEL_IMPL``: "v1" (the default) builds the panel
plans of ``core/panel.py``, run by kernel B5; "v2" the SEG-parametric plans
of ``core/panel2.py``, run by kernel B10.  :func:`panel_arrays` and
:func:`panel_run` dispatch on the plan's type, as the JAX router does, so
a cached plan runs on its own kernel whatever option built it.
"""

from __future__ import annotations

from ..core.panel import panel_plan_from_layout, panel_plan_symmetric
from ..core.panel2 import (Panel2Plan, panel2_plan_from_layout,
                           panel2_plan_symmetric)
from .kernels.panel2_spmv import panel2_apply, panel2_device_arrays
from .kernels.panel_spmv import panel_apply, panel_device_arrays

__all__ = ["panel_plan_general", "panel_plan_sym", "panel_arrays",
           "panel_run"]


def panel_plan_general(layout, *, transpose: bool, impl: str = "v1"):
    if impl == "v2":
        return panel2_plan_from_layout(layout, transpose=transpose)
    return panel_plan_from_layout(layout, transpose=transpose)


def panel_plan_sym(dlayout, olayout, *, transpose_diag: bool,
                   impl: str = "v1"):
    if impl == "v2":
        return panel2_plan_symmetric(dlayout, olayout,
                                     transpose_diag=transpose_diag)
    return panel_plan_symmetric(dlayout, olayout,
                                transpose_diag=transpose_diag)


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
