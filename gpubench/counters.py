"""The program's counters: kernel launches per kernel wrapper and the
solvers' host reads.

Each wrapper of the port counts its launches in module-level integers.
Those below count every launch once; the others (``SYM_LAUNCHES``,
``MMA_LAUNCHES``, ``ROW_LAUNCHES`` of B1, ``ELEMENT_SYM_LAUNCHES`` /
``ELEMENT_ROW_LAUNCHES`` of B9's element pass, the ``MIRROR`` counts) are
shares of one of these.  A counter this list does not name is not read.
"""

from __future__ import annotations

import importlib

PORT = "blocksparse_tpu_torch"
LAUNCH_COUNTERS = {
    "ops.kernels.fused_spmm": ("LAUNCHES",),
    "ops.kernels.mask_select": ("GATHER_LAUNCHES", "SCATTER_LAUNCHES",
                                "ELEMENT_LAUNCHES", "OWNER_LAUNCHES",
                                "COLORED_LAUNCHES", "ROUNDS_LAUNCHES"),
    "ops.patch_engine": ("LAUNCHES", "TR_LAUNCHES", "XT_LAUNCHES",
                         "SYM_LAUNCHES"),
    "ops.kernels.panel_spmv": ("LAUNCHES", "BATCHED_LAUNCHES"),
    "ops.kernels.panel2_spmv": ("LAUNCHES",),
    "ops.kernels.slab_spmv": ("LAUNCHES",),
    "ops.kernels.patch_spmv1": ("LAUNCHES",),
    "ops.kernels.batched_spmm": ("LAUNCHES",),
}


def snapshot() -> dict:
    """Every launch counter by ``module.NAME``, and ``host_checks``."""
    out = {}
    for mod, names in LAUNCH_COUNTERS.items():
        m = importlib.import_module(f"{PORT}.{mod}")
        for name in names:
            out[f"{mod}.{name}"] = int(getattr(m, name))
    out["host_checks"] = int(importlib.import_module(f"{PORT}.solvers").HOST_CHECKS)
    return out


def launches(before: dict, after: dict) -> dict:
    """The launches between two snapshots, by counter (those that moved)."""
    return {k: after[k] - before[k] for k in after
            if k != "host_checks" and after[k] != before[k]}
