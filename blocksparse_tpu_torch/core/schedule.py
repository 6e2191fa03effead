"""Execution-plan ("scheduler") choice carried by the operator.

Counterpart of ``blocksparse_tpu/core/schedule.py``.  Only ``"serial"`` runs
in the port so far: every block is one color, and the CUDA kernels resolve
write conflicts with atomics.  ``"colored"`` (race-free colored launch
rounds) is queued on the ROADMAP's coloring item and raises here.
"""

from __future__ import annotations

__all__ = ["SERIAL", "COLORED", "isserial", "normalize_schedule"]

SERIAL = "serial"
COLORED = "colored"


def normalize_schedule(s: str) -> str:
    if s == COLORED:
        raise NotImplementedError(
            "schedule='colored' is not ported yet (ROADMAP: coloring); "
            "use schedule='serial'"
        )
    if s != SERIAL:
        raise ValueError(f"unknown schedule {s!r}; expected {SERIAL!r}")
    return s


def isserial(s: str) -> bool:
    return s == SERIAL
