"""Execution-plan ("scheduler") choice carried by the operator.

Counterpart of ``blocksparse_tpu/core/schedule.py``:

  SERIAL   -- one color holding every block; the element engine scatters
              with ``index_add_`` and the CUDA kernels add with atomics.
  COLORED  -- conflict-free colors from DSATUR (``coloring/``); the element
              engine may run the scatter-free colored gather rounds
              (``ops/colored.py``), whose result depends on the coloring
              being right.  The CUDA kernels still add with atomics: using
              the colors as their launch schedule is later work (ROADMAP A8).

The JAX package's ``"auto"`` is not carried.
"""

from __future__ import annotations

__all__ = ["SERIAL", "COLORED", "isserial", "normalize_schedule"]

SERIAL = "serial"
COLORED = "colored"

_VALID = (SERIAL, COLORED)


def normalize_schedule(s: str) -> str:
    if s not in _VALID:
        raise ValueError(f"unknown schedule {s!r}; expected one of {_VALID}")
    return s


def isserial(s: str) -> bool:
    return s == SERIAL
