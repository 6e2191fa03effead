"""Execution-plan ("scheduler") choice carried by the operator.

Counterpart of ``blocksparse_tpu/core/schedule.py``:

  SERIAL   -- one color holding every block; the element engine scatters
              with ``index_add_`` and the CUDA kernels add with atomics.
  COLORED  -- conflict-free colors from DSATUR (``coloring/``); the element
              engine may run the scatter-free colored gather rounds
              (``ops/colored.py``), whose result depends on the coloring
              being right.  The CUDA kernels still add with atomics: using
              the colors as their launch schedule is later work (ROADMAP A8).
  AUTO     -- as in the JAX package, not serial: an "auto" operator builds
              its colors and takes the colored path exactly as a "colored"
              one does (``isserial("auto")`` is False), so its products
              equal the colored operator's.
"""

from __future__ import annotations

__all__ = ["SERIAL", "COLORED", "AUTO", "isserial", "normalize_schedule"]

SERIAL = "serial"
COLORED = "colored"
AUTO = "auto"

_VALID = (SERIAL, COLORED, AUTO)


def normalize_schedule(s: str) -> str:
    if s not in _VALID:
        raise ValueError(f"unknown schedule {s!r}; expected one of {_VALID}")
    return s


def isserial(s: str) -> bool:
    return s == SERIAL
