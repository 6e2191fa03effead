"""Execution-plan ("scheduler") choice carried by the operator.

Counterpart of ``blocksparse_tpu/core/schedule.py``:

  SERIAL   -- one color holding every block; the element engine scatters
              with ``index_add_`` and the CUDA kernels add with atomics.
  COLORED  -- conflict-free colors from DSATUR (``coloring/``); the element
              buckets may run the colored element route (``ops/colored.py``:
              a products pass, then B9's colored rounds summing every color
              in one launch, without atomics), whose result depends on the
              coloring being right.  The chunked buckets (B1) still add
              with atomics.
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
