"""Seconds in the port's constructors (span ``bsp.construct``, every
format), over the run's process: set-up."""

from gpubench.metrics import _program


def read(rec: dict):
    return _program.span_seconds(rec, "bsp.construct")
