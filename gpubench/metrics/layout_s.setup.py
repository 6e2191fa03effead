"""Seconds in the host layouts (span ``bsp.layout``: each
``core/layout.build_layout``), over the run's process: set-up."""

from gpubench.metrics import _program


def read(rec: dict):
    return _program.span_seconds(rec, "bsp.layout")
