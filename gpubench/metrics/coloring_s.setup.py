"""Seconds in the DSATUR colorings (span ``bsp.coloring``: each
``coloring.color_blocks``), over the run's process: set-up."""

from gpubench.metrics import _program


def read(rec: dict):
    return _program.span_seconds(rec, "bsp.coloring")
