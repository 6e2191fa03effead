"""Seconds building and staging the merged-patch plans (span
``bsp.plan.patch``), over the run's process: the first ``S @ X`` of the
warm-up builds it."""

from gpubench.metrics import _program


def read(rec: dict):
    return _program.span_seconds(rec, "bsp.plan.patch")
