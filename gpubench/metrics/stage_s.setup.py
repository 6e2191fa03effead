"""Seconds turning the blocks into host arrays and staging the buckets
on the device (spans ``bsp.host_values`` and ``bsp.stage``), over the
run's process: set-up."""

from gpubench.metrics import _program


def read(rec: dict):
    return _program.span_seconds(rec, "bsp.host_values", "bsp.stage")
