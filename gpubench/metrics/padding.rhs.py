"""Tile entries over stored entries of the kernel launches over tables
and plans (B1, B9, B2 / B3 / B7), over the run's process: the padding
the launches are given, 1 where they iterate stored entries alone."""

from gpubench.metrics import _program


def read(rec: dict):
    return _program.padding(rec)
