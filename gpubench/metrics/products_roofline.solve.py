"""The operator's and the preconditioner's products in the solves: their
logical bound over their kernels' device time, in %."""

from gpubench.metrics import _common


def read(rec: dict):
    if rec.get("loop") != "solve":
        return None
    return _common.products_roofline(rec, ("S", "M"))
