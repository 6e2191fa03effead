"""``S @ X``: its logical bound over its kernels' device time, in %."""

from gpubench.metrics import _common


def read(rec: dict):
    if rec.get("loop") != "products":
        return None
    return _common.products_roofline(rec, ("S",))
