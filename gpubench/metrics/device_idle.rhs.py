"""Share of the traced window in which no kernel, copy or fill ran on the
device, in %."""

from gpubench.metrics import _common


def read(rec: dict):
    if rec.get("loop") != "products":
        return None
    return _common.device_idle(rec)
