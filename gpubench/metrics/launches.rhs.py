"""Kernel launches of the port's wrappers (their counters) per ``S @ X``."""


def read(rec: dict):
    if rec.get("loop") != "products" or not rec.get("units"):
        return None
    return sum(rec["launches"].values()) / rec["units"]
