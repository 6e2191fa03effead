"""Arithmetic the per-layer readers share."""


def products_roofline(rec: dict, names) -> float | None:
    """100 x the logical bound of the products the traced window ran over
    the device time of the kernels they launched (their spans)."""
    spans = rec.get("trace", {}).get("span_device_s", {})
    calls = rec.get("calls", {})
    bound = sum(rec["bounds"][w][0] * calls[w] for w in names
                if calls.get(w) and w in rec.get("bounds", {}))
    spent = sum(spans.get(f"gpubench.{w}", 0.0) for w in names if calls.get(w))
    if bound <= 0 or spent <= 0:
        return None
    return 100.0 * bound / spent


def device_idle(rec: dict) -> float | None:
    t = rec.get("trace")
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
