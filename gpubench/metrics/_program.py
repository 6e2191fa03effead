"""What the per-layer readers read of the program itself, in the traced
run's own process: the port's span registry
(``blocksparse_tpu_torch.utils.profiling.summary``: set-up spans always
record, so the constructor and the lazy plans of set-up and warm-up are in
it) and its launch funnel's counts (``utils.build.launch_counts``).  A
program without them reads None."""

from __future__ import annotations


def _summary() -> dict:
    try:
        from blocksparse_tpu_torch.utils.profiling import summary
    except ImportError:
        return {}
    return summary()


def span_seconds(rec: dict, *names: str):
    """Total seconds of the spans ``names`` over the process, or None
    outside the products loop and where none of them was recorded."""
    if rec.get("loop") != "products":
        return None
    found = [s for name, s in _summary().items()
             if name in names and s["calls"]]
    if not found:
        return None
    return sum(s["total_s"] for s in found)


def padding(rec: dict):
    """The value entries of the tiles the process's launches iterated,
    padding included, over the stored entries of the blocks in them: every
    launch that counted both (``utils.build.launch``'s ``entries``)."""
    if rec.get("loop") != "products":
        return None
    try:
        from blocksparse_tpu_torch.utils.build import launch_counts
    except ImportError:
        return None
    counts = launch_counts().values()
    stored = sum(c["stored_entries"] for c in counts)
    if stored <= 0:
        return None
    return sum(c["tile_entries"] for c in counts) / stored
