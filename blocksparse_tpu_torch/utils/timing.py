"""Per-iteration time of a chained step, two chain lengths differenced.

Counterpart of ``blocksparse_tpu/utils/timing.py``, with its signature and
``reduce`` modes.  ``step_fn`` runs K times in a chain (each output the
next input), the chain is timed, and two chain lengths are differenced to
cancel the fixed cost of starting and ending a chain:

    t_per_iter = (T(iters_hi) - T(iters_lo)) / (iters_hi - iters_lo)

On a CUDA operand the chain is timed with CUDA events (device time, the
host's enqueue hidden where the device is the slower side); on a CPU
operand with ``time.perf_counter``.  If the difference window is too short
to resolve, the chain lengths grow (up to 20000 iterations).
"""

from __future__ import annotations

import time

import torch

__all__ = ["chained_time_per_iter"]

TARGET_WINDOW = 0.02  # seconds the differenced window should reach
MAX_ITERS = 20000


def _first_tensor(tree):
    """The first tensor of a tensor, a tuple / list or a dict of them."""
    if isinstance(tree, torch.Tensor):
        return tree
    items = tree.values() if isinstance(tree, dict) else tree
    for item in items:
        found = _first_tensor(item)
        if found is not None:
            return found
    return None


def _chain_seconds(step_fn, x0, iters: int) -> float:
    leaf = _first_tensor(x0)
    cuda = leaf is not None and leaf.device.type == "cuda"
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    else:
        t0 = time.perf_counter()
    x = x0
    for _ in range(iters):
        x = step_fn(x)
    if cuda:
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e-3
    return time.perf_counter() - t0


def chained_time_per_iter(
    step_fn,
    x0,
    *,
    iters_lo: int = 8,
    iters_hi: int = 40,
    repeats: int = 3,
    reduce: str = "median",
):
    """Per-iteration time of ``x -> step_fn(x)`` in seconds.

    ``step_fn`` maps a tensor (or a tuple, list or dict of them) to one of
    the same structure so iterations chain.

    ``reduce``: "median" for a typical estimate, "min" for the least
    disturbed window (roofline comparisons), "stats" for a dict {min,
    median, max, n} over the repeats, so a record keeps the spread and not
    a single point.
    """
    if reduce not in ("median", "min", "stats"):
        raise ValueError(f"unknown reduce={reduce!r}; expected 'median', "
                         "'min' or 'stats'")
    if not 0 < iters_lo < iters_hi:
        raise ValueError(f"need 0 < iters_lo < iters_hi, got {iters_lo}, "
                         f"{iters_hi}")

    def measure(lo, hi, reps):
        _chain_seconds(step_fn, x0, lo)  # warm both lengths
        _chain_seconds(step_fn, x0, hi)
        return [(_chain_seconds(step_fn, x0, hi)
                 - _chain_seconds(step_fn, x0, lo)) / (hi - lo)
                for _ in range(reps)]

    estimates = measure(iters_lo, iters_hi, repeats)
    for _ in range(4):
        mid = sorted(estimates)[len(estimates) // 2]
        span = max(mid, 0.0) * (iters_hi - iters_lo)
        if span >= TARGET_WINDOW / 4 or iters_hi >= MAX_ITERS:
            break
        scale = int(min(max(2, TARGET_WINDOW / max(span, 1e-6)),
                        MAX_ITERS / iters_hi))
        if scale < 2:
            break
        iters_lo *= scale
        iters_hi *= scale
        estimates = measure(iters_lo, iters_hi, repeats)

    estimates.sort()
    valid = [e for e in estimates if e > 0] or [max(estimates[-1], 1e-12)]
    if reduce == "stats":
        return {"min": valid[0], "median": valid[len(valid) // 2],
                "max": valid[-1], "n": len(valid)}
    if reduce == "min":
        return valid[0]
    return max(estimates[len(estimates) // 2], 1e-12)
