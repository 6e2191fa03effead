"""The traced run: spans from the benchmark's own files, and the reduction
of a ``torch.profiler`` trace to what the per-layer readers take.

Spans are ``torch.profiler.record_function`` ranges named ``gpubench.*``
around the calls into each layer.  A span's device time is the device time
of every kernel launched inside it (the profiler ties each kernel to the
call that launched it).  The device is busy where any kernel, copy or fill
runs; the window is the ``gpubench.window`` span.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

import torch

WINDOW = "gpubench.window"


def span(name: str):
    return torch.profiler.record_function(name)


def profiler():
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=act, record_shapes=False,
                                  with_stack=False)


def _is_device(e) -> bool:
    return (e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith("gpubench."))


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(prof, top: int = 10) -> dict:
    """``busy_s``, ``window_s``, ``span_device_s`` (device seconds per span
    name), ``span_calls``, ``kernels`` (device operations in the window) and
    ``breakdown`` (the ``top`` device operations by time, and the idle gaps
    summed by the innermost host call running at their middle)."""
    events = list(prof.events())
    wins = [e for e in events if e.name == WINDOW
            and e.device_type == torch.autograd.DeviceType.CPU]
    if not wins:
        raise RuntimeError("the trace holds no gpubench.window span")
    w0 = min(e.time_range.start for e in wins)
    w1 = max(e.time_range.end for e in wins)
    dev = [e for e in events if _is_device(e)
           and e.time_range.end > w0 and e.time_range.start < w1]
    busy = _merge([(max(e.time_range.start, w0), min(e.time_range.end, w1))
                   for e in dev])
    busy_us = sum(e - s for s, e in busy)
    by_op = defaultdict(float)
    for e in dev:
        by_op[e.name] += (e.time_range.end - e.time_range.start) * 1e-6
    spans_s, calls = defaultdict(float), defaultdict(int)
    for e in events:
        if (e.name.startswith("gpubench.") and e.name != WINDOW
                and e.device_type == torch.autograd.DeviceType.CPU):
            spans_s[e.name] += e.device_time_total * 1e-6
            calls[e.name] += 1
    host = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CPU
            and e.time_range.end > w0 and e.time_range.start < w1
            and e.time_range.end > e.time_range.start]
    gaps = []
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for s, e in zip(edges[0::2], edges[1::2]):
        if e > s:
            gaps.append((s, e))
    idle = defaultdict(float)
    host.sort(key=lambda e: e.time_range.start)
    starts = [h.time_range.start for h in host]
    for s, e in gaps:
        idle[_innermost(host, starts, 0.5 * (s + e))] += (e - s) * 1e-6
    rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]  # noqa: E731
    return {"busy_s": busy_us * 1e-6, "window_s": (w1 - w0) * 1e-6,
            "span_device_s": dict(spans_s), "span_calls": dict(calls),
            "kernels": len(dev), "kernel_s": sum(by_op.values()),
            "breakdown": {"device_ops": rank(by_op), "idle_gaps": rank(idle)}}


def _innermost(host, starts, t, walk: int = 4096) -> str:
    """The name of the shortest host call running at ``t``: for nested
    calls, the one that started last among those still running."""
    i = bisect.bisect_right(starts, t) - 1
    for h in host[max(0, i - walk):i + 1][::-1]:
        if h.time_range.end >= t and h.name != WINDOW:
            return h.name
    return "(no host call)"
