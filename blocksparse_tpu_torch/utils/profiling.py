"""Profiling: the program's spans, and ``torch.profiler`` traces around them.

Counterpart of ``blocksparse_tpu/utils/profiling.py``.  :func:`annotate` is
the program's span: it nests, opens a profiler range of its name (so it
shows in any profiler trace) and records its name, start, end, parent and
a few attributes into a bounded in-memory registry.  :func:`summary`
sums the registry by name (calls, total and self seconds; self time is a
span's duration less its children's), :func:`spans` lists its newest
records and :func:`reset` clears it.  :func:`trace` writes a Chrome trace
(``chrome://tracing`` or Perfetto) of the enclosed block's host ops and, on
a card, its kernels, with the registry's spans in the same file.

Two classes of span, and no switch:

- set-up spans (the formats' constructors and the lazy plans) always
  record: a few dozen an operator, against seconds of host work;
- hot-path spans (a product's route, ``bsp.apply.<route>``, and each kernel
  launch, ``bsp.launch.<entry>``) record only while a profiler records.
  Their call sites open ``annotate(...) if recording() else NOOP``: with no
  profiler recording that is one read of the profiler's state and the
  shared no-op context, with no clock read and nothing allocated.

The profiler range is an operator-scope one
(``torch._C._profiler._RecordFunctionFast``, the range the code that
``torch.fx`` generates opens; ``torch.profiler.record_function`` where a
build lacks it).  The profiler ties each kernel to the innermost operator
range open when it was launched, and a user-scope ``record_function`` is
not one: a kernel the port launches through ctypes inside a launch span is
tied to that span, and its device time counts in every span around it.

Clock: spans are stamped in nanoseconds of the Unix epoch, the clock of
the profiler's Chrome trace (an event sits at ``ts + baseTimeNanoseconds /
1000`` microseconds), read as ``time.perf_counter_ns()`` plus the offset
between the two clocks taken at import, so durations are monotonic.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import NamedTuple

import torch
from torch.autograd import profiler as _autograd_profiler

__all__ = ["trace", "annotate", "summary", "spans", "reset", "recording",
           "NOOP", "MAX_SPANS", "Span"]

MAX_SPANS = 16384  # records kept; summary() counts every span ever closed

# the shared no-op context of a hot-path span while no profiler records
NOOP = contextlib.nullcontext()

_EPOCH_NS = time.time_ns() - time.perf_counter_ns()
_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast",
                 torch.profiler.record_function)


def _clock() -> int:
    """Now, in nanoseconds of the Unix epoch."""
    return time.perf_counter_ns() + _EPOCH_NS


class Span(NamedTuple):
    """One closed span: ``id``, ``name``, ``start_ns`` / ``end_ns`` (Unix
    epoch), ``parent`` (the enclosing span's id, or None) and ``attrs``."""
    id: int
    name: str
    start_ns: int
    end_ns: int
    parent: int | None
    attrs: dict


_records: collections.deque = collections.deque(maxlen=MAX_SPANS)
_totals: dict = {}  # name -> [calls, total ns, self ns]
_ids = itertools.count(1)
_local = threading.local()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Open:
    """A span while it is open: the context :func:`annotate` returns.
    ``set(**attrs)`` adds attributes known only inside it."""

    __slots__ = ("name", "attrs", "id", "parent", "start", "child_ns", "_rf")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def set(self, **attrs) -> "_Open":
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "_Open":
        self._rf = _RANGE(self.name)
        self._rf.__enter__()
        stack = _stack()
        self.parent = stack[-1] if stack else None
        self.id = next(_ids)
        self.child_ns = 0
        stack.append(self)
        self.start = _clock()
        return self

    def __exit__(self, *exc) -> bool:
        end = _clock()
        self._rf.__exit__(*exc)
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        dur = end - self.start
        parent = self.parent
        if parent is not None:
            parent.child_ns += dur
        tot = _totals.get(self.name)
        if tot is None:
            tot = _totals[self.name] = [0, 0, 0]
        tot[0] += 1
        tot[1] += dur
        tot[2] += dur - self.child_ns
        _records.append(Span(self.id, self.name, self.start, end,
                             None if parent is None else parent.id,
                             self.attrs))
        return False


def annotate(name: str, **attrs):
    """The program's span: a named, nesting range recorded into the
    registry and, as an operator-scope profiler range, into any profiler
    trace.  ``attrs``: a few small integers (``blocks``,
    ``buckets``, ``colors``, ``r``, ...) or short strings; ``set(**attrs)``
    on the entered span adds more.

    Example::

        with annotate("spmv-halo-exchange", rounds=3):
            ...
    """
    return _Open(name, attrs)


def recording() -> bool:
    """Whether a ``torch.profiler`` is recording: hot-path spans record only
    then."""
    return _autograd_profiler._is_profiler_enabled


def summary() -> dict:
    """``{name: {"calls", "total_s", "self_s"}}`` over every span closed
    since the last :func:`reset` (not only those :func:`spans` keeps)."""
    return {name: {"calls": c, "total_s": t * 1e-9, "self_s": s * 1e-9}
            for name, (c, t, s) in _totals.items()}


def spans() -> list:
    """The newest closed spans (at most :data:`MAX_SPANS`), as
    :class:`Span` records in the order they closed."""
    return list(_records)


def reset() -> None:
    """Clear the registry: the records and the sums."""
    _records.clear()
    _totals.clear()


def _chrome_events(base_ns: int) -> list:
    """The registry's spans as Chrome trace events on a trace whose
    ``baseTimeNanoseconds`` is ``base_ns``, in a thread row of their own."""
    pid, tid = os.getpid(), "bsp spans"
    out = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
            "args": {"name": "bsp spans (registry)"}}]
    for s in _records:
        out.append({"ph": "X", "cat": "bsp_span", "name": s.name, "pid": pid,
                    "tid": tid, "ts": (s.start_ns - base_ns) / 1e3,
                    "dur": (s.end_ns - s.start_ns) / 1e3,
                    "args": {"id": s.id, "parent": s.parent, **s.attrs}})
    return out


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed block and write its Chrome trace into
    ``logdir`` (made if missing) as ``trace_<pid>_<ns>.json``; yields the
    ``torch.profiler.profile`` object, whose ``key_averages()`` sums the
    ops.  Records CUDA activity where a card is present.  The file also
    holds the registry's spans (set-up spans from before the block
    included) on the trace's own clock, so a construction phase, a
    product's route and launch spans and the kernels share one timeline.

    Example::

        with trace("/tmp/bsp-trace"):
            y = A @ x
            torch.cuda.synchronize()
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    path = os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    doc.setdefault("traceEvents", []).extend(
        _chrome_events(int(doc.get("baseTimeNanoseconds", 0))))
    with open(path, "w") as f:
        json.dump(doc, f)
