"""Profiling hooks: ``torch.profiler`` traces around block-sparse products.

Counterpart of ``blocksparse_tpu/utils/profiling.py``: wrap a region in
:func:`trace` to write a Chrome trace (``chrome://tracing`` or Perfetto) of
its host ops and, on a card, its kernels into a directory; label regions
with :func:`annotate`, which nests.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

__all__ = ["trace", "annotate"]


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed block and write its Chrome trace into
    ``logdir`` (made if missing) as ``trace_<pid>_<ns>.json``; yields the
    ``torch.profiler.profile`` object, whose ``key_averages()`` sums the
    ops.  Records CUDA activity where a card is present.

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
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name: str):
    """A named range in the trace (``torch.profiler.record_function``).

    Example::

        with annotate("spmv-halo-exchange"):
            ...
    """
    return torch.profiler.record_function(name)
