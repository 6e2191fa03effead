"""The one generator of traffic: it reads a mix's data file and drives the
program under test.

A mix names its ``loop`` and that loop's parameters:

- ``"solve"``: a closed loop with one caller.  Each solve gets a fresh
  right-hand side drawn from the seed, runs the program's solver
  (``solver``: "cg" | "bicgstab", with ``tol`` and ``maxiter``) with the
  configuration's block-Jacobi preconditioner, and ends in
  ``torch.cuda.synchronize()``.  Solves start until the window's
  length has passed; the window ends with the last one.
- ``"products"``: ``S @ X`` with ``X`` of ``[n, columns]`` drawn from a
  pool of ``pool`` operands made in set-up, dispatched up to ``ahead``
  products ahead of the device (the host waits for the product ``ahead``
  places back before it enqueues the next), with a synchronize at the
  window's end.

Both keep a sample of their answers, of ``sample`` entries drawn from the
seed over every unit the window finished (reservoir sampling), for the
check once the window has closed.  In a traced run the operator and the
preconditioner are wrapped in spans, and the profiler records the first
``trace_seconds`` of the window.
"""

from __future__ import annotations

import random
import time

import numpy as np
import torch

from . import trace
from .counters import launches, snapshot

# a seed's streams: jitter (the generator), right-hand sides / operands,
# the answers' sample
RHS_STREAM, SAMPLE_STREAM = 1, 2


def stream_seed(seed: int, stream: int) -> int:
    return (int(seed) * 1000003 + stream) % (1 << 63)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def per_second(ends) -> list:
    """Units finished (solves) or enqueued (products) in each second of the
    window, for the log."""
    out = [0] * (int(max(ends, default=0)) + 1)
    for t in ends:
        out[int(t)] += 1
    return out


class Spanned:
    """An operator of the program behind a span of the traced run (the
    solvers take any callable ``x -> A @ x``), counting its calls."""

    def __init__(self, op, name: str):
        self.op, self.name, self.calls = op, name, 0

    def __call__(self, x):
        self.calls += 1
        with trace.span(self.name):
            return self.op @ x


class Reservoir:
    """A uniform sample of ``k`` of the units seen, drawn from ``seed``:
    ``slot()`` says where the unit just seen goes (or None).  The answers
    are copied into buffers made in set-up, so keeping them allocates
    nothing inside the window."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.seen = k, random.Random(seed), 0

    def slot(self):
        self.seen += 1
        if self.seen <= self.k:
            return self.seen - 1
        j = self.rng.randrange(self.seen)
        return j if j < self.k else None

    @property
    def kept(self) -> int:
        return min(self.seen, self.k)


class SolveLoop:
    def __init__(self, system, mix: dict, seed: int):
        import blocksparse_tpu_torch as bt

        self.system, self.mix, self.S = system, mix, system.op
        self.M = system.precond()
        self.solver = getattr(bt, mix["solver"])
        self.kw = {"tol": float(mix["tol"]), "maxiter": int(mix["maxiter"])}
        self.gen = torch.Generator(device=system.device)
        self.gen.manual_seed(stream_seed(seed, RHS_STREAM))
        self.sample = Reservoir(int(mix["sample"]), stream_seed(seed, SAMPLE_STREAM))
        self.kept_b = torch.empty(self.sample.k, system.n, dtype=system.dtype,
                                  device=system.device)
        self.kept_x = torch.empty_like(self.kept_b)

    def rhs(self):
        s = self.system
        return torch.randn(s.n, dtype=s.dtype, device=s.device, generator=self.gen)

    def warm_up(self):
        for _ in range(int(self.mix.get("warmup", 2))):
            self.solver(self.S, self.rhs(), M=self.M, **self.kw)
        _sync(self.system.device)

    def window(self, seconds: float, traced: bool) -> dict:
        dev = self.system.device
        A, M = self.S, self.M
        if traced:
            A = Spanned(self.S, "gpubench.S")
            M = Spanned(self.M, "gpubench.M")
        times, infos, ends = [], [], []
        before = snapshot()
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while True:
            b = self.rhs()
            ts = time.perf_counter()
            with trace.span("gpubench.solve"):
                x, info = self.solver(A, b, M=M, **self.kw)
                _sync(dev)
            te = time.perf_counter()
            times.append(te - ts)
            ends.append(te - t0)
            infos.append(info)
            j = self.sample.slot()
            if j is not None:
                self.kept_b[j].copy_(b)
                self.kept_x[j].copy_(x)
            if te >= deadline:
                break
        window_s = te - t0
        after = snapshot()
        its = torch.stack([i.iterations for i in infos]).to(torch.int64)
        conv = torch.stack([i.converged for i in infos])
        rec = {"loop": "solve", "units": len(times), "window_s": window_s,
               "per_second": per_second(ends), "iterations": int(its.sum()),
               "unconverged": int((~conv).sum()),
               "host_checks": after["host_checks"] - before["host_checks"],
               "launches": launches(before, after),
               "e2e": {"solve_ms": window_s / len(times) * 1e3,
                       "solve_p95_ms": float(np.percentile(times, 95)) * 1e3}}
        if traced:
            rec["calls"] = {"S": A.calls, "M": M.calls}
        return rec

    def answers(self) -> dict:
        k = self.sample.kept
        return {"b": list(self.kept_b[:k]), "x": list(self.kept_x[:k])}

    def free(self):
        self.S = self.M = None


class ProductsLoop:
    def __init__(self, system, mix: dict, seed: int):
        self.system, self.mix, self.S = system, mix, system.op
        self.r = int(mix["columns"])
        g = torch.Generator(device=system.device)
        g.manual_seed(stream_seed(seed, RHS_STREAM))
        self.pool = [torch.randn(system.n, self.r, dtype=system.dtype,
                                 device=system.device, generator=g)
                     for _ in range(int(mix["pool"]))]
        self.ahead = int(mix["ahead"])
        self.sample = Reservoir(int(mix["sample"]), stream_seed(seed, SAMPLE_STREAM))
        self.kept_y = torch.empty(self.sample.k, system.n, self.r,
                                  dtype=system.dtype, device=system.device)
        self.kept_k = [0] * self.sample.k

    def warm_up(self):
        for i in range(int(self.mix.get("warmup", 2))):
            self.S @ self.pool[i % len(self.pool)]
        _sync(self.system.device)

    def window(self, seconds: float, traced: bool) -> dict:
        dev = self.system.device
        A = Spanned(self.S, "gpubench.S") if traced else self.S.__matmul__
        cuda = dev.type == "cuda"
        ring = [None] * self.ahead
        enqueue, ends = [], []
        before = snapshot()
        i = 0
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while time.perf_counter() < deadline:
            slot = i % self.ahead
            if ring[slot] is not None:
                ring[slot].synchronize()
            k = i % len(self.pool)
            ts = time.perf_counter()
            Y = A(self.pool[k])
            enqueue.append(time.perf_counter() - ts)
            if cuda:
                ring[slot] = torch.cuda.Event()
                ring[slot].record()
            j = self.sample.slot()
            if j is not None:
                self.kept_y[j].copy_(Y)
                self.kept_k[j] = k
            ends.append(time.perf_counter() - t0)
            i += 1
        _sync(dev)
        window_s = time.perf_counter() - t0
        after = snapshot()
        rec = {"loop": "products", "units": i, "window_s": window_s,
               "columns": self.r, "enqueue_s": enqueue,
               "per_second": per_second(ends),
               "launches": launches(before, after),
               "e2e": {"rhs_per_s": i * self.r / window_s}}
        if traced:
            rec["calls"] = {"S": A.calls, "M": 0}
        return rec

    def answers(self) -> dict:
        k = self.sample.kept
        return {"operand": self.kept_k[:k], "y": list(self.kept_y[:k]),
                "pool": self.pool}

    def free(self):
        self.S = None


LOOPS = {"solve": SolveLoop, "products": ProductsLoop}
