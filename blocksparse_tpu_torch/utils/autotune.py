"""Measured route choice per population: measure, don't fossilize.

Counterpart of ``blocksparse_tpu/utils/autotune.py``, with its signatures
and report fields.  The JAX module times the TPU engines (XLA against
Pallas) that ``backend=`` chooses; the port has one engine per device, so
this module times the card's own routes for one product, every one a
hand-written kernel (``ops/dispatch.ROUTES``):

  - "bucket": B1 and B9's element pass, open to every operator;
  - "panel": B5, or B10 on a ``panel="v2"`` operator (r = 1, where the
    panel plan exists);
  - "slab": B8 (r = 1, where the slab plan exists);
  - "patch": B7 at r = 1, B2 at r > 1, B3 on a symmetric operator (unless
    ``patch="never"``, where the patch plan exists).

The routes other than "bucket" take f32 operators only, so a complex,
float64 or bf16 operator, or one of scattered lists, has one candidate and
its report is returned unapplied: timing one program twice would record
noise as policy.  The winner goes into the population policy keyed by the
layout's content digest (``ops/dispatch.set_population_policy``), which the
formats consult ahead of the rules (the v5e ones the JAX package measured);
``interop/serialize`` saves the winners with the operator.

Usage (an operator on the card)::

    from blocksparse_tpu_torch.utils.autotune import autotune_backend

    report = autotune_backend(A)          # r = 1 products of A's population
    report = autotune_backend(A, r=128)   # r > 1 products
    # {"kind", "times_us": {route: us}, "winner", "applied"}
    report = autotune_optimize(A)         # the patch plan's bias, r = 128
    # {"kind": "optimize", "latency_us", "throughput_us", "winner",
    #  "applied", "plans": {bias: G, steps, slots, padded_slots}}

The measuring (:func:`autotune_backend`, :func:`autotune_optimize`, on the
card) is kept apart from the deciding (:func:`open_routes`,
:func:`decide`, :func:`decide_optimize`), which take given times.  Each
candidate is timed on a shallow copy of the operator pinned to its route
(its plans and staged tensors shared, none rebuilt) by
``utils/timing.chained_time_per_iter`` over ``v -> (B @ v) * 1e-3``, as in
the JAX module.  Run it once per deployment, not per call.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

# the layouts a winner is recorded for: _layout, _dlayout, _olayout
from ..ops.dispatch import layouts_of as _layouts_of
from ..ops.dispatch import set_population_policy

__all__ = ["autotune_backend", "autotune_optimize", "decide",
           "decide_optimize", "open_routes"]


def _pinned_copy(A, route: str):
    """Shallow copy of ``A`` whose products take ``route`` where it is open
    (the policy's fall-through otherwise); the plans, staged tensors and
    buckets are ``A``'s own objects."""
    B = copy.copy(A)
    B._pinned = route
    return B


def _check(A, name: str) -> None:
    if A.shape[0] != A.shape[1]:
        raise ValueError(
            f"{name} probes with a chained timer that feeds the product back "
            f"as input: requires a square operator, got {A.shape}")
    if A.device.type != "cuda":
        raise RuntimeError(
            f"{name} measures the card's routes (its hand-written kernels); "
            f"the operator is on {A.device}, not on a CUDA device")


def _keep(A, report: dict) -> dict:
    """Store ``report`` on ``A._autotune_reports[kind]`` and return it."""
    reports = getattr(A, "_autotune_reports", None)
    if reports is None:
        reports = A._autotune_reports = {}
    reports[report["kind"]] = report
    return report


def _probe(A, r: int) -> torch.Tensor:
    rng = np.random.default_rng(0)
    n = A.shape[1]
    x = rng.standard_normal((n,) if r == 1 else (n, r)).astype(np.float32)
    return torch.from_numpy(x).to(A.device)


def _time_us(B, x, repeats: int) -> float:
    from .timing import chained_time_per_iter

    st = chained_time_per_iter(lambda v: (B @ v) * 1e-3, x, iters_lo=5,
                               iters_hi=25, repeats=repeats, reduce="stats")
    return st["median"] * 1e6


def open_routes(A, r: int = 1) -> list:
    """The routes open to ``A``'s r-column f32 products under its own
    options, "bucket" first; builds the host plans (and stages the patch
    plan) that decide it, and times nothing."""
    routes = ["bucket"]
    if A.dtype != torch.float32:
        return routes
    if r == 1:
        if A._panel_for(False) is not None:
            routes.append("panel")
        if A._strip_for(False) is not None:
            routes.append("slab")
    if A.patch != "never" and A._patch_entry(False) is not None:
        routes.append("patch")
    return routes


def decide(A, kind: str, times_us: dict, *, set_policy: bool = True) -> dict:
    """The report of measured ``times_us`` ({route: us}): the fastest
    route wins, and with ``set_policy`` it is recorded for every layout of
    ``A``; stored on ``A._autotune_reports[kind]``."""
    winner = min(times_us, key=times_us.get)
    if set_policy:
        for lay in _layouts_of(A):
            set_population_policy(lay, kind, winner)
    return _keep(A, {"kind": kind, "times_us": dict(times_us),
                     "winner": winner, "applied": set_policy})


def autotune_backend(A, r: int = 1, *, repeats: int = 5,
                     set_policy: bool = True) -> dict:
    """Time ``A @ x`` (r == 1) or ``A @ X[:, :r]`` on every route open to
    ``A`` (:func:`open_routes`) and :func:`decide`; with one route open the
    report comes back unapplied with a note and is not kept."""
    kind = "spmv" if r == 1 else "spmm"
    _check(A, "autotune_backend")
    routes = open_routes(A, r)
    if len(routes) == 1:
        return {"kind": kind, "times_us": {}, "winner": routes[0],
                "applied": False,
                "note": "one route is open to this operator (complex, "
                        "float64, bf16 or scattered lists take the bucket "
                        "route alone): timing it against itself would "
                        "record noise; policy left unchanged"}
    x = _probe(A, r)
    times = {route: _time_us(_pinned_copy(A, route), x, repeats)
             for route in routes}
    return decide(A, kind, times, set_policy=set_policy)


def decide_optimize(A, times_us: dict, *, apply: bool = True) -> dict:
    """The report of measured ``{"latency": us, "throughput": us}``: with
    ``apply`` ``A._optimize`` becomes the winner and ``A``'s patch plans
    are dropped (the next product builds the winner's)."""
    winner = min(times_us, key=times_us.get)
    if apply:
        A._optimize = winner
        A._drop_patch()
    return _keep(A, {"kind": "optimize",
                     "latency_us": times_us["latency"],
                     "throughput_us": times_us["throughput"],
                     "winner": winner, "applied": apply})


def _plan_shape(plan) -> dict:
    """A patch plan's grid group ``G``, step count, slots and the zero
    slots among them (its padding)."""
    b = plan.buckets[0]
    live = int(np.count_nonzero(b.vals.reshape(b.nb, -1).any(axis=1)))
    return {"G": b.G, "steps": b.nb // b.G, "slots": b.nb,
            "padded_slots": b.nb - live}


def autotune_optimize(A, r: int = 128, *, repeats: int = 5,
                      apply: bool = True) -> dict:
    """Time the patch route (B2, or B3 on a symmetric operator) under the
    "latency" and "throughput" plans (``core/patch.build_patch_plan``'s
    bias) and :func:`decide_optimize`; the report also gives each plan's
    :func:`_plan_shape` under ``"plans"``.  Each is timed on a copy with a
    plan of its own: a copy never leaks a plan of the other bias into
    ``A``.  An operator with no patch plan, or whose two plans are one
    (a canvas too large for the bias to move ``G``), gets an unapplied
    report and a note."""
    _check(A, "autotune_optimize")
    report = {"kind": "optimize", "latency_us": None, "throughput_us": None,
              "winner": A._optimize, "applied": False}
    if (A.dtype != torch.float32 or A.patch == "never"
            or A._patch_entry(False) is None):
        return {**report, "note": "no patch plan (non-f32 values, scattered "
                                  "lists or patch='never'): the bias shapes "
                                  "nothing"}
    x = _probe(A, r)
    times, plans = {}, {}
    for opt in ("latency", "throughput"):
        B = _pinned_copy(A, "patch")
        B._optimize = opt
        B._drop_patch()
        plans[opt] = _plan_shape(B._patch_entry(False)[0])
        if opt == "throughput" and plans[opt] == plans["latency"]:
            return {**report, "latency_us": times["latency"], "plans": plans,
                    "note": "both biases give one plan: timing it twice "
                            "would record noise; optimize left unchanged"}
        times[opt] = _time_us(B, x, repeats)
        del B
    return {**decide_optimize(A, times, apply=apply), "plans": plans}
