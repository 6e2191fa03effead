"""The routes of the formats' products: policy, patch, stream, buckets.

Every format sends a product through :meth:`StreamRouted._apply_routes`,
in the JAX package's order, after the population policy:

  0. the route recorded for the operator's population
     (``ops/dispatch.population_route``, set by ``utils/autotune``), or the
     route pinned on a copy the autotuner times (``_pinned``), where that
     route is open to the product;
  1. the patch route where ``patch_wins``;
  2. the stream route (f32 r = 1) where ``stream_plan_choice`` picks a
     plan;
  3. the bucket route.

The stream route's host plans (``core/panel.py``, ``core/strip.py``) are
built at the first such product and cached per transpose;
``ops/dispatch.stream_plan_choice`` picks panel, slab or None (the bucket
route) from the host plans alone, and only a plan that runs is staged on
the operator's device, once (a plan the policy picks and the rule's plan
share it).  The panel plan is built by the operator's ``panel`` option
(``ops/panel_router.py``) and runs kernel B5 (``ops/kernels/
panel_spmv.py``) or, for a v2 plan, kernel B10 (``ops/kernels/
panel2_spmv.py``); the slab plan runs kernel B8 (``ops/kernels/
slab_spmv.py``).

Spans (``utils/profiling.py``): building a stream plan and staging it are
``bsp.plan.panel`` / ``bsp.plan.strip`` (set-up spans, always recorded);
while a profiler records, each product is ``bsp.apply.<route>`` with the
route it took ("patch", "panel", "slab" or "bucket") and ``r``.
"""

from __future__ import annotations

import torch

from ..core.panel import PanelPlan
from ..core.strip import plan_from_layout
from ..ops.dispatch import (patch_eligible, patch_wins, population_route,
                            stream_plan_choice, strip_eligible)
from ..ops.kernels.slab_spmv import plan_device_arrays, slab_apply
from ..ops.panel_router import panel_arrays, panel_plan_general, panel_run
from ..utils.profiling import NOOP, annotate, recording

__all__ = ["StreamRouted"]

# the population policy's stream routes and their plans' names here
_STREAM_PLANS = {"panel": "panel", "slab": "strip"}


def _route_span(route: str, r: int):
    """The span ``bsp.apply.<route>`` of a product with r columns while a
    profiler records, else the shared no-op context."""
    return annotate(f"bsp.apply.{route}", r=r) if recording() else NOOP


class StreamRouted:
    """Mixin for an operator with ``_device``, ``_dtype``, ``_panel`` (the
    ``panel=`` option), ``_patch_mode`` and an empty dict ``_stream``.

    A format supplies ``_patch_entry(transpose)`` (its lazy patch plan and
    device tensors, or None), ``_patch_run(entry, x, transpose)`` and
    ``_bucket_apply(x, transpose, conj)``.  The plans and bucket-route reads
    default to one general layout, ``_layout`` (BSM, VBCRS); the symmetric
    format overrides ``_build_panel``, ``_build_strip``, ``_stream_reads``
    and ``_panel_bytes``."""

    _pinned = None  # a route forced on a copy (utils/autotune)

    def _build_panel(self, transpose: bool):
        return panel_plan_general(self._layout, transpose=transpose,
                                  impl=self._panel)

    def _build_strip(self, transpose: bool):
        return plan_from_layout(self._layout, transpose=transpose)

    def _stream_reads(self):
        """[(layout, value reads)] of the bucket route, for the decisions."""
        return [(self._layout, 1)]

    def _panel_bytes(self, plan):
        """The panel plan's cost in the decision; None: the JAX rule's."""
        return None

    def _cached(self, key, build):
        if key not in self._stream:
            self._stream[key] = build()
        return self._stream[key]

    def _planned(self, kind: str, build, transpose: bool):
        with annotate(f"bsp.plan.{kind}", transpose=int(transpose)):
            return build(transpose)

    def _panel_for(self, transpose: bool):
        """Lazy host panel plan for A (or A^T); None if ineligible."""
        return self._cached(("panel", transpose), lambda: self._planned(
            "panel", self._build_panel, transpose))

    def _strip_for(self, transpose: bool):
        """Lazy host slab plan for A (or A^T); None if ineligible."""
        return self._cached(("strip", transpose), lambda: self._planned(
            "strip", self._build_strip, transpose))

    def _stage(self, choice: str, transpose: bool):
        """(plan, device tensors) of the "panel" or "strip" plan for A (or
        A^T), reusing those :meth:`_staged` keeps; None where there is no
        plan."""
        staged = self._stream.get(("staged", choice, transpose))
        if staged is not None:
            return staged
        if choice == "panel":
            plan, stage = self._panel_for(transpose), panel_arrays
        else:
            plan, stage = self._strip_for(transpose), plan_device_arrays
        if plan is None:
            return None
        with annotate(f"bsp.plan.{choice}", transpose=int(transpose),
                      staged=1):
            return plan, stage(plan, self._device)

    def _staged(self, choice: str, transpose: bool):
        """:meth:`_stage` for a route the policy picks, sharing the rule's
        staged plan where it is the same one."""
        entry = self._stream.get(("route", transpose))
        if entry is not None and entry[0] == choice:
            return entry[1:]
        return self._cached(("staged", choice, transpose),
                            lambda: self._stage(choice, transpose))

    def _stream_entry(self, transpose: bool):
        """(choice, plan, device tensors); choice None = bucket route."""
        def build():
            pplan = self._panel_for(transpose)
            choice = stream_plan_choice(pplan, self._strip_for(transpose),
                                        self._stream_reads(),
                                        panel_bytes=self._panel_bytes(pplan))
            if choice is None:
                return None, None, None
            return (choice, *self._stage(choice, transpose))
        return self._cached(("route", transpose), build)

    def _staged_panel(self, transpose: bool):
        """The device tensors of the v1 panel plan for A (or A^T) where the
        stream route has staged it, else None (nothing is built here)."""
        entry = self._stream.get(("route", transpose))
        if entry is None or entry[0] != "panel" or not isinstance(
                entry[1], PanelPlan):
            return None
        return entry[2]

    def _stream_apply(self, x, transpose: bool, choice: str | None = None):
        """The product through the rule's stream plan, or through the
        ``choice`` ("panel" | "strip") plan where given; None where there
        is none (the bucket route)."""
        if choice is None:
            choice, plan, dev = self._stream_entry(transpose)
        elif (staged := self._staged(choice, transpose)) is None:
            return None
        else:
            plan, dev = staged
        if choice == "panel":
            with _route_span("panel", 1):
                return panel_run(plan, dev, x)
        if choice == "strip":
            with _route_span("slab", 1):
                return slab_apply(plan, dev, x)
        return None

    def _on_route(self, route: str, x, transpose: bool, conj: bool):
        """The product on the policy's ``route``, or None where that route
        is not open to it (the rules then decide)."""
        r = 1 if x.ndim == 1 else x.shape[1]
        if route == "bucket":
            with _route_span("bucket", r):
                return self._bucket_apply(x, transpose, conj)
        if route == "patch":
            if (self._patch_mode == "never" or self._dtype != torch.float32
                    or x.dtype != torch.float32):
                return None
            entry = self._patch_entry(transpose)
            if entry is None:
                return None
            with _route_span("patch", r):
                return self._patch_run(entry, x, transpose)
        if not strip_eligible(x, self._dtype):
            return None
        return self._stream_apply(x, transpose, _STREAM_PLANS[route])

    def _drop_patch(self) -> None:
        """Forget the patch plans (a new ``_optimize`` shapes the next)."""
        self._patch = {} if isinstance(self._patch, dict) else None

    def _apply_routes(self, x, transpose: bool, conj: bool):
        """The product on ``x`` in a compute dtype of the values."""
        r = 1 if x.ndim == 1 else x.shape[1]
        route = self._pinned or population_route(self, r)
        if route is not None:
            y = self._on_route(route, x, transpose, conj)
            if y is not None:
                return y
        if patch_eligible(x, self._dtype, self._patch_mode):
            entry = self._patch_entry(transpose)
            if entry is not None and patch_wins(
                    entry[0], self._stream_reads(), r, self._patch_mode):
                with _route_span("patch", r):
                    return self._patch_run(entry, x, transpose)
        # the patch and stream routes are f32: conj changes nothing there
        if strip_eligible(x, self._dtype):
            y = self._stream_apply(x, transpose)
            if y is not None:
                return y
        with _route_span("bucket", r):
            return self._bucket_apply(x, transpose, conj)
