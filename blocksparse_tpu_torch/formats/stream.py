"""The stream route of the formats: lazy panel and slab plans, one launch.

Every format sends its f32 r = 1 products here before the bucket route, as
the JAX package's formats do.  The host plans (``core/panel.py``,
``core/strip.py``) are built at the first such product and cached per
transpose; ``ops/dispatch.stream_plan_choice`` picks panel, slab or None
(the bucket route) from the host plans alone, and only the chosen plan is
staged on the operator's device.  The panel plan is built by the
operator's ``panel`` option (``ops/panel_router.py``) and runs kernel B5
(``ops/kernels/panel_spmv.py``) or, for a v2 plan, kernel B10
(``ops/kernels/panel2_spmv.py``); the slab plan runs kernel B8
(``ops/kernels/slab_spmv.py``).
"""

from __future__ import annotations

from ..core.panel import PanelPlan
from ..core.strip import plan_from_layout
from ..ops.dispatch import stream_plan_choice
from ..ops.kernels.slab_spmv import plan_device_arrays, slab_apply
from ..ops.panel_router import panel_arrays, panel_plan_general, panel_run

__all__ = ["StreamRouted"]


class StreamRouted:
    """Mixin for an operator with ``_device``, ``_panel`` (the ``panel=``
    option) and an empty dict ``_stream``.

    The plans and bucket-route reads default to one general layout,
    ``_layout`` (BSM, VBCRS); the symmetric format overrides
    ``_build_panel``, ``_build_strip``, ``_stream_reads`` and
    ``_panel_bytes``."""

    def _build_panel(self, transpose: bool):
        return panel_plan_general(self._layout, transpose=transpose,
                                  impl=self._panel)

    def _build_strip(self, transpose: bool):
        return plan_from_layout(self._layout, transpose=transpose)

    def _stream_reads(self):
        """[(layout, value reads)] of the bucket route, for the decision."""
        return [(self._layout, 1)]

    def _panel_bytes(self, plan):
        """The panel plan's cost in the decision; None: the JAX rule's."""
        return None

    def _cached(self, key, build):
        if key not in self._stream:
            self._stream[key] = build()
        return self._stream[key]

    def _panel_for(self, transpose: bool):
        """Lazy host panel plan for A (or A^T); None if ineligible."""
        return self._cached(("panel", transpose),
                            lambda: self._build_panel(transpose))

    def _strip_for(self, transpose: bool):
        """Lazy host slab plan for A (or A^T); None if ineligible."""
        return self._cached(("strip", transpose),
                            lambda: self._build_strip(transpose))

    def _stream_entry(self, transpose: bool):
        """(choice, plan, device tensors); choice None = bucket route."""
        def build():
            pplan = self._panel_for(transpose)
            choice = stream_plan_choice(pplan, self._strip_for(transpose),
                                        self._stream_reads(),
                                        panel_bytes=self._panel_bytes(pplan))
            if choice == "panel":
                plan = self._panel_for(transpose)
                return choice, plan, panel_arrays(plan, self._device)
            if choice == "strip":
                plan = self._strip_for(transpose)
                return choice, plan, plan_device_arrays(plan, self._device)
            return None, None, None
        return self._cached(("route", transpose), build)

    def _staged_panel(self, transpose: bool):
        """The device tensors of the v1 panel plan for A (or A^T) where the
        stream route has staged it, else None (nothing is built here)."""
        entry = self._stream.get(("route", transpose))
        if entry is None or entry[0] != "panel" or not isinstance(
                entry[1], PanelPlan):
            return None
        return entry[2]

    def _stream_apply(self, x, transpose: bool):
        """The product through the chosen stream plan, or None."""
        choice, plan, dev = self._stream_entry(transpose)
        if choice == "panel":
            return panel_run(plan, dev, x)
        if choice == "strip":
            return slab_apply(plan, dev, x)
        return None
