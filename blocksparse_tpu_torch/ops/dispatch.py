"""Routing of a product to its engine.

Counterpart of ``blocksparse_tpu/ops/dispatch.py``.  A format's ``_apply``
tries, in the JAX package's order:

  1. the patch route (f32, ``patch_wins``): kernels B2 / B3 for r > 1,
     kernel B7 for r = 1 (only under ``patch="always"``);
  2. the stream route (f32 operator and operand, r = 1,
     ``strip_eligible``): ``stream_plan_choice`` weighs the panel plan
     (``core/panel.py``, kernel B5, or with ``panel="v2"``
     ``core/panel2.py``, kernel B10), the slab plan (``core/strip.py``,
     kernel B8) and the bucket engines by bytes streamed, and the chosen
     plan runs in one launch;
  3. the bucket route, ``apply_operand`` / ``apply_symmetric`` here, one
     launch per layout and kind of bucket, all adding into one zeroed
     output per product:

  - the chunked (``chunk > 1``) buckets in one multi-bucket launch of the
    chunk-table kernel B1 (``ops/kernels/fused_spmm.multi_block_apply``;
    the port of the JAX engine's ``chunked_multi_apply`` chain);
  - the element buckets (``chunk == 1``) in one launch of kernel B9's
    element pass (``ops/kernels/mask_select.element_apply``), or, under
    ``schedule="colored"`` where ``colored_wins`` holds, through the
    colored element route (``ops/kernels/mask_select.colored_apply`` over
    the plan of ``ops/colored.py``): one products pass into a scratch in
    the plan's order (at r > 1 two launches on the symmetric pass), then
    every color round summed in one launch of B9's colored rounds,
    race-free by the colors (no atomics, the same bits on every run; the
    chunked buckets before it still add with B1's atomics, so a colored
    product is bit-reproducible only where the operand has no chunked
    buckets); every dtype pair and r.

  CPU tensors run the kernels' plain versions through the same calls.  The
  launches read descriptor tables of the staged buckets
  (:class:`StagedBuckets`, :func:`bucket_tables`), built at the first
  product and kept with the buckets.

``apply_symmetric`` does the same for S = D + O + O^T: the diagonal through
``apply_operand``, then the off-diagonal buckets in the symmetric modes of
the same two launches (both contributions from one read of the values).

Complex operators (complex64 / complex128) take the bucket route alone:
the patch and stream routes are f32 (``patch_eligible``,
``strip_eligible``), so their products run B1 and B9's element pass in the
complex instances.  ``conj`` reaches the launches as their conjugate mode
(``conj(V)``; with ``transpose``, ``V^H``).  So does every product whose
operator or compute dtype is not float32: bf16 storage, a float64 operand
on a float32 operator, a complex128 one on a complex64 operator (the
formats cast or view the operand first, ``formats/block_sparse.
promoted_apply``), in the launches' mixed instances.

``scatter="sorted"`` (general and VBCRS operators, as in the JAX package):
the element buckets of a non-symmetric pass run B9's owner mode
(``ops/kernels/mask_select.owner_apply``: race-free by row ownership, the
same bits on every run) in place of the element pass, and no colored plan
(the JAX package also skips the colored plan under "sorted").  The chunked
buckets still add with B1's atomics, as the JAX chunked path ignores
``scatter``, so a sorted product is bit-reproducible only where the
operand has no chunked buckets; full determinism is ROADMAP A5.

The population policy (the port of the JAX ``auto_policy``'s first
source): ``utils/autotune.autotune_backend`` times the routes open to an
operator on the card and records the winner per population, keyed by the
layout's content digest (:func:`set_population_policy`).  A format consults
it ahead of the rules (:func:`population_route`): ``ROUTES`` are

  - "bucket": the bucket route above (B1 and B9's element pass);
  - "panel": the stream route's panel plan (B5, or B10 on a ``panel="v2"``
    operator);
  - "slab": the stream route's slab plan (B8);
  - "patch": the patch route, B7 at r = 1, B2 at r > 1 (B3 on a symmetric
    operator), also at r = 1 under ``patch="auto"``.

A route not open to a product (a non-f32 operand or operator, a matrix
operand on "panel" / "slab", ``patch="never"``, no plan for that
orientation) falls through to the rules.  While the table is empty a
product pays one dict test and no digest is computed.

``backend=`` (the JAX constructors' engine choice: Pallas, XLA or the
interpreter) is stored, validated (:func:`check_jax_options`) and saved,
and routes nothing: the port has one engine per device, the kernels on the
card and their plain versions on the CPU; the population policy takes its
place.  ``optimize=`` ("auto" | "latency" | "throughput" | None) is the
patch plan's grid-group bias, passed to ``core/patch.build_patch_plan`` as
in the JAX package; ``utils/autotune.autotune_optimize`` measures it.

The rules (``patch_wins``, ``stream_plan_choice``, the planners' costs) are
the JAX package's, measured on a TPU v5e and kept so the port routes as it
does; re-measuring them on the H100 is queued (ROADMAP A1).  The JAX
package's TPU guards (chunk >= 8, the scalar-memory table cap, bf16
alignment, the on-chip memory budget, the r = 1 patch kernel's G % 8 rule,
and the mask-select kernels' operand cap n <= 32768 and 4096-index minimum)
have no counterpart here.  Its two routing switches are constructor
options of the formats instead of environment variables: ``patch=``
("auto" | "always" | "never", the JAX ``BST_PATCH``) and ``panel=``
("v1" | "v2", the JAX ``BST_PANEL_IMPL``); :func:`check_route_options`
validates them.
"""

from __future__ import annotations

import torch

from .colored import build_colored_plan, colored_wins
from .kernels.fused_spmm import BucketTable, multi_fused_apply
from .kernels.mask_select import (colored_fused_apply, element_fused_apply,
                                  owner_fused_apply)

__all__ = ["apply_operand", "apply_symmetric", "bucket_tables",
           "check_route_options", "element_plan", "patch_eligible",
           "patch_wins", "strip_eligible", "stream_plan_choice",
           "check_jax_options", "StagedBuckets", "PATCH_MODES", "PANEL_IMPLS",
           "BACKENDS", "OPTIMIZE_MODES", "SCATTER_MODES", "ROUTES",
           "layouts_of", "population_policy", "population_route",
           "set_population_policy"]

PATCH_MODES = ("auto", "always", "never")
PANEL_IMPLS = ("v1", "v2")
# the JAX constructors' values (see the module docstring)
BACKENDS = ("auto", "xla", "pallas", "pallas-interpret")
OPTIMIZE_MODES = ("auto", "latency", "throughput", None)
SCATTER_MODES = ("atomic", "sorted")
ROUTES = ("bucket", "panel", "slab", "patch")
POLICY_KINDS = ("spmv", "spmm")

# measured winners per population, {(layout digest, kind): route}; written
# by utils/autotune.autotune_backend(set_policy=True) and interop/serialize
_POPULATION_POLICY: dict = {}

# The bucket engines of the JAX package re-stream values per 128-column RHS
# slice, the patch mono-kernel per 256 columns; one bucket launch costs about
# as much as streaming this many bytes.  These are the JAX package's rule
# constants, kept so the flagship routes as it did there (see patch_wins).
_BUCKET_R_SLICE = 128
_PATCH_R_SLICE = 256
_STRIP_TAX = 1.0e6


def check_route_options(patch: str, panel: str) -> None:
    """Raise ``ValueError`` for a ``patch=`` / ``panel=`` value outside
    :data:`PATCH_MODES` / :data:`PANEL_IMPLS`."""
    if patch not in PATCH_MODES:
        raise ValueError(f"unknown patch={patch!r}; expected one of "
                         f"{PATCH_MODES}")
    if panel not in PANEL_IMPLS:
        raise ValueError(f"unknown panel={panel!r}; expected one of "
                         f"{PANEL_IMPLS}")


def check_jax_options(backend: str, optimize, scatter: str = "atomic"
                      ) -> None:
    """Raise ``ValueError`` for a ``backend=`` / ``optimize=`` /
    ``scatter=`` value outside :data:`BACKENDS` / :data:`OPTIMIZE_MODES` /
    :data:`SCATTER_MODES`."""
    for name, value, valid in (("backend", backend, BACKENDS),
                               ("optimize", optimize, OPTIMIZE_MODES),
                               ("scatter", scatter, SCATTER_MODES)):
        if value not in valid:
            raise ValueError(f"unknown {name}={value!r}; expected one of "
                             f"{valid}")


def layouts_of(op) -> list:
    """The host layouts of an operator: ``_layout`` (general, VBCRS), or
    ``_dlayout`` and ``_olayout`` (symmetric)."""
    return [lay for lay in (getattr(op, a, None)
                            for a in ("_layout", "_dlayout", "_olayout"))
            if lay is not None]


def set_population_policy(layout, kind: str, route: str) -> None:
    """Record ``route`` (one of :data:`ROUTES`) for the ``kind`` ("spmv":
    r = 1, "spmm": r > 1) products of every operator whose layout has
    ``layout``'s content."""
    if kind not in POLICY_KINDS:
        raise ValueError(f"unknown kind={kind!r}; expected one of "
                         f"{POLICY_KINDS}")
    if route not in ROUTES:
        raise ValueError(f"unknown route={route!r}; expected one of "
                         f"{ROUTES}")
    _POPULATION_POLICY[(layout.digest, kind)] = route


def population_policy(layout, kind: str) -> str | None:
    """The route recorded for ``layout``'s population and ``kind``, or
    None; no digest is computed while the table is empty."""
    if not _POPULATION_POLICY:
        return None
    return _POPULATION_POLICY.get((layout.digest, kind))


def population_route(op, r: int) -> str | None:
    """The policy's route for an r-column product of ``op``: the route
    recorded for every layout of ``op``, else None (the rules decide)."""
    if not _POPULATION_POLICY:
        return None
    kind = "spmv" if r == 1 else "spmm"
    routes = {population_policy(lay, kind) for lay in layouts_of(op)}
    return routes.pop() if len(routes) == 1 else None


def patch_eligible(x: torch.Tensor, dtype: torch.dtype,
                   mode: str = "auto") -> bool:
    """Static pre-check for the patch engines: f32 operator and operand,
    ``mode`` not "never", and a matrix operand unless ``mode`` is "always"
    (under "auto" ``patch_wins`` refuses every vector, so the formats need
    not build the plan to learn it)."""
    return (mode != "never" and dtype == torch.float32
            and x.dtype == torch.float32
            and (x.ndim > 1 or mode == "always"))


def patch_wins(plan, layouts_reads, r: int = 1, mode: str = "auto") -> bool:
    """Patch engines vs the bucket engines.

    Under ``mode="always"`` the patch route takes every r (at r = 1 kernel
    B7), as the JAX package's ``BST_PATCH=always``.  Under "auto", r = 1
    stays off the patch route and r > 1 follows the byte rule verbatim: the
    rule measured on the TPU v5e the JAX package was tuned on, awaiting
    measurement on the H100, kept so the flagship routes as on the TPU.
    """
    if plan is None:
        return False
    if mode == "always":
        return True
    if r <= 1:
        return False
    bucket_slices = -(-r // _BUCKET_R_SLICE)
    bucket = sum(
        l.padded_nnz * 4 * rd * bucket_slices
        + _STRIP_TAX * max(len(l.buckets), 1) * bucket_slices
        for l, rd in layouts_reads
    )
    return plan.value_bytes * -(-r // _PATCH_R_SLICE) < 2 * bucket


def strip_eligible(x: torch.Tensor, dtype: torch.dtype) -> bool:
    """Static pre-check for the stream route: f32 operator and operand and
    a vector operand (r = 1)."""
    return (dtype == torch.float32 and x.dtype == torch.float32
            and x.ndim == 1)


def stream_plan_choice(pplan, splan, layouts_reads, *,
                       panel_bytes: float | None = None) -> str | None:
    """'panel' | 'strip' | None: the cheapest total stream wins.

    ``pplan`` / ``splan``: the panel and slab plans, or None where the
    operand has none.  The JAX package's rule verbatim, with its
    ``BST_PANEL``/``BST_STRIP`` modes fixed at "auto": each plan costs its
    tile and aux bytes plus one launch tax; the bucket engines cost their
    padded bytes per value read (``layouts_reads``: [(layout, reads)],
    symmetric off-diagonals read twice), scattered buckets charged up to
    3x by chunk width.  ``panel_bytes``, where given, is the panel plan's
    cost in place of its tile and aux bytes: the cost by which the port's
    router picked the plan (``ops/panel_router.py::route_bytes``).
    """
    cands = []
    if pplan is not None:
        if panel_bytes is None:
            panel_bytes = pplan.tile_bytes + pplan.aux_bytes
        cands.append((panel_bytes + _STRIP_TAX, "panel"))
    if splan is not None:
        cands.append((splan.tile_bytes + splan.aux_bytes + _STRIP_TAX,
                      "strip"))
    if not cands:
        return None

    def bucket_cost(b):
        pb = b.nblocks * b.mp * b.kp * 4
        return pb if b.all_contiguous else pb * min(3.0, 1.0 + 4.0 / b.chunk)

    bucket = sum(sum(bucket_cost(b) for b in lay.buckets) * rd
                 for lay, rd in layouts_reads)
    bytes_, which = min(cands)
    return which if bytes_ - _STRIP_TAX < bucket else None


def element_plan(layout, elem_ids, out_len: int, colors, device, *,
                 transpose: bool, symmetric: bool):
    """The colored plan that the element buckets ``elem_ids`` of ``layout``
    run under, or None (scatter-add): a plan needs ``colors`` and a win of
    ``colored_wins``."""
    if colors is None:
        return None
    hosts = [layout.buckets[i] for i in elem_ids]
    n_entries = sum(hb.nblocks * (hb.mp + hb.kp if symmetric
                                  else (hb.kp if transpose else hb.mp))
                    for hb in hosts)
    if not colored_wins(len(colors), out_len, n_entries):
        return None
    return build_colored_plan(layout, colors, out_len, transpose,
                              tuple(elem_ids), symmetric=symmetric,
                              device=device)


class StagedBuckets(tuple):
    """A layout's buckets on the operator's device: per bucket ``(values,
    row_idx, col_idx, row_chunk, col_chunk)`` (the chunk tables None for
    element buckets).  ``tables`` caches the descriptor tables of the
    bucket route's launches over them (:func:`bucket_tables`): they hold
    the tensors' addresses and live exactly as long as these tensors, and
    re-staged buckets are a new object with tables of their own."""

    def __new__(cls, buckets):
        self = super().__new__(cls, buckets)
        self.tables = {}
        return self


def bucket_tables(staged: StagedBuckets, layout) -> dict:
    """``{"chunked": BucketTable | None, "element": BucketTable | None}``
    over ``layout``'s chunked and element buckets (None where it has none),
    built at the first product and kept on ``staged``, each with the stored
    entries of its blocks (``layout.stored_by_bucket``)."""
    if not staged.tables:
        chunked, elem, stored = [], [], [0, 0]
        for hb, (vals, ridx, cidx, rc, cc), n in zip(
                layout.buckets, staged, layout.stored_by_bucket):
            if hb.chunk > 1:
                chunked.append((vals, rc, cc, hb.chunk))
            else:
                elem.append((vals, ridx, cidx, 1))
            stored[hb.chunk == 1] += n
        staged.tables.update(
            chunked=BucketTable(chunked, stored[0]) if chunked else None,
            element=BucketTable(elem, stored[1]) if elem else None)
    return staged.tables


def _add_buckets(dev_buckets, layout, x, y, *, transpose, symmetric, conj,
                 colors, adjoint_colors=None, scatter="atomic"):
    """``y`` plus ``layout``'s bucketed product with ``x``, in place: one
    B1 launch over the chunked buckets, then one element pass over the
    element buckets (the owner mode under ``scatter="sorted"`` off the
    symmetric pass), or their colored element route where ``colors`` are
    given and the plan wins.  ``adjoint_colors``: the colors of the
    transposed pass, whose plan (where it wins) x's cotangent runs."""
    tables = bucket_tables(dev_buckets, layout)
    if tables["chunked"] is not None:
        y = multi_fused_apply(tables["chunked"], x, out=y,
                              transpose=transpose, symmetric=symmetric,
                              conj=conj)
    if tables["element"] is None:
        return y
    if scatter == "sorted" and not symmetric:
        return owner_fused_apply(tables["element"], x, out=y,
                                 transpose=transpose, conj=conj)
    elem_ids = [i for i, hb in enumerate(layout.buckets) if hb.chunk == 1]
    plan = element_plan(layout, elem_ids, y.shape[0], colors, x.device,
                        transpose=transpose, symmetric=symmetric)
    if plan is None:
        return element_fused_apply(tables["element"], x, out=y,
                                   transpose=transpose, symmetric=symmetric,
                                   conj=conj)

    def adjoint_plan():
        return element_plan(layout, elem_ids, x.shape[0], adjoint_colors,
                            x.device, transpose=not transpose,
                            symmetric=False)

    return colored_fused_apply(tables["element"], plan, x, out=y,
                               transpose=transpose, symmetric=symmetric,
                               conj=conj, adjoint_plan=adjoint_plan)


def apply_operand(dev_buckets, layout, out_len: int, x: torch.Tensor, *,
                  transpose: bool = False, conj: bool = False,
                  colors=None, adjoint_colors=None,
                  scatter: str = "atomic") -> torch.Tensor:
    """Apply a bucketed operand: one B1 launch over its chunked buckets and
    one element pass (or the colored element route) over its element
    buckets, into one zeroed output.

    ``dev_buckets``: the layout's :class:`StagedBuckets`.  ``conj``: the
    conjugate of the values (complex; real values are unchanged), so
    ``transpose`` and ``conj`` together apply the adjoint.  ``colors``: the
    color sets (tuple of tuples of block ids) when the operator's schedule
    is "colored" or "auto", else None; ``adjoint_colors`` those of the
    other direction (the transposed product's), for x's cotangent.
    ``scatter``: "atomic" (the element
    pass) or "sorted" (B9's owner mode for the element buckets, no colored
    plan).  ``x`` is of a compute dtype of the values (``fused_spmm.
    COMPUTE_TYPES``), and so is the result.
    """
    shape = (out_len,) if x.ndim == 1 else (out_len, x.shape[1])
    return _add_buckets(dev_buckets, layout, x, x.new_zeros(shape),
                        transpose=transpose, symmetric=False, conj=conj,
                        colors=colors, adjoint_colors=adjoint_colors,
                        scatter=scatter)


def apply_symmetric(diag_buckets, diag_layout, off_buckets, off_layout,
                    n: int, x: torch.Tensor, *, transpose: bool = False,
                    conj: bool = False, diag_colors=None,
                    fused_colors=None) -> torch.Tensor:
    """Symmetric operand S = D + O + O^T (O the stored off-diagonals).

    The off-diagonal pair is transpose-invariant and reads each stored
    block once for both of its contributions (B1's and the element pass's
    symmetric modes); only the diagonal pass honors ``transpose``.  Both
    passes honor ``conj``: S is complex symmetric, so ``S^H = conj(S)`` and
    ``S^H x`` is the diagonal's adjoint plus the off-diagonal pair's
    conjugate.  ``fused_colors`` (union row+col conflicts) and
    ``diag_colors`` drive the colored element route (a diagonal block's
    rows are its columns, so ``diag_colors`` serve both directions).
    """
    y = apply_operand(diag_buckets, diag_layout, n, x, transpose=transpose,
                      conj=conj, colors=diag_colors,
                      adjoint_colors=diag_colors)
    return _add_buckets(off_buckets, off_layout, x, y, transpose=False,
                        symmetric=True, conj=conj, colors=fused_colors)
