"""Element gather, scatter-add and element pass: CUDA kernel B9, plain
versions, autograd.

The kernels (``csrc/mask_select.cu``) replace
``blocksparse_tpu/ops/pallas/mask_select.py::_gather_kernel`` and
``::_scatter_kernel``: the gather ``out = x[idx]`` and the scatter-add
``y[idx] += v`` of the element engine, i.e. products of element buckets
(``chunk == 1``, arbitrary index lists).

- :func:`element_apply`: the bucket route's element pass
  (``ops/dispatch.py``), every element bucket of a layout in one launch
  over a :class:`~.fused_spmm.BucketTable`, f32, f64, complex64 and
  complex128, forward, transpose or symmetric (``V @ x[cols]`` into
  ``y[rows]``, ``V^T @ x[rows]`` into ``y[cols]``, or both from one read
  of V), each also with ``conj`` (complex: ``conj(V)`` in place of V),
  adding into a given output; at r = 1 on the body
  ``fused_spmm.r1_body`` picks for the pair (the row-stream body,
  ``csrc/row_stream.cuh``, entry ``bst_element_pass_rows_<pair>``, or the
  tile core).  Its plain version, :func:`element_apply_plain`, is the
  per-bucket gather -> einsum -> scatter-add chain
  (:func:`mask_gather_plain` / :func:`mask_scatter_add_plain` on vectors).
- :func:`colored_apply`: the colored element route, the element buckets of
  a pass under a colored plan (``schedule="colored"`` where
  ``ops/colored.colored_wins`` holds), every stored / compute pair and r,
  forward, transpose or symmetric, with ``conj``.  Two launches, at r > 1
  three on the symmetric pass: the products pass of the owner mode
  (``bst_element_owner_products_*``; at r = 1 the one-read kernel
  ``bst_colored_products_r1_*`` of ``csrc/colored_rounds.cu``, one launch
  also on the symmetric pass) writes every (block, row) product into a
  scratch ``[total, r]`` in the plan's flat order (on the symmetric pass
  the forward parts, then the mirror parts at their offsets,
  :func:`scratch_offsets`), then one launch of the rounds
  (``csrc/colored_rounds.cu``, ``bst_colored_rounds_<compute>``) adds,
  for every output row, its color rounds' scratch rows summed in color
  order into ``out``, one write per entry, no atomics.  It replaces the
  JAX engine's colored chain, which gathered with the mask-select kernel
  per bucket (and scattered with it in its backward).  Its plain version,
  :func:`colored_apply_plain`, is those two passes in the same layout and
  order (:func:`colored_products_plain`, :func:`colored_rounds_plain`).
- :func:`mask_gather` / :func:`mask_scatter_add`: one gather or one
  scatter-add of f32 vectors (f32 only, as the TPU kernels).  No product
  route calls them; ``ops/torch_spmv.bucket_apply(mask_gs=True)``, the
  colored route as it ran before the rounds, does.
- :func:`owner_apply`: the owner mode, the element pass of an operator
  built with ``scatter="sorted"`` (forward or transpose, with ``conj``):
  the port of the JAX engine's sort + sorted-segment-sum scatter.  Its
  tables (:class:`OwnerTable`, built on the host from
  :func:`sorted_scatter_info`, the numpy counterpart of the JAX
  ``_sorted_scatter_info``, and kept on the :class:`~.fused_spmm.
  BucketTable`) list, per output row, the contributions (bucket, entry) in
  the JAX order, and each one's flat row in the scratch of products.
  Every owned row is written once, no atomics, every sum in a fixed order,
  so the result is bit-identical from run to run.  Two launches
  (``csrc/owner_pass.cu``, :func:`owner_two_pass`): the products of every
  (block, row) into a scratch ``[rows of every block, r]`` that the
  wrapper allocates (``bst_element_owner_products_*``, the element pass's
  tile core writing instead of adding), then each owned row's sum of its
  scratch rows in list order (``bst_element_owner_sum_*``).  Its plain
  version, :func:`owner_apply_plain`, is those two passes in the same
  layout and order (:func:`owner_products_plain`,
  :func:`owner_sum_plain`).

The element pass and the owner mode take the stored / compute dtype pairs
of B1 (``fused_spmm.COMPUTE_TYPES``: values widened in registers, ``x`` and
``out`` of the compute dtype).

Sentinel convention (``core/layout.py``): an index at or past ``n`` gathers
0, and one at or past ``out_len`` scatters nowhere.

Race-freedom: indices repeat, so the scatter-add and the element pass add
into a zeroed output (the scatter's allocated here with ``torch.zeros``;
the element pass's given, possibly holding the partial sum of the launches
before it) with fp32/fp64 ``atomicAdd`` (a complex value as two, one per
part); the summation order varies from run to run.

Routing: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises.  ``GATHER_LAUNCHES``, ``SCATTER_LAUNCHES``,
``ELEMENT_LAUNCHES`` and ``OWNER_LAUNCHES`` count kernel launches (the
owner mode's each pass), ``COLORED_LAUNCHES`` the colored route's products
launches and ``ROUNDS_LAUNCHES`` its rounds launches,
``ELEMENT_SYM_LAUNCHES`` the element passes in
the symmetric mode, ``ELEMENT_ROW_LAUNCHES`` those on the row-stream body
(``fused_spmm.ENTRY_LAUNCHES`` counts the element pass and the owner mode
by entry point too).  :func:`gather_apply` and
:func:`scatter_apply` add autograd (each is the other's adjoint, so a
backward pass runs the other kernel), :func:`element_fused_apply` too (its
x cotangent is the element pass in the transposed mode with the conj flag
flipped; the symmetric mode is its own transpose), and
:func:`colored_fused_apply` (x's cotangent the colored route of the
transposed pass where its plan wins, else the element pass transposed;
the symmetric pass its own colored route with the conj flag flipped).
"""

from __future__ import annotations

import numpy as np
import torch

from ...utils import build
from ..torch_spmv import gather_rows, scatter_rows, widened
from .fused_spmm import (ENTRY_LAUNCHES, BucketTable, TableApply,
                         check_table_call, entry_point, launch_mode,
                         FMA_PREFIXES, fma_launch, launch_table)

__all__ = ["ColoredLaunch", "colored_apply", "colored_apply_plain",
           "colored_fused_apply", "colored_products_plain", "colored_rounds",
           "colored_rounds_plain", "check_colored_plan", "scratch_offsets",
           "element_apply", "element_apply_plain", "element_fused_apply",
           "mask_gather", "mask_gather_plain", "mask_scatter_add",
           "mask_scatter_add_plain", "gather_apply", "scatter_apply",
           "OwnerTable", "owner_apply", "owner_apply_plain",
           "owner_fused_apply", "owner_products", "owner_products_plain",
           "owner_sum", "owner_sum_plain", "owner_two_pass",
           "owner_table", "sorted_scatter_info",
           "COLORED_LAUNCHES", "ELEMENT_LAUNCHES", "ELEMENT_ROW_LAUNCHES",
           "ELEMENT_SYM_LAUNCHES", "GATHER_LAUNCHES", "OWNER_LAUNCHES",
           "ROUNDS_LAUNCHES", "SCATTER_LAUNCHES"]

GATHER_LAUNCHES = 0
SCATTER_LAUNCHES = 0
ELEMENT_LAUNCHES = 0
ELEMENT_SYM_LAUNCHES = 0
ELEMENT_ROW_LAUNCHES = 0
OWNER_LAUNCHES = 0
COLORED_LAUNCHES = 0
ROUNDS_LAUNCHES = 0
_R1_TILE_ROWS = 64  # rows of a work item of bst_colored_products_r1_*



def mask_gather_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of the gather: ``x[idx]`` (shape of ``idx``), indices
    >= n read 0."""
    return gather_rows(x[:, None], idx)[..., 0]


def mask_scatter_add_plain(v: torch.Tensor, idx: torch.Tensor,
                           out_len: int) -> torch.Tensor:
    """Plain version of the scatter-add: ``y = zeros(out_len); y[idx] += v``,
    indices >= out_len dropped."""
    return scatter_rows(out_len, idx, v.reshape(-1, 1))[:, 0]


def _check(vec: torch.Tensor, idx: torch.Tensor, name: str,
           numel: int | None = None) -> None:
    if vec.ndim != 1:
        raise ValueError(f"{name} must be 1-D, got {tuple(vec.shape)}")
    if numel is not None and numel != vec.numel():
        raise ValueError(f"{name} has {vec.numel()} elements, indices {numel}")
    if vec.device != idx.device:
        raise ValueError(
            f"tensors on different devices: {vec.device}, {idx.device}")


def _cuda_check(vec: torch.Tensor, idx: torch.Tensor) -> None:
    if vec.device.type != "cuda":
        raise ValueError(f"no kernel for device {vec.device}")
    if vec.dtype != torch.float32:
        raise TypeError(f"mask_select kernels take float32, got {vec.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"indices must be int32, got {idx.dtype}")


def mask_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out = x[idx]`` (shape of ``idx``) for a 1-D ``x``; indices >= n
    read 0."""
    global GATHER_LAUNCHES
    _check(x, idx, "x")
    if x.device.type == "cpu":
        return mask_gather_plain(x, idx)
    _cuda_check(x, idx)
    x, flat = x.contiguous(), idx.contiguous()
    out = torch.empty(idx.shape, dtype=x.dtype, device=x.device)
    if flat.numel():
        build.launch("bst_mask_gather_f32", x.device, x.data_ptr(),
                     x.shape[0], flat.data_ptr(), flat.numel(),
                     out.data_ptr())
        GATHER_LAUNCHES += 1
    return out


def mask_scatter_add(v: torch.Tensor, idx: torch.Tensor,
                     out_len: int) -> torch.Tensor:
    """``y = zeros(out_len); y[idx] += v`` for 1-D ``v`` and ``idx`` of as
    many elements; indices >= out_len dropped."""
    global SCATTER_LAUNCHES
    _check(v, idx, "v", numel=idx.numel())
    if v.device.type == "cpu":
        return mask_scatter_add_plain(v, idx, out_len)
    _cuda_check(v, idx)
    v, flat = v.contiguous(), idx.contiguous()
    y = torch.zeros(out_len, dtype=v.dtype, device=v.device)
    if flat.numel() and out_len:
        build.launch("bst_mask_scatter_add_f32", v.device, v.data_ptr(),
                     flat.data_ptr(), flat.numel(), y.data_ptr(), out_len)
        SCATTER_LAUNCHES += 1
    return y


class _Gather(torch.autograd.Function):
    """d(x[idx]) / dx is the scatter-add of the cotangent."""

    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.n = x.shape[0]
        return mask_gather(x, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        dx = None
        if ctx.needs_input_grad[0]:
            dx = _Scatter.apply(g.reshape(-1), idx.reshape(-1), ctx.n)
        return dx, None


class _Scatter(torch.autograd.Function):
    """d(scatter-add of v) / dv is the gather of the cotangent."""

    @staticmethod
    def forward(ctx, v, idx, out_len):
        ctx.save_for_backward(idx)
        return mask_scatter_add(v, idx, out_len)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        dv = None
        if ctx.needs_input_grad[0]:
            dv = _Gather.apply(g.contiguous(), idx)
        return dv, None, None


def gather_apply(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """:func:`mask_gather` with autograd."""
    return _Gather.apply(x, idx)


def scatter_apply(v: torch.Tensor, idx: torch.Tensor,
                  out_len: int) -> torch.Tensor:
    """:func:`mask_scatter_add` with autograd."""
    return _Scatter.apply(v, idx, out_len)


def element_apply_plain(table: BucketTable, x: torch.Tensor, *, out,
                        transpose: bool = False, symmetric: bool = False,
                        conj: bool = False) -> torch.Tensor:
    """Plain version of the element pass: per bucket, gather -> einsum ->
    scatter-add into ``out`` in place (the element engine's chain, through
    :func:`mask_gather_plain` / :func:`mask_scatter_add_plain` for a vector
    ``x``), with ``conj(V)`` under ``conj``; returns ``out``."""
    out_len = out.shape[0]
    vec = x.ndim == 1

    def gather(idx):
        return mask_gather_plain(x, idx)[..., None] if vec \
            else gather_rows(x, idx)

    def scatter(idx, upd):
        if vec:
            return mask_scatter_add_plain(upd.reshape(-1), idx.reshape(-1),
                                          out_len)
        return scatter_rows(out_len, idx, upd)

    for vals, ridx, cidx, _chunk in table.buckets:
        vals = widened(vals, x.dtype)
        if conj:
            vals = vals.conj()
        if transpose:
            out += scatter(cidx, torch.einsum("bmk,bmr->bkr", vals,
                                              gather(ridx)))
        else:
            out += scatter(ridx, torch.einsum("bmk,bkr->bmr", vals,
                                              gather(cidx)))
        if symmetric:
            out += scatter(cidx, torch.einsum("bmk,bmr->bkr", vals,
                                              gather(ridx)))
    return out


def element_apply(table: BucketTable, x: torch.Tensor, *, out,
                  transpose: bool = False, symmetric: bool = False,
                  conj: bool = False) -> torch.Tensor:
    """Add every element bucket of ``table`` (chunk 1: element index
    tables) applied to ``x`` ([n] or [n, r]) into ``out`` ([out_len] or
    [out_len, r]) in one launch (at r = 1 on the body
    ``fused_spmm.r1_body`` picks); returns ``out``.  ``conj``: the buckets'
    conjugates (nothing changes for real values)."""
    global ELEMENT_LAUNCHES, ELEMENT_SYM_LAUNCHES, ELEMENT_ROW_LAUNCHES
    conj = conj and table.dtype.is_complex
    mode = launch_mode(transpose, symmetric, conj)
    if any(b[3] != 1 for b in table.buckets):
        raise ValueError("the element pass takes element buckets (chunk 1)")
    check_table_call(table, x, out, symmetric)
    if x.device.type == "cpu":
        return element_apply_plain(table, x, out=out, transpose=transpose,
                                   symmetric=symmetric, conj=conj)
    rows = fma_launch("B9", table.dtype, x.dtype,
                      1 if x.ndim == 1 else x.shape[1])[1]
    if launch_table(FMA_PREFIXES["B9"][rows], table, x, out, mode,
                    rows=rows):
        ELEMENT_LAUNCHES += 1
        ELEMENT_SYM_LAUNCHES += symmetric
        ELEMENT_ROW_LAUNCHES += rows
    return out


def element_fused_apply(table: BucketTable, x: torch.Tensor, *, out,
                        transpose: bool = False, symmetric: bool = False,
                        conj: bool = False) -> torch.Tensor:
    """:func:`element_apply` with autograd (in ``x``, ``out`` and the
    table's values; x's cotangent is the element pass in the transposed
    mode with the conj flag flipped)."""
    return TableApply.apply(out, x, table, element_apply, None, transpose,
                            symmetric, conj, *table.values)


# -- the owner mode (scatter="sorted") -----------------------------------------


def sorted_scatter_info(targets) -> list:
    """Per bucket, ``(perm, sorted_targets)`` as int32 numpy: ``perm`` the
    stable argsort of the bucket's flattened targets ([nb, extent] element
    indices: the row table forward, the column table transposed) and
    ``sorted_targets`` the targets in that order.  The numpy counterpart of
    the JAX package's ``ops/dispatch.py::_sorted_scatter_info``."""
    info = []
    for t in targets:
        flat = np.asarray(t).reshape(-1)
        perm = np.argsort(flat, kind="stable")
        info.append((perm.astype(np.int32), flat[perm].astype(np.int32)))
    return info


class OwnerTable:
    """The owner mode's tables for one direction of a :class:`BucketTable`
    and one output length, on the table's device: ``rows`` (int32
    [n_rows]) the output rows any bucket reaches (sentinel targets,
    ``>= out_len``, are dropped), ``ptr`` (int64 [n_rows + 1]) the offsets
    of their contributions in ``ent`` (int32 [nnz, 2]: bucket, entry, where
    entry is ``b * mp + i`` forward and ``b * kp + k`` transposed).  A row's
    contributions run bucket by bucket in table order and, inside a bucket,
    in the order of :func:`sorted_scatter_info`'s permutation: the JAX
    sorted scatter's order.  ``offsets`` (int64 [n buckets]) is each
    bucket's first row in the scratch of products, which holds every
    bucket's ``[nb * extent]`` rows in table order (``p_rows`` in all;
    extent ``mp`` forward, ``kp`` transposed), and ``flat`` (int64 [nnz])
    each contribution's row there, ``offsets[bucket] + entry``.
    ``lengths`` (int64 [n_rows]) serves the plain version."""

    def __init__(self, table: BucketTable, transpose: bool, out_len: int):
        targets = [(c if transpose else r).cpu().numpy()
                   for _v, r, c, _chunk in table.buckets]
        tgt, bucket, entry = [], [], []
        for q, (perm, srt) in enumerate(sorted_scatter_info(targets)):
            keep = (srt >= 0) & (srt < out_len)
            tgt.append(srt[keep])
            entry.append(perm[keep])
            bucket.append(np.full(int(keep.sum()), q, dtype=np.int32))
        tgt = np.concatenate(tgt) if tgt else np.zeros(0, np.int32)
        # stable: buckets stay in table order, each in its sorted order
        order = np.argsort(tgt, kind="stable")
        tgt = tgt[order]
        ent = np.stack([np.concatenate(bucket)[order],
                        np.concatenate(entry)[order]], axis=1) if len(order) \
            else np.zeros((0, 2), np.int32)
        rows, starts = np.unique(tgt, return_index=True)
        ptr = np.append(starts, len(tgt)).astype(np.int64)
        extents = [v.shape[0] * v.shape[2 if transpose else 1]
                   for v, *_ in table.buckets]
        offsets = np.cumsum([0] + extents[:-1]).astype(np.int64)
        flat = offsets[ent[:, 0]] + ent[:, 1].astype(np.int64)
        dev = table.device
        self.rows = torch.from_numpy(rows.astype(np.int32)).to(dev)
        self.ptr = torch.from_numpy(ptr).to(dev)
        self.ent = torch.from_numpy(np.ascontiguousarray(ent, np.int32)).to(dev)
        self.flat = torch.from_numpy(flat).to(dev)
        self.lengths = torch.from_numpy(np.diff(ptr)).to(dev)
        self.offsets = torch.from_numpy(offsets).to(dev)
        self.p_rows = int(sum(extents))

    @property
    def n_rows(self) -> int:
        return int(self.rows.shape[0])


def owner_table(table: BucketTable, transpose: bool, out_len: int
                ) -> OwnerTable:
    """The :class:`OwnerTable` of ``table`` for this direction and output
    length, built on the host at first use and kept on the table."""
    key = (bool(transpose), int(out_len))
    if key not in table.owners:
        table.owners[key] = OwnerTable(table, transpose, out_len)
    return table.owners[key]


def owner_products_plain(table: BucketTable, x: torch.Tensor, *,
                         transpose: bool = False,
                         conj: bool = False) -> torch.Tensor:
    """Plain version of the owner mode's products pass: the scratch
    ``[p_rows, r]`` of :class:`OwnerTable`'s layout, every bucket's
    products (values widened to ``x``'s dtype; ``conj(V)`` under
    ``conj``), row ``offsets[bucket] + b * mp + i`` holding ``(V_b @
    x[col_idx_b])[i]`` (transposed: ``b * kp + k``, ``(V_b^T @
    x[row_idx_b])[k]``)."""
    xm = x[:, None] if x.ndim == 1 else x
    parts = []
    for vals, ridx, cidx, _chunk in table.buckets:
        vals = widened(vals, xm.dtype)
        if conj:
            vals = vals.conj()
        if transpose:
            yp = torch.einsum("bmk,bmr->bkr", vals, gather_rows(xm, ridx))
        else:
            yp = torch.einsum("bmk,bkr->bmr", vals, gather_rows(xm, cidx))
        parts.append(yp.reshape(-1, xm.shape[1]))
    return torch.cat(parts)


def owner_sum_plain(own: OwnerTable, P: torch.Tensor, *, out) -> torch.Tensor:
    """Plain version of the owner mode's sum pass: each owned row's
    scratch rows ``P[flat]`` summed in list order from zero, as the kernel
    does, then added into its row of ``out`` ([out_len] or [out_len, r])
    once, in place; returns ``out``."""
    if not own.n_rows:
        return out
    om = out[:, None] if out.ndim == 1 else out
    sums = P.new_zeros((own.n_rows, P.shape[1]))
    starts, lengths = own.ptr[:-1], own.lengths
    for j in range(int(lengths.max())):
        live = lengths > j
        sums[live] = sums[live] + P[own.flat[starts[live] + j]]
    om.index_add_(0, own.rows.long(), sums)  # rows are unique: one add each
    return out


def owner_apply_plain(table: BucketTable, x: torch.Tensor, *, out,
                      transpose: bool = False, symmetric: bool = False,
                      conj: bool = False) -> torch.Tensor:
    """Plain version of the owner mode on the same tables: the products
    pass into the scratch, then the sum pass into ``out`` in place
    (:func:`owner_products_plain`, :func:`owner_sum_plain`); returns
    ``out``."""
    if symmetric:
        raise ValueError("the owner mode has no symmetric mode")
    own = owner_table(table, transpose, out.shape[0])
    P = owner_products_plain(table, x, transpose=transpose, conj=conj)
    return owner_sum_plain(own, P, out=out)


def owner_apply(table: BucketTable, x: torch.Tensor, *, out,
                transpose: bool = False, symmetric: bool = False,
                conj: bool = False) -> torch.Tensor:
    """Add every element bucket of ``table`` applied to ``x`` ([n] or [n,
    r]) into ``out`` ([out_len] or [out_len, r]) in the owner mode's two
    launches; returns ``out``.  Forward or ``transpose``, with ``conj``
    (the buckets' conjugates); there is no symmetric mode, as the JAX
    sorted scatter has none."""
    if symmetric:
        raise ValueError("the owner mode has no symmetric mode")
    conj = conj and table.dtype.is_complex
    mode = launch_mode(transpose, False, conj)
    if any(b[3] != 1 for b in table.buckets):
        raise ValueError("the owner mode takes element buckets (chunk 1)")
    check_table_call(table, x, out, False)
    if x.device.type == "cpu":
        return owner_apply_plain(table, x, out=out, transpose=transpose,
                                 conj=conj)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    own = owner_table(table, transpose, out.shape[0])
    if not (own.n_rows and (x.ndim == 1 or x.shape[1])):
        return out
    return owner_two_pass(table, own, x.resolve_conj().contiguous(), out,
                          mode, transpose)


def _products_launch(table: BucketTable, offsets, xm, P, mode: int,
                     transpose: bool) -> None:
    """One launch of the products pass (``csrc/owner_pass.cu``; CUDA
    tensors, checked by the caller): every (block, row) product of ``xm``
    ([n, r]) in this direction written into the scratch ``P`` at bucket
    q's first row ``offsets[q]`` (int64 [n buckets] on the card)."""
    name = entry_point("bst_element_owner_products", table.dtype, xm.dtype)
    build.launch(name, xm.device, table.table.data_ptr(), len(table),
                 table.items[transpose], offsets.data_ptr(), xm.data_ptr(),
                 P.data_ptr(), P.shape[1], xm.shape[0], P.shape[0], mode)
    ENTRY_LAUNCHES[name] += 1


def owner_products(table: BucketTable, own: OwnerTable, xm, P, mode: int,
                   transpose: bool) -> torch.Tensor:
    """The owner mode's first launch (CUDA tensors, checked by the caller):
    every (block, row) product of ``xm`` ([n, r]) into the scratch ``P``
    ([own.p_rows, r], written); returns ``P``."""
    global OWNER_LAUNCHES
    _products_launch(table, own.offsets, xm, P, mode, transpose)
    OWNER_LAUNCHES += 1
    return P


def owner_sum(own: OwnerTable, P, out) -> torch.Tensor:
    """The owner mode's second launch: each owned row of ``out`` plus its
    scratch rows of ``P`` in list order, written once; returns ``out``."""
    global OWNER_LAUNCHES
    name = entry_point("bst_element_owner_sum", P.dtype)
    build.launch(name, P.device, own.rows.data_ptr(), own.ptr.data_ptr(),
                 own.flat.data_ptr(), own.n_rows, P.data_ptr(),
                 out.data_ptr(), P.shape[1], out.shape[0])
    ENTRY_LAUNCHES[name] += 1
    OWNER_LAUNCHES += 1
    return out


def owner_two_pass(table: BucketTable, own: OwnerTable, xm, out, mode: int,
                   transpose: bool) -> torch.Tensor:
    """Both launches of the owner mode, through a scratch allocated
    here."""
    r = 1 if xm.ndim == 1 else xm.shape[1]
    P = torch.empty((own.p_rows, r), dtype=xm.dtype, device=xm.device)
    owner_products(table, own, xm, P, mode, transpose)
    return owner_sum(own, P, out)


def owner_fused_apply(table: BucketTable, x: torch.Tensor, *, out,
                      transpose: bool = False,
                      conj: bool = False) -> torch.Tensor:
    """:func:`owner_apply` with autograd (x's cotangent is the owner mode in
    the other direction with the conj flag flipped)."""
    return TableApply.apply(out, x, table, owner_apply, None, transpose,
                            False, conj, *table.values)


# -- the colored element route (schedule="colored") ----------------------------


def scratch_offsets(table: BucketTable, transpose: bool,
                    base: int = 0) -> torch.Tensor:
    """int64 [n buckets] on the table's device: each bucket's first row in
    a scratch that holds, from row ``base``, every bucket's ``nb *
    extent`` product rows in table order (extent ``mp`` forward, ``kp``
    transposed); built at first use and kept on the table."""
    key = (bool(transpose), int(base))
    if key not in table.offsets:
        extents = [v.shape[0] * v.shape[2 if transpose else 1]
                   for v, *_ in table.buckets]
        starts = np.cumsum([base] + extents[:-1]).astype(np.int64)
        table.offsets[key] = torch.from_numpy(starts).to(table.device)
    return table.offsets[key]


def _r1_workspace(table: BucketTable) -> tuple:
    """The one-read products kernel's tables, built at first use and kept
    on the table: ``(owner, ifirst, bstart, woff, w_elems)``: int32
    [items] each work item's bucket (an item: a stored block's 64-row
    tile, buckets in table order), int64 [n buckets] each bucket's first
    item, its first stored block and its first element of the workspace of
    tile partials (blocks of more than one tile: nb * tiles * kp
    elements), and the workspace's length."""
    if "r1" not in table.offsets:
        nbs, tiles, sizes = [], [], []
        for v in table.values:
            nb, mp, kp = v.shape
            tiles.append(nb * -(-mp // _R1_TILE_ROWS))
            nbs.append(nb)
            sizes.append(tiles[-1] * kp if mp > _R1_TILE_ROWS else 0)
        dev = table.device
        starts = lambda a: torch.from_numpy(np.cumsum(
            [0] + a[:-1]).astype(np.int64)).to(dev)
        owner = np.repeat(np.arange(len(tiles), dtype=np.int32), tiles)
        table.offsets["r1"] = (torch.from_numpy(owner).to(dev),
                               starts(tiles), starts(nbs), starts(sizes),
                               sum(sizes))
    return table.offsets["r1"]


def _products_r1(table: BucketTable, xm, P, conj_bit: int, transpose: bool,
                 symmetric: bool) -> None:
    """The colored route's products at r = 1 in one launch of
    ``bst_colored_products_r1_*`` (CUDA tensors, checked by the caller):
    the parts of :func:`_scratch_parts` from one read of every block,
    through a workspace of tile partials and zeroed counters (one per
    stored block) allocated here."""
    offsets = {tr: scratch_offsets(table, tr, base)
               for tr, base in _scratch_parts(table, transpose, symmetric)}
    fwd = offsets.get(False, offsets.get(True))
    mir = offsets.get(True, fwd)
    owner, ifirst, bstart, woff, w_elems = _r1_workspace(table)
    if symmetric or transpose:
        W = torch.empty(max(w_elems, 1), dtype=xm.dtype, device=xm.device)
        cnt = torch.zeros(sum(v.shape[0] for v in table.values),
                          dtype=torch.int32, device=xm.device)
    else:  # no transposed parts: the kernel reads neither
        W = torch.empty(1, dtype=xm.dtype, device=xm.device)
        cnt = torch.empty(1, dtype=torch.int32, device=xm.device)
    name = entry_point("bst_colored_products_r1", table.dtype, xm.dtype)
    build.launch(name, xm.device, table.table.data_ptr(), len(table),
                 owner.numel(), owner.data_ptr(), ifirst.data_ptr(),
                 bstart.data_ptr(), fwd.data_ptr(), mir.data_ptr(),
                 woff.data_ptr(), W.data_ptr(), cnt.data_ptr(), xm.data_ptr(),
                 xm.shape[0], P.data_ptr(),
                 (2 if symmetric else int(transpose)) | conj_bit)
    ENTRY_LAUNCHES[name] += 1


def _scratch_parts(table: BucketTable, transpose: bool, symmetric: bool):
    """``(transpose, first row)`` of each products launch of a colored pass,
    in the plan's flat order (``ops/colored.py::plan_tables``): the
    forward parts (transposed parts in a transposed pass), then on the
    symmetric pass the mirror parts ``V^T @ x[row_idx]`` after them."""
    if not symmetric:
        return ((transpose, 0),)
    return ((False, 0), (True, sum(v.shape[0] * v.shape[1]
                                   for v in table.values)))


def check_colored_plan(table: BucketTable, plan, out, transpose: bool,
                       symmetric: bool) -> None:
    """Raise where ``plan`` (``(tables, total)``) does not fit ``table``'s
    pass into ``out``."""
    tables, total = plan
    want = sum(v.shape[0] * v.shape[2 if transpose and not symmetric else 1]
               + (v.shape[0] * v.shape[2] if symmetric else 0)
               for v in table.values)
    if total != want:
        raise ValueError(f"colored plan of {total} contribution rows for a "
                         f"pass of {want}")
    if tables.ndim != 2 or tables.shape[1] != out.shape[0]:
        raise ValueError(f"colored tables {tuple(tables.shape)} do not match "
                         f"out_len {out.shape[0]}")
    if tables.dtype != torch.int32 or not tables.is_contiguous():
        raise TypeError("colored tables must be contiguous int32")
    if tables.device != out.device:
        raise ValueError(f"colored tables on {tables.device}, out on "
                         f"{out.device}")


def colored_products_plain(table: BucketTable, x: torch.Tensor, *,
                           transpose: bool = False, symmetric: bool = False,
                           conj: bool = False) -> torch.Tensor:
    """Plain version of the colored route's products pass: the scratch
    ``[total, r]`` in the plan's flat order (:func:`owner_products_plain`
    per part of :func:`_scratch_parts`)."""
    return torch.cat([owner_products_plain(table, x, transpose=tr, conj=conj)
                      for tr, _ in _scratch_parts(table, transpose,
                                                  symmetric)])


def colored_rounds_plain(plan, P: torch.Tensor, *, out) -> torch.Tensor:
    """Plain version of the rounds: per row, its color rounds' rows of
    ``P`` (the sentinel ``total`` reads 0) summed in color order from zero,
    then added into ``out`` ([out_len] or [out_len, r]) once, in place;
    returns ``out``."""
    tables, _total = plan
    om = out[:, None] if out.ndim == 1 else out
    ext = torch.cat([P, P.new_zeros((1, P.shape[1]))])
    acc = P.new_zeros(om.shape)
    for t in tables:
        acc = acc + ext[t.long()]
    om += acc
    return out


def colored_apply_plain(table: BucketTable, plan, x: torch.Tensor, *, out,
                        transpose: bool = False, symmetric: bool = False,
                        conj: bool = False) -> torch.Tensor:
    """Plain version of the colored route on the same tables: the products
    pass into the scratch, then the rounds into ``out`` in place
    (:func:`colored_products_plain`, :func:`colored_rounds_plain`)."""
    P = colored_products_plain(table, x, transpose=transpose,
                               symmetric=symmetric, conj=conj)
    return colored_rounds_plain(plan, P, out=out)


def colored_rounds(plan, P: torch.Tensor, out) -> torch.Tensor:
    """The rounds launch (``csrc/colored_rounds.cu``; CUDA tensors, checked
    by the caller): ``out`` plus every color round of ``plan`` over the
    scratch ``P`` ([total, r]), one write per entry; returns ``out``."""
    global ROUNDS_LAUNCHES
    tables, total = plan
    name = entry_point("bst_colored_rounds", P.dtype)
    build.launch(name, P.device, tables.data_ptr(), tables.shape[0],
                 out.shape[0], total, P.data_ptr(), out.data_ptr(),
                 P.shape[1])
    ROUNDS_LAUNCHES += 1
    return out


def colored_apply(table: BucketTable, plan, x: torch.Tensor, *, out,
                  transpose: bool = False, symmetric: bool = False,
                  conj: bool = False) -> torch.Tensor:
    """Add every element bucket of ``table`` applied to ``x`` ([n] or [n,
    r]) into ``out`` ([out_len] or [out_len, r]) through the colored plan
    ``plan`` (``ops/colored.build_colored_plan``: ``(tables, total)``, the
    tables int32 ``[ncolors, out_len]`` on the card); returns ``out``.

    Forward, ``transpose`` or ``symmetric`` (both contributions of every
    block), each with ``conj``; every stored / compute pair of
    ``fused_spmm.COMPUTE_TYPES`` and every r.  Launches: the products pass
    into a scratch ``[total, r]`` allocated here, then one launch of the
    rounds (:func:`colored_rounds`).  The products pass: at r = 1 one
    launch of ``bst_colored_products_r1_*`` (both parts of the symmetric
    pass from one read of the values; faster than the owner mode's
    products pass at r = 1 on the H100, ``chip_smoke.py`` phase 4), at r >
    1 the owner mode's products pass, one launch per direction (two on
    the symmetric pass: the forward parts, then the mirror parts at their
    offsets).  No
    atomics: the pass's sum is the same bits on every run.  (The chunked
    buckets of the same operand still add through B1's atomics before
    this pass, so a product is bit-identical from run to run only where
    the operand has no chunked buckets.)"""
    global COLORED_LAUNCHES
    conj = conj and table.dtype.is_complex
    launch_mode(transpose, symmetric)  # raises on transpose and symmetric
    conj_bit = launch_mode(False, False, conj)
    if any(b[3] != 1 for b in table.buckets):
        raise ValueError("the colored route takes element buckets (chunk 1)")
    check_table_call(table, x, out, symmetric)
    check_colored_plan(table, plan, out, transpose, symmetric)
    if x.device.type == "cpu":
        return colored_apply_plain(table, plan, x, out=out,
                                   transpose=transpose, symmetric=symmetric,
                                   conj=conj)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    xm = x.resolve_conj().contiguous()
    xm = xm[:, None] if xm.ndim == 1 else xm
    tables, total = plan
    if not (xm.shape[1] and out.shape[0] and tables.shape[0] and total):
        return out
    P = torch.empty((total, xm.shape[1]), dtype=x.dtype, device=x.device)
    if xm.shape[1] == 1:
        _products_r1(table, xm, P, conj_bit, transpose, symmetric)
        COLORED_LAUNCHES += 1
    else:
        for tr, base in _scratch_parts(table, transpose, symmetric):
            _products_launch(table, scratch_offsets(table, tr, base), xm, P,
                             conj_bit | int(tr), tr)
            COLORED_LAUNCHES += 1
    return colored_rounds(plan, P, out)


class ColoredLaunch:
    """:func:`colored_apply` over one plan as a ``TableApply`` launch;
    ``plan`` may be a callable that gives the plan at the first call, and
    where the plan is None the launch is the element pass
    (:func:`element_apply`)."""

    def __init__(self, plan):
        self.plan = plan

    def __call__(self, table, x, *, out, transpose, symmetric, conj):
        if callable(self.plan):
            self.plan = self.plan()
        if self.plan is None:
            return element_apply(table, x, out=out, transpose=transpose,
                                 symmetric=symmetric, conj=conj)
        return colored_apply(table, self.plan, x, out=out, transpose=transpose,
                             symmetric=symmetric, conj=conj)


def colored_fused_apply(table: BucketTable, plan, x: torch.Tensor, *, out,
                        transpose: bool = False, symmetric: bool = False,
                        conj: bool = False,
                        adjoint_plan=None) -> torch.Tensor:
    """:func:`colored_apply` with autograd (in ``x``, ``out`` and the
    table's values).  ``adjoint_plan``: a callable giving the colored plan
    of the transposed pass (or None), asked at the first backward; x's
    cotangent runs that plan, or the element pass in the transposed mode
    where there is none; on the symmetric pass, this same plan (the pass
    is its own transpose; ``TableApply`` flips the conj flag)."""
    launch = ColoredLaunch(plan)
    adjoint = launch if symmetric else ColoredLaunch(adjoint_plan)
    return TableApply.apply(out, x, table, launch, adjoint, transpose,
                            symmetric, conj, *table.values)
