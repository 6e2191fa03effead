"""Colored execution plan: coloring turns scatter-add into dense gathers.

Counterpart of ``blocksparse_tpu/ops/colored.py``.  Within one color the
map (output row -> contribution) is injective, so a color round's
scatter-add can be replaced by its inverse, a dense gather
``y += contrib[src_table]`` with a host-built table.  Under
``schedule="colored"`` the bucket route runs a pass's element buckets as
the colored element route where :func:`colored_wins` holds
(``ops/kernels/mask_select.colored_apply``: one products pass into a
scratch in the plan's flat order, then every color round summed in one
launch of kernel B9's colored rounds, ``csrc/colored_rounds.cu``, race-free
by the colors and without atomics; ``ops/torch_spmv.bucket_apply`` keeps
the per-bucket chain of the JAX engine as the reference).  A wrong coloring
then gives a wrong product, which is what makes the serial vs colored
duality test meaningful.

Host tables are numpy; the plan keeps them on the device as one int32
``[ncolors, out_len]`` tensor, cached per (layout, colors, roles, device),
so a product copies nothing to the device.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

__all__ = ["build_colored_plan", "colored_wins", "plan_tables"]

# Break-even of ncolors dense gathers of out_len rows against one scatter-add
# of n_entries indices: the JAX package's constant, measured on the TPU v5e
# and not yet re-measured on a GPU.
_GAIN = 1.5


def colored_wins(ncolors: int, out_len: int, n_entries: int) -> bool:
    """Cost model: the colored plan only while ``ncolors * out_len`` stays
    within ``_GAIN`` of the scatter's ``n_entries`` (by pigeonhole it is
    never below it)."""
    return ncolors * (out_len + 1) <= _GAIN * max(n_entries, 1)


def plan_tables(layout, colors, out_len: int, transpose: bool,
                bucket_sel, symmetric: bool):
    """Host gather tables for the element buckets ``bucket_sel`` of
    ``layout``: ``(tables, total)``, one int32 [out_len] table per color
    mapping an output row to its position in the flattened concatenation of
    the selected buckets' contributions (``total`` -> an appended zero), or
    None when a selected block is missing from ``colors``.

    ``symmetric``: every block emits a forward contribution (targets = its
    row indices) and a mirror contribution (targets = its col indices); the
    flat layout is all forward parts in bucket order, then all mirror parts.
    ``colors`` must then be the union-conflict sets (``fusedcolors``).
    """
    buckets = [layout.buckets[i] for i in bucket_sel]
    fwd_offsets, off = [], 0
    loc = {}
    for bi, hb in enumerate(buckets):
        fwd_offsets.append(off)
        for j, g in enumerate(hb.block_ids):
            loc[int(g)] = (bi, j)
        off += hb.nblocks * (hb.mp if symmetric or not transpose else hb.kp)
    mir_offsets = []
    if symmetric:
        for hb in buckets:
            mir_offsets.append(off)
            off += hb.nblocks * hb.kp
    total = off

    def place(src, tgt, base):
        valid = tgt < out_len  # drop sentinel-padded lanes
        src[tgt[valid]] = (base + np.nonzero(valid)[0]).astype(np.int32)

    tables = []
    seen = 0
    for color in colors:
        src = np.full(out_len, total, dtype=np.int32)
        touched = False
        for g in color:
            ent = loc.get(int(g))
            if ent is None:
                continue  # the block lives in a chunked bucket
            bi, j = ent
            hb = buckets[bi]
            if symmetric:
                place(src, hb.row_idx[j], fwd_offsets[bi] + j * hb.mp)
                place(src, hb.col_idx[j], mir_offsets[bi] + j * hb.kp)
            else:
                tgt = (hb.col_idx if transpose else hb.row_idx)[j]
                place(src, tgt, fwd_offsets[bi] + j * (hb.kp if transpose
                                                       else hb.mp))
            touched = True
            seen += 1
        if touched:
            tables.append(src)
    if seen < len(loc):
        return None
    return tuple(tables), total


@lru_cache(maxsize=64)
def build_colored_plan(layout, colors, out_len: int, transpose: bool,
                       bucket_sel: tuple[int, ...], symmetric: bool = False,
                       *, device):
    """``(tables, total)`` with the tables as one int32 ``[ncolors,
    out_len]`` tensor on ``device`` (row k: color k's table; the
    ``colored_plan`` of ``mask_select.colored_apply`` and ``bucket_apply``;
    no default: the caller names the operand's device), or None.  Cached:
    the layout is keyed by identity, ``colors`` and ``bucket_sel`` must be
    tuples."""
    plan = plan_tables(layout, colors, out_len, transpose, bucket_sel,
                       symmetric)
    if plan is None:
        return None
    tables, total = plan
    dense = (np.stack(tables) if tables
             else np.zeros((0, out_len), dtype=np.int32))
    return torch.from_numpy(dense).to(device), total
