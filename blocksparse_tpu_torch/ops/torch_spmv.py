"""Plain PyTorch engines: gather -> batched einsum -> scatter-add.

Counterpart of ``blocksparse_tpu/ops/xla_spmv.py``, on tensors.  These are
the reference-semantics paths: ``bucket_apply`` serves element buckets
(arbitrary index lists) on every device, and ``chunked_bucket_apply`` is the
plain version of the chunk-table kernel (``ops/kernels/fused_spmm.py``).

Sentinel convention (``core/layout.py``): a gathered row index at or past
the operand's length reads zero (the appended row ``x_ext[N]``), and a
scattered row index at or past ``out_len`` lands in the dropped slot
``y[M]``.  The chunked engine applies the same rule to the rows its chunk
tables name, so merged row windows that run past the last row need no
padded buffers.

The bucket route (``ops/dispatch.py``) runs the element buckets of a layout
in one launch of B9's element pass (``ops/kernels/mask_select.
element_apply``; its plain version is the per-bucket gather -> einsum ->
scatter-add chain of ``bucket_apply``) and its chunked buckets in one
multi-bucket launch of B1 (the port of the JAX engine's
``chunked_multi_apply`` chain).  Element buckets under a colored plan run
the colored element route (``ops/kernels/mask_select.colored_apply``: a
products pass, then every color round in one launch of B9's colored
rounds); ``bucket_apply(colored_plan=...)`` keeps the JAX engine's
per-bucket chain (a gather, an einsum per bucket, a concatenation, one
gather and one add per color) as the reference those are held to, and with
``mask_gs=True`` sends the gathers and scatter-adds of an f32 SpMV through
B9's one-call kernels (``mask_gather`` / ``mask_scatter_add``), as the JAX
engine sent them to its mask-select kernels: the route as it ran before
the rounds, timed beside them on the card.  The sorted-segment scatter (``scatter="sorted"``) is
B9's owner mode (``ops/kernels/mask_select.owner_apply``), whose plain
version is a segment sum over the same tables.

Values may be stored in a narrower type than the operand's (bf16 with a
float32 or float64 operand, float32 with float64, complex64 with
complex128): these engines widen them to the operand's dtype
(:func:`widened`) before the product, as the kernels do in registers.
"""

from __future__ import annotations

import torch

__all__ = ["bucket_apply", "chunked_bucket_apply", "chunk_rows",
           "gather_rows", "scatter_rows", "values_grad", "widened"]


def widened(vals: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``vals`` in the compute ``dtype`` (exact: every stored type the
    formats keep is a subset of its compute types)."""
    return vals if vals.dtype == dtype else vals.to(dtype)


def chunk_rows(table: torch.Tensor, chunk: int) -> torch.Tensor:
    """[nb, e] chunk ids -> [nb, e * chunk] element row ids (int64)."""
    nb, e = table.shape
    off = torch.arange(chunk, device=table.device)
    return (table.long()[:, :, None] * chunk + off).reshape(nb, e * chunk)


def gather_rows(mat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """mat[idx] for [n, r] ``mat``; indices >= n read zero (sentinel row)."""
    n = mat.shape[0]
    ext = torch.cat([mat, mat.new_zeros((1,) + mat.shape[1:])])
    return ext[idx.long().clamp(max=n)]


def scatter_rows(out_len: int, idx: torch.Tensor,
                 upd: torch.Tensor) -> torch.Tensor:
    """y = zeros(out_len, r); y[idx] += upd, rows >= out_len dropped."""
    r = upd.shape[-1]
    acc = upd.new_zeros((out_len + 1, r))
    acc.index_add_(0, idx.reshape(-1).long().clamp(max=out_len),
                   upd.reshape(-1, r))
    return acc[:out_len]


def values_grad(g: torch.Tensor, x: torch.Tensor, rows: torch.Tensor,
                cols: torch.Tensor, *, transpose: bool = False,
                symmetric: bool = False, conj: bool = False) -> torch.Tensor:
    """Cotangent of a bucket's values ([nb, mp, kp]) for the output
    cotangent ``g`` of its product with ``x``; ``rows`` / ``cols``: the
    bucket's element row and column ids ([nb, mp] / [nb, kp], sentinels
    read zero).  Exact: the outer products of the gathered rows, in
    torch's complex convention: ``y = V x`` gives ``g x^H``, ``y = V^T x``
    its transpose, and a product with ``conj(V)`` (``conj``) the conjugate
    of the same product's."""
    gm = g[:, None] if g.ndim == 1 else g
    xm = (x[:, None] if x.ndim == 1 else x).conj()

    def outer(a, rows_of_a, b):
        return torch.einsum("bmr,bkr->bmk", gather_rows(a, rows_of_a),
                            gather_rows(b, cols))

    if symmetric:
        dv = outer(gm, rows, xm) + outer(xm, rows, gm)
    elif transpose:
        dv = outer(xm, rows, gm)
    else:
        dv = outer(gm, rows, xm)
    return dv.conj_physical() if conj else dv


def bucket_apply(buckets, out_len: int, x: torch.Tensor, *,
                 transpose: bool = False, symmetric: bool = False,
                 conj: bool = False, colored_plan=None,
                 mask_gs: bool = False) -> torch.Tensor:
    """Apply element buckets ``(values, row_idx, col_idx)`` to x ([n] or [n, r]).

    In transpose mode the two index tables swap roles and each block's values
    are used transposed -- a flag flip, no data movement.  ``conj`` uses
    each block's conjugate (complex values; real ones are unchanged).

    ``symmetric``: each block adds its forward contribution into its rows
    and its transposed contribution ``V^T x[rows]`` into its columns, from
    the same values (the one-read pass over the stored off-diagonals);
    needs ``out_len == x.shape[0]``, and ``transpose`` is ignored (the pair
    is transpose-invariant).

    ``colored_plan``: ``(tables, total)`` from ``ops/colored.py``.  The
    scatter-adds are replaced by one dense gather per color over the
    flattened contributions -- all forward parts, then (symmetric) all
    mirror parts, the order the tables assume.

    ``mask_gs``: for an f32 SpMV (r == 1), every gather and scatter-add goes
    through kernel B9 (its plain version for CPU tensors); otherwise, and
    when False, they are torch indexing ops.
    """
    vec = x.ndim == 1
    xm = x[:, None] if vec else x
    r = xm.shape[1]
    transpose = transpose and not symmetric
    mask = mask_gs and r == 1 and xm.dtype == torch.float32
    if mask:
        from .kernels.mask_select import gather_apply, scatter_apply

    def gather(idx):
        if mask:
            return gather_apply(xm[:, 0], idx)[..., None]
        return gather_rows(xm, idx)

    def scatter(idx, upd):
        if mask:
            return scatter_apply(upd.reshape(-1), idx.reshape(-1),
                                 out_len)[:, None]
        return scatter_rows(out_len, idx, upd)

    y = xm.new_zeros((out_len, r))
    fwd, mirror = [], []
    for vals, ridx, cidx in buckets:
        vals = widened(vals, xm.dtype)
        if conj:
            vals = vals.conj()
        if transpose:
            yp = torch.einsum("bmk,bmr->bkr", vals, gather(ridx))
            fwd.append((cidx, yp))
        else:
            yp = torch.einsum("bmk,bkr->bmr", vals, gather(cidx))
            fwd.append((ridx, yp))
        if symmetric:
            yt = torch.einsum("bmk,bmr->bkr", vals, gather(ridx))
            mirror.append((cidx, yt))
    parts = fwd + mirror
    if colored_plan is None:
        for idx, upd in parts:
            y = y + scatter(idx, upd)
        return y[:, 0] if vec else y
    tables, _total = colored_plan
    contrib = torch.cat([upd.reshape(-1, r) for _, upd in parts]
                        + [xm.new_zeros((1, r))])
    for t in tables:
        y = y + contrib[t]
    return y[:, 0] if vec else y


def chunked_bucket_apply(vals, row_chunk_idx, col_chunk_idx, chunk: int,
                         out_len: int, x: torch.Tensor, *,
                         transpose: bool = False, symmetric: bool = False,
                         conj: bool = False) -> torch.Tensor:
    """Chunk-granular engine: blocks stored offset-shifted onto whole
    C-aligned chunks of x and y (``core/layout.py`` Bucket docstring).

    forward    y[row chunks] += V @ x[col chunks]
    transpose  y[col chunks] += V^T @ x[row chunks]
    symmetric  both of the above from one read of V (``transpose`` False).

    ``conj`` puts conj(V) in place of V in each.
    """
    if symmetric and transpose:
        raise ValueError(
            "symmetric fused pass is transpose-invariant; use transpose=False")
    vals = widened(vals, x.dtype)
    if conj:
        vals = vals.conj()
    vec = x.ndim == 1
    xm = x[:, None] if vec else x
    rows = chunk_rows(row_chunk_idx, chunk)
    cols = chunk_rows(col_chunk_idx, chunk)
    if transpose:
        yp = torch.einsum("bmk,bmr->bkr", vals, gather_rows(xm, rows))
        y = scatter_rows(out_len, cols, yp)
    else:
        yp = torch.einsum("bmk,bkr->bmr", vals, gather_rows(xm, cols))
        y = scatter_rows(out_len, rows, yp)
    if symmetric:
        yt = torch.einsum("bmk,bmr->bkr", vals, gather_rows(xm, rows))
        y = y + scatter_rows(out_len, cols, yt)
    return y[:, 0] if vec else y
