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

Not ported yet (ROADMAP): the mask-select gather/scatter, the colored
gather-round plan, the sorted-segment scatter and the one-hot multi-bucket
chain of the JAX engine.
"""

from __future__ import annotations

import torch

__all__ = ["bucket_apply", "chunked_bucket_apply", "chunk_rows",
           "gather_rows", "scatter_rows"]


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


def bucket_apply(buckets, out_len: int, x: torch.Tensor, *,
                 transpose: bool = False) -> torch.Tensor:
    """Apply element buckets ``(values, row_idx, col_idx)`` to x ([n] or [n, r]).

    In transpose mode the two index tables swap roles and each block's values
    are used transposed -- a flag flip, no data movement.
    """
    vec = x.ndim == 1
    xm = x[:, None] if vec else x
    y = xm.new_zeros((out_len, xm.shape[1]))
    for vals, ridx, cidx in buckets:
        if transpose:
            yp = torch.einsum("bmk,bmr->bkr", vals, gather_rows(xm, ridx))
            y = y + scatter_rows(out_len, cidx, yp)
        else:
            yp = torch.einsum("bmk,bkr->bmr", vals, gather_rows(xm, cidx))
            y = y + scatter_rows(out_len, ridx, yp)
    return y[:, 0] if vec else y


def chunked_bucket_apply(vals, row_chunk_idx, col_chunk_idx, chunk: int,
                         out_len: int, x: torch.Tensor, *,
                         transpose: bool = False,
                         symmetric: bool = False) -> torch.Tensor:
    """Chunk-granular engine: blocks stored offset-shifted onto whole
    C-aligned chunks of x and y (``core/layout.py`` Bucket docstring).

    forward    y[row chunks] += V @ x[col chunks]
    transpose  y[col chunks] += V^T @ x[row chunks]
    symmetric  both of the above from one read of V (``transpose`` False).
    """
    if symmetric and transpose:
        raise ValueError(
            "symmetric fused pass is transpose-invariant; use transpose=False")
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
