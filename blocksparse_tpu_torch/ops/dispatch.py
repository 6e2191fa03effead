"""Per-bucket routing of a bucketed operand to its engine.

Counterpart of ``blocksparse_tpu/ops/dispatch.py``:

  - every chunked (``chunk > 1``) real bucket goes to the chunk-table kernel
    B1 (``ops/kernels/fused_spmm.py``): its CUDA kernel for a CUDA tensor,
    its plain version for a CPU tensor;
  - element buckets (``chunk == 1``) go to the torch-op engine
    (``ops/torch_spmv.bucket_apply``), as the JAX package sent them to XLA.

The JAX package's TPU guards (chunk >= 8, the scalar-memory table cap, bf16
alignment, the on-chip memory budget) have no counterpart here.  Not ported
(ROADMAP): strip/panel routing, the auto policy and its environment knobs.
"""

from __future__ import annotations

import torch

from .kernels.fused_spmm import fused_apply
from .torch_spmv import bucket_apply

__all__ = ["apply_operand", "patch_eligible", "patch_wins"]

# The bucket engines of the JAX package re-stream values per 128-column RHS
# slice, the patch mono-kernel per 256 columns; one bucket launch costs about
# as much as streaming this many bytes.  These are the JAX package's rule
# constants, kept so the flagship routes as it did there (see patch_wins).
_BUCKET_R_SLICE = 128
_PATCH_R_SLICE = 256
_STRIP_TAX = 1.0e6


def patch_eligible(x: torch.Tensor, dtype: torch.dtype) -> bool:
    """Static pre-check for the patch engine: f32 operator and operand."""
    return dtype == torch.float32 and x.dtype == torch.float32


def patch_wins(plan, layouts_reads, r: int = 1) -> bool:
    """Patch SpMM vs the bucket engines: the r > 1 byte rule, verbatim.

    This is the rule measured on the TPU v5e the JAX package was tuned on,
    awaiting measurement on the H100; it is kept so the flagship routes as
    on the TPU.  At r == 1 the patch path is not taken.
    """
    if plan is None or r <= 1:
        return False
    bucket_slices = -(-r // _BUCKET_R_SLICE)
    bucket = sum(
        l.padded_nnz * 4 * rd * bucket_slices
        + _STRIP_TAX * max(len(l.buckets), 1) * bucket_slices
        for l, rd in layouts_reads
    )
    return plan.value_bytes * -(-r // _PATCH_R_SLICE) < 2 * bucket


def apply_operand(dev_buckets, layout, out_len: int, x: torch.Tensor, *,
                  transpose: bool = False) -> torch.Tensor:
    """Apply a bucketed operand with per-bucket routing.

    ``dev_buckets``: per bucket ``(values, row_idx, col_idx, row_chunk,
    col_chunk)`` tensors (the chunk tables are None for element buckets).
    Values are real (float32/float64), so there is no conjugate mode.
    """
    y = None
    elem = []
    for hb, (vals, ridx, cidx, rc, cc) in zip(layout.buckets, dev_buckets):
        if hb.chunk > 1:
            part = fused_apply(vals, rc, cc, hb.chunk, x, out_len,
                               transpose=transpose)
            y = part if y is None else y + part
        else:
            elem.append((vals, ridx, cidx))
    if elem:
        part = bucket_apply(elem, out_len, x, transpose=transpose)
        y = part if y is None else y + part
    if y is None:
        shape = (out_len,) if x.ndim == 1 else (out_len, x.shape[1])
        y = x.new_zeros(shape)
    return y
