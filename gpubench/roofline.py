"""The least time an NVIDIA H100 SXM could take for a product.

Counted from the logical work of the generated blocks, never from the
program's plans or padding, so a share of it reads the same work whatever
kernel carries it.  Each stored value is read once in its stored type, the
operand and the result once each; two operations per real multiply-add
and eight per complex one, on every logical entry (a symmetric operator's
off-diagonal entries twice).  The bound is the larger of the bytes over
the memory bandwidth and the operations over the peak of the tier that
reaches the stated accuracy.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet (dense, no sparsity), at its 700 W limit
HBM_BYTES_PER_S = 3.35e12
TF32_FLOPS_PER_S = 495e12
PEAK_FLOPS = {
    # three TF32 products per product reach float32 accuracy
    "highest": TF32_FLOPS_PER_S / 3,
    "high": TF32_FLOPS_PER_S / 3,
    None: TF32_FLOPS_PER_S,
    "float64": 67e12,
}
ITEM_BYTES = {"float32": 4, "float64": 8, "complex64": 8, "complex128": 16}


def bound_s(nbytes: float, flops: float, tier="highest") -> tuple:
    """``(seconds, "bytes" | "operations")``: the larger of the two times
    and which one it is."""
    by_bytes = nbytes / HBM_BYTES_PER_S
    by_ops = flops / PEAK_FLOPS[tier]
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def product_work(stored_entries: int, logical_entries: int, rows: int,
                 cols: int, r: int, dtype: str) -> tuple:
    """``(bytes, operations)`` of ``A @ X``, ``X`` of ``[cols, r]``: the
    stored values once, ``X`` and the ``[rows, r]`` result once each."""
    item = ITEM_BYTES[dtype]
    nbytes = stored_entries * item + (rows + cols) * r * item
    flops = (8 if dtype.startswith("complex") else 2) * logical_entries * r
    return nbytes, flops


def product_bound(stored_entries: int, logical_entries: int, rows: int,
                  cols: int, r: int, dtype: str, tier="highest") -> tuple:
    return bound_s(*product_work(stored_entries, logical_entries, rows, cols,
                                 r, dtype), tier)
