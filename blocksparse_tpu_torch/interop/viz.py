"""Sparsity visualisation: terminal spy plots.

Counterpart of ``blocksparse_tpu/interop/viz.py``, character for character:
``spy`` renders a density grid of ``|value|`` over the COO triplets of
``rowcolvals`` (host numpy, no device transfer), ``blocksummary`` the
one-line summary, and ``show`` prints both.
"""

from __future__ import annotations

import numpy as np

from .scipy_io import rowcolvals

__all__ = ["spy", "show", "blocksummary"]

_DENSITY = " .:-=+*#%@"


def blocksummary(A) -> str:
    """``"<m>x<n> <type> with <nnz> non-zero entries"`` (the nnz part only
    where ``A`` or the operator it wraps has one)."""
    m, n = A.shape
    nnz = getattr(A, "nnz", None)
    if nnz is None and hasattr(A, "op"):
        nnz = getattr(A.op, "nnz", None)
    base = f"{m}x{n} {type(A).__name__}"
    if nnz is not None:
        base += f" with {nnz} non-zero entries"
    return base


def spy(A, width: int = 64, height: int = 24) -> str:
    """The sparsity pattern as a ``height`` x ``width`` character density
    grid, in a border."""
    m, n = A.shape
    r, c, v = rowcolvals(A)
    grid = np.zeros((height, width), dtype=np.float64)
    if r.size:
        gi = np.clip((np.asarray(r) * height) // max(m, 1), 0,
                     height - 1).astype(int)
        gj = np.clip((np.asarray(c) * width) // max(n, 1), 0,
                     width - 1).astype(int)
        np.add.at(grid, (gi, gj), np.abs(np.asarray(v)))
    mx = grid.max()
    if mx > 0:
        grid = grid / mx
    border = "+" + "-" * width + "+"
    lines = [border]
    for i in range(height):
        row = "".join(
            _DENSITY[min(int(cell * (len(_DENSITY) - 1)
                             + (0 if cell == 0 else 1)), len(_DENSITY) - 1)]
            for cell in grid[i])
        lines.append("|" + row + "|")
    lines.append(border)
    return "\n".join(lines)


def show(A, **kwargs) -> str:
    """Print and return :func:`blocksummary` and :func:`spy` (``kwargs``:
    ``width``, ``height``)."""
    out = blocksummary(A) + "\n" + spy(A, **kwargs)
    print(out)
    return out
