"""Carry an operator of the JAX package across into the port.

``from_reference(A)`` is duck-typed: it reads ``A.shape``, ``A.nblocks``,
``A.block(i)``, ``A.blockrowindices(i)`` and ``A.blockcolindices(i)``,
which a JAX ``BlockSparseMatrix`` answers from host numpy, and builds the
port's operator from the same numpy blocks.  This module imports neither
jax nor the JAX package.
"""

from __future__ import annotations

from ..formats.block_sparse import BlockSparseMatrix

__all__ = ["from_reference"]


def from_reference(A, **kwargs) -> BlockSparseMatrix:
    """The port's ``BlockSparseMatrix`` holding ``A``'s blocks and index
    lists; ``kwargs`` (``device``, ``dtype``, ``precision``, ...) go to its
    constructor."""
    n = A.nblocks
    return BlockSparseMatrix(
        [A.block(i) for i in range(n)],
        [A.blockrowindices(i) for i in range(n)],
        [A.blockcolindices(i) for i in range(n)],
        tuple(A.shape),
        **kwargs,
    )
