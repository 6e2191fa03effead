"""blocksparse_tpu_torch: the PyTorch / CUDA port of blocksparse_tpu.

The general :class:`BlockSparseMatrix`, the half-stored
:class:`SymmetricBlockMatrix` and the CSR-of-blocks
:class:`VariableBlockCompressedRowStorage`, with their lazy operator
algebra (``@``, ``.T``, ``.H``, ``axpby``, composition) on torch tensors,
DSATUR coloring and the colored gather-round plan.  The block products run
in hand-written CUDA kernels for Hopper (``csrc/``): the chunk-table kernel
(SpMV and SpMM of chunked buckets, plain or symmetric), the merged-patch
SpMM kernel (f32, r > 1) and its symmetric counterpart, the element gather
and scatter-add, and the one-launch stream SpMV kernels over panel and slab
plans (f32, r = 1), and the batched products of P same-structure operators
in one launch (:func:`batched_mm`, :func:`batched_mv`).  The Krylov
solvers :func:`cg`, :func:`bicgstab` and :func:`gmres` and the
preconditioners :func:`jacobi` and :func:`block_jacobi` run on the
operator's device, and :func:`as_linear_operator` hands an operator to
``scipy.sparse.linalg``.  Operators live on
the card unless the caller passes ``device="cpu"``; on CPU tensors the same
routes run the kernels' plain PyTorch versions.

The JAX package ``blocksparse_tpu`` is the reference; this package imports
neither it nor jax.
"""

from .api import (
    block,
    colindices,
    colors,
    eachblockindex,
    nnz,
    rowindices,
    transposecolors,
)
from .core.layout import BlockLayout, build_layout
from .core.operator import (
    AdjointOperator,
    ComposedOperator,
    ConjOperator,
    LinearOperator,
    ScaledOperator,
    SumOperator,
    TransposeOperator,
)
from .core.schedule import COLORED, SERIAL, isserial
from .formats.block_sparse import BlockSparseMatrix
from .formats.symmetric import SymmetricBlockMatrix
from .formats.vbcrs import VariableBlockCompressedRowStorage
from .interop.convert import from_reference
from .ops.batched import batched_mm, batched_mv
from .interop.scipy_io import (
    as_linear_operator,
    from_dense,
    from_scipy_blocks,
    rowcolvals,
    sparse,
    to_scipy,
)
from .precond import DiagonalOperator, block_jacobi, jacobi
from .solvers import SolveInfo, bicgstab, cg, gmres

__version__ = "0.1.0"

__all__ = [
    "BlockSparseMatrix",
    "SymmetricBlockMatrix",
    "VariableBlockCompressedRowStorage",
    "rowindices",
    "colindices",
    "eachblockindex",
    "block",
    "nnz",
    "colors",
    "transposecolors",
    "LinearOperator",
    "AdjointOperator",
    "TransposeOperator",
    "ConjOperator",
    "ScaledOperator",
    "SumOperator",
    "ComposedOperator",
    "BlockLayout",
    "build_layout",
    "SERIAL",
    "COLORED",
    "isserial",
    "rowcolvals",
    "to_scipy",
    "from_reference",
    "batched_mm",
    "batched_mv",
    "sparse",
    "from_dense",
    "from_scipy_blocks",
    "as_linear_operator",
    "cg",
    "bicgstab",
    "gmres",
    "SolveInfo",
    "jacobi",
    "block_jacobi",
    "DiagonalOperator",
]
