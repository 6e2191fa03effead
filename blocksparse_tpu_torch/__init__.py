"""blocksparse_tpu_torch: the PyTorch / CUDA port of blocksparse_tpu.

The first slice of the port: the general :class:`BlockSparseMatrix` and its
lazy operator algebra (``@``, ``.T``, ``.H``, ``axpby``, composition) on
torch tensors, with the block products running in two hand-written CUDA
kernels for Hopper (``csrc/``): the chunk-table kernel (SpMV and SpMM of
chunked buckets) and the merged-patch SpMM kernel (f32, r > 1).  On CPU
tensors the same routes run the kernels' plain PyTorch versions.

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
from .core.schedule import SERIAL, isserial
from .formats.block_sparse import BlockSparseMatrix
from .interop.convert import from_reference
from .interop.scipy_io import rowcolvals, to_scipy

__version__ = "0.1.0"

__all__ = [
    "BlockSparseMatrix",
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
    "isserial",
    "rowcolvals",
    "to_scipy",
    "from_reference",
]
