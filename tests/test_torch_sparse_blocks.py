"""scipy.sparse blocks in the port's constructors, held to the JAX package.

Port counterparts of ``tests/test_sparse_blocks.py``: a scipy block
densifies into the buckets and keeps its stored entry count as its logical
nnz (the reference's ``_nnz`` rule, abstractblockmatrix.jl:65-71) in the
general and symmetric formats, while VBCRS counts dense extents in both
packages.  ``nnz`` and ``blocksummary`` equal the JAX package's, and the
products equal the JAX operator's and a dense float64 oracle's at 1e-13.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import blocksparse_tpu as bst
import blocksparse_tpu_torch as bt

torch.set_num_threads(2)

TOL = 1e-13


def relerr(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape
    return float(np.max(np.abs(a - b))) / max(1.0, float(np.max(np.abs(b))))


def _mixed_blocks():
    """``tests/test_sparse_blocks.py::_mixed_blocks``: a dense block, a CSR
    and a CSC block."""
    rng = np.random.default_rng(0)
    dense = rng.standard_normal((12, 16))
    csr = sp.random(20, 10, density=0.15, format="csr", random_state=3,
                    dtype=np.float64)
    csc = sp.random(8, 24, density=0.3, format="csc", random_state=4,
                    dtype=np.float64)
    return ([dense, csr, csc],
            [np.arange(0, 12), np.arange(40, 60), np.arange(100, 108)],
            [np.arange(10, 26), np.arange(80, 90), np.arange(150, 174)],
            (200, 200))


def _dense(blocks, rows, cols, shape):
    out = np.zeros(shape)
    for b, r, c in zip(blocks, rows, cols):
        out[np.ix_(r, c)] += b.toarray() if hasattr(b, "toarray") else b
    return out


def test_nnz_reference_rule():
    """nnz counts a sparse block's stored entries, as the JAX package's;
    the transpose keeps it; the product and ``block`` as there."""
    blocks, rows, cols, shape = _mixed_blocks()
    A = bt.BlockSparseMatrix(blocks, rows, cols, shape, device="cpu")
    Aj = bst.BlockSparseMatrix(blocks, rows, cols, shape)
    assert A.nnz == Aj.nnz == 12 * 16 + blocks[1].nnz + blocks[2].nnz
    assert A.T.op.nnz == A.nnz
    assert bt.blocksummary(A) == bst.blocksummary(Aj)
    x = np.random.default_rng(5).standard_normal(shape[1])
    y = A @ torch.from_numpy(x)
    assert relerr(y, np.asarray(Aj @ jnp.asarray(x))) < TOL
    assert relerr(y, _dense(blocks, rows, cols, shape) @ x) < TOL
    assert np.abs(A.block(1) - blocks[1].toarray()).max() == 0.0


def test_roadmap_c2_input():
    """The input of the fault: 54 (24 stored + 30), not 110, in both
    packages; the symmetric case 52, not 76."""
    blocks = [sp.random(10, 8, density=0.3, random_state=1, format="csr"),
              np.random.default_rng(0).standard_normal((5, 6))]
    rows, cols = [np.arange(10), np.arange(20, 25)], [np.arange(8),
                                                       np.arange(3, 9)]
    A = bt.BlockSparseMatrix(blocks, rows, cols, (30, 30), device="cpu")
    Aj = bst.BlockSparseMatrix(blocks, rows, cols, (30, 30))
    assert A.nnz == Aj.nnz == 54
    assert bt.blocksummary(A) == bst.blocksummary(Aj)
    d = [np.random.default_rng(1).standard_normal((6, 6))]
    o = [sp.random(4, 5, density=0.4, random_state=3, format="csc")]
    args = (d, [np.arange(6)], o, [np.arange(10, 14)], [np.arange(20, 25)],
            (30, 30))
    S = bt.SymmetricBlockMatrix(*args, device="cpu")
    Sj = bst.SymmetricBlockMatrix(*args)
    assert S.nnz == Sj.nnz == 52
    assert bt.blocksummary(S) == bst.blocksummary(Sj)


def test_symmetric_and_vbcrs_accept_sparse():
    """``tests/test_sparse_blocks.py::test_symmetric_and_vbcrs_accept_sparse``
    in the port: the symmetric format counts a sparse block's entries (an
    off-diagonal twice), VBCRS dense extents; products against the JAX
    operators and the dense oracle."""
    rng = np.random.default_rng(7)
    n = 96
    g1, g2 = np.arange(0, 32), np.arange(32, 96)
    d1 = sp.random(32, 32, density=0.2, format="csr", random_state=1,
                   dtype=np.float64)
    d2 = rng.standard_normal((64, 64))
    o = sp.random(32, 64, density=0.2, format="csr", random_state=2,
                  dtype=np.float64)
    args = ([d1, d2], [g1, g2], [o], [g1], [g2], (n, n))
    S = bt.SymmetricBlockMatrix(*args, device="cpu")
    Sj = bst.SymmetricBlockMatrix(*args)
    assert S.nnz == Sj.nnz == d1.nnz + 64 * 64 + 2 * o.nnz
    assert bt.blocksummary(S) == bst.blocksummary(Sj)
    dense = np.zeros((n, n))
    dense[np.ix_(g1, g1)] += d1.toarray()
    dense[np.ix_(g2, g2)] += d2
    dense[np.ix_(g1, g2)] += o.toarray()
    dense[np.ix_(g2, g1)] += o.toarray().T
    x = rng.standard_normal(n)
    y = S @ torch.from_numpy(x)
    assert relerr(y, np.asarray(Sj @ jnp.asarray(x))) < TOL
    assert relerr(y, dense @ x) < TOL

    B = sp.random(32, 64, density=0.25, format="csr", random_state=9,
                  dtype=np.float64)
    V = bt.VariableBlockCompressedRowStorage([B], [0], [32], (n, n),
                                             device="cpu")
    Vj = bst.VariableBlockCompressedRowStorage([B], [0], [32], (n, n))
    assert V.nnz == Vj.nnz == 32 * 64
    assert bt.blocksummary(V) == bst.blocksummary(Vj)
    xv = rng.standard_normal(n)
    dv = np.zeros((n, n))
    dv[0:32, 32:96] = B.toarray()
    yv = V @ torch.from_numpy(xv)
    assert relerr(yv, np.asarray(Vj @ jnp.asarray(xv))) < TOL
    assert relerr(yv, dv @ xv) < TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sparse_blocks_in_f32_and_bf16_storage(dtype):
    """A float32 or bf16 operator built from scipy blocks keeps their
    stored counts; bf16 rounds the stored entries and nothing else."""
    blocks, rows, cols, shape = _mixed_blocks()
    blocks = [b.astype(np.float32) for b in blocks]
    A = bt.BlockSparseMatrix(blocks, rows, cols, shape, device="cpu",
                             dtype=getattr(torch, dtype))
    assert A.nnz == 12 * 16 + blocks[1].nnz + blocks[2].nnz
    rounded = (torch.from_numpy(blocks[1].toarray()).to(torch.bfloat16)
               .float().numpy() if dtype == "bfloat16"
               else blocks[1].toarray())
    assert np.array_equal(A.block(1), rounded)
