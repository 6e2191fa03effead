"""The port's operator methods and scipy entry points on the CPU.

``apply`` / ``adjoint`` / ``transpose`` / ``matvec_closure`` (the methods
the solvers call) and ``sparse`` / ``from_dense`` / ``from_scipy_blocks``
/ ``as_linear_operator`` (``tests/test_scipy_lo.py`` case by case), each
held to the JAX package (``backend="xla"``, x64) on the same numpy inputs
from a seed and to scipy, at 1e-13 relative to max(1, max|ref|) unless a
case says otherwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import blocksparse_tpu as bst
import blocksparse_tpu_torch as bt
from blocksparse_tpu_torch.utils.testmatrices import (random_block_sparse,
                                                      random_symmetric)

torch.set_num_threads(2)

TOL = 1e-13


def relerr(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(1.0, float(np.max(np.abs(b))) if b.size else 1.0)
    return float(np.max(np.abs(a - b))) / scale


def build(seed=21, shape=(200, 160)):
    blocks, rows, cols, shp = random_block_sparse(
        seed, shape=shape, nblocks=20, max_block=30, dtype=np.float64)
    return (bst.BlockSparseMatrix(blocks, rows, cols, shp, backend="xla"),
            bt.BlockSparseMatrix(blocks, rows, cols, shp, device="cpu"))


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("conj", [False, True])
@pytest.mark.parametrize("r", [1, 3])
def test_apply_mode_flags(transpose, conj, r):
    Aj, Ap = build()
    S = bst.to_scipy(Aj)
    S = S.T if transpose else S
    S = S.conj() if conj else S
    rng = np.random.default_rng(5)
    n = Ap.shape[0] if transpose else Ap.shape[1]
    x = rng.standard_normal(n if r == 1 else (n, r))
    got = Ap.apply(x, transpose=transpose, conj=conj)  # numpy in: a CPU tensor
    assert isinstance(got, torch.Tensor)
    want = np.asarray(Aj.apply(jnp.asarray(x), transpose=transpose, conj=conj))
    assert relerr(got.numpy(), want) < TOL
    assert relerr(got.numpy(), S @ x) < TOL


def test_adjoint_and_transpose_are_the_wrappers():
    Aj, Ap = build()
    assert isinstance(Ap.transpose(), bt.TransposeOperator)
    assert isinstance(Ap.adjoint(), bt.AdjointOperator)
    assert Ap.transpose().transpose() is Ap and Ap.adjoint().adjoint() is Ap
    assert Ap.transpose().shape == (160, 200)
    y = np.random.default_rng(6).standard_normal(200)
    for got, want in ((Ap.transpose() @ y, Aj.transpose() @ jnp.asarray(y)),
                      (Ap.adjoint() @ y, Aj.adjoint() @ jnp.asarray(y))):
        assert relerr(got.numpy(), np.asarray(want)) < TOL


def test_matvec_closure_in_a_solver():
    """``test_operator.py::test_solver_integration``: the closure plugs into
    a Krylov solver as a plain callable (here the port's CG, there
    ``jax.scipy``'s); both closures agree."""
    n = 120
    blocks, rows, cols, shp = random_block_sparse(
        31, shape=(n, n), nblocks=10, max_block=20, dtype=np.float64)
    Ap = bt.BlockSparseMatrix(blocks, rows, cols, shp, device="cpu")
    Aj = bst.BlockSparseMatrix(blocks, rows, cols, shp, backend="xla")
    op = (Ap @ Ap.T).matvec_closure()
    b = np.random.default_rng(32).standard_normal(n)
    bt_ = torch.from_numpy(b)
    assert relerr(op(bt_).numpy(),
                  np.asarray((Aj @ Aj.T).matvec_closure()(jnp.asarray(b)))) < TOL
    x, info = bt.cg(lambda v: op(v) + 10.0 * v, bt_, tol=1e-12, maxiter=500)
    assert bool(info.converged)
    assert relerr(op(x).numpy() + 10.0 * x.numpy(), b) < 1e-8


def test_linear_operator_roundtrip():
    blocks, rows, cols, shape = random_block_sparse(
        3, shape=(300, 260), nblocks=25, dtype=np.float64)
    A = bt.BlockSparseMatrix(blocks, rows, cols, shape, device="cpu")
    L = bt.as_linear_operator(A)
    Lj = bst.as_linear_operator(
        bst.BlockSparseMatrix(blocks, rows, cols, shape, backend="xla"))
    assert L.shape == shape and L.dtype == np.float64
    S = bt.to_scipy(A)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape[1])
    y = rng.standard_normal(shape[0])
    X = rng.standard_normal((shape[1], 3))
    Y = rng.standard_normal((shape[0], 2))
    for got, want, ref in ((L.matvec(x), Lj.matvec(x), S @ x),
                           (L.rmatvec(y), Lj.rmatvec(y), S.conj().T @ y),
                           (L.matmat(X), Lj.matmat(X), S @ X),
                           (L.rmatmat(Y), Lj.rmatmat(Y), S.conj().T @ Y)):
        assert isinstance(got, np.ndarray) and got.flags.writeable
        assert relerr(got, ref) < 1e-10
        assert relerr(got, want) < TOL
    # an operand of another dtype comes out promoted, as the JAX package's
    x32 = x.astype(np.float32)
    got = L.matvec(x32)
    assert got.dtype == np.float64
    assert relerr(got, Lj.matvec(x32)) < TOL


def test_linear_operator_in_scipy_solver():
    from scipy.sparse.linalg import gmres

    d, di, o, ri, ci, shape = random_symmetric(
        5, n=220, ngroups=8, noffdiag=10, dtype=np.float64, contiguous=True)
    d = [b + np.eye(b.shape[0]) * 50 for b in d]
    Sy = bt.SymmetricBlockMatrix(d, di, o, ri, ci, shape, device="cpu")
    Sj = bst.SymmetricBlockMatrix(d, di, o, ri, ci, shape, backend="xla")
    b = np.random.default_rng(1).standard_normal(shape[0])
    x, info = gmres(bt.as_linear_operator(Sy), b, rtol=1e-10, maxiter=500)
    xj, infoj = gmres(bst.as_linear_operator(Sj), b, rtol=1e-10, maxiter=500)
    assert info == 0 == infoj
    assert np.abs((Sy @ torch.from_numpy(x)).numpy() - b).max() < 1e-6
    assert relerr(x, xj) < 1e-10


def test_sparse_is_to_scipy():
    Aj, Ap = build()
    assert bt.sparse is bt.to_scipy
    assert abs(bt.sparse(Ap) - bst.sparse(Aj)).max() < TOL


@pytest.mark.parametrize("block_size", [16, (24, 10)])
def test_from_dense_tiles_like_the_jax_package(block_size):
    rng = np.random.default_rng(40)
    D = rng.standard_normal((70, 50))
    D[:24] = 0.0  # whole tile rows dropped
    D[30:40, 10:20] = 1e-9  # tiles dropped only under tol
    for tol in (0.0, 1e-6):
        A = bt.from_dense(D, block_size, tol=tol, device="cpu")
        Aj = bst.from_dense(D, block_size, tol=tol)
        assert A.nblocks == Aj.nblocks and A.device == torch.device("cpu")
        for i in range(A.nblocks):
            assert np.array_equal(A.blockrowindices(i), Aj.blockrowindices(i))
            assert np.array_equal(A.blockcolindices(i), Aj.blockcolindices(i))
        assert relerr(bt.to_scipy(A).toarray(), bst.to_scipy(Aj).toarray()) == 0
    A32 = bt.from_dense(D, block_size, dtype=np.float32, device="cpu")
    assert A32.dtype == torch.float32
    with pytest.raises(ValueError, match="positive"):
        bt.from_dense(D, 0, device="cpu")


def test_from_scipy_blocks_tiles_like_the_jax_package():
    S = sp.random(90, 70, density=0.03, random_state=41, format="csr")
    A = bt.from_scipy_blocks(S, (16, 32), device="cpu", schedule="colored")
    Aj = bst.from_scipy_blocks(S, (16, 32))
    assert A.nblocks == Aj.nblocks and A.schedule == "colored"
    assert relerr(bt.to_scipy(A).toarray(), S.toarray()) == 0
    x = np.random.default_rng(42).standard_normal(70)
    assert relerr((A @ x).numpy(), np.asarray(Aj @ jnp.asarray(x))) < TOL


def test_constructors_default_to_the_card():
    """Without ``device=`` the tiling constructors build on the card, as the
    formats do; with no card present that raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bt.from_dense(np.eye(8), 4)


def test_from_reference_carries_complex_operators():
    """Complex JAX operators of all three formats and a JAX
    ``ComplexSplitOperator`` carried across: the port's products equal the
    JAX ones."""
    from blocksparse_tpu.utils.testmatrices import random_vbcrs

    rng = np.random.default_rng(50)
    blocks, rows, cols, shape = random_block_sparse(
        51, shape=(180, 150), nblocks=14, max_block=30, dtype=np.complex128)
    d, di, o, ri, ci, sshape = random_symmetric(
        52, n=200, ngroups=8, noffdiag=10, dtype=np.complex64)
    vb, rs, cs, vshape = random_vbcrs(53, shape=(160, 160), nrowgroups=6,
                                      ncolgroups=6, dtype=np.complex128)
    bsm = bst.BlockSparseMatrix(blocks, rows, cols, shape, backend="xla")
    cases = [
        (bsm, bt.BlockSparseMatrix, torch.complex128, TOL),
        (bst.SymmetricBlockMatrix(d, di, o, ri, ci, sshape, backend="xla"),
         bt.SymmetricBlockMatrix, torch.complex64, 1e-5),
        (bst.VariableBlockCompressedRowStorage(vb, rs, cs, vshape,
                                               backend="xla"),
         bt.VariableBlockCompressedRowStorage, torch.complex128, TOL),
        (bst.split_complex(bsm), bt.ComplexSplitOperator, torch.complex128,
         TOL),
    ]
    for J, cls, dtype, tol in cases:
        P = bt.from_reference(J, device="cpu")
        assert type(P) is cls and P.dtype == dtype
        m, n = P.shape
        npdt = np.complex64 if dtype == torch.complex64 else np.complex128
        x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(npdt)
        y = (rng.standard_normal(m) + 1j * rng.standard_normal(m)).astype(npdt)
        for got, want in ((P @ torch.from_numpy(x), J @ jnp.asarray(x)),
                          (P.H @ torch.from_numpy(y), J.H @ jnp.asarray(y)),
                          (P.conj() @ torch.from_numpy(x),
                           J.conj() @ jnp.asarray(x))):
            assert relerr(got.numpy(), np.asarray(want)) < tol


def test_complex_to_scipy_from_dense_and_linear_operator():
    rng = np.random.default_rng(54)
    D = rng.standard_normal((70, 50)) + 1j * rng.standard_normal((70, 50))
    D[:24] = 0.0
    A = bt.from_dense(D, 16, device="cpu")
    Aj = bst.from_dense(D, 16)
    assert A.dtype == torch.complex128 and A.nblocks == Aj.nblocks
    S = bt.to_scipy(A)
    assert S.dtype == np.complex128
    assert relerr(S.toarray(), D) == 0
    assert relerr(S.toarray(), bst.to_scipy(Aj).toarray()) == 0
    A64 = bt.from_dense(D, (24, 10), dtype=np.complex64, device="cpu")
    assert A64.dtype == torch.complex64
    B = bt.from_scipy_blocks(sp.csr_array(D), (16, 32), device="cpu")
    assert B.dtype == torch.complex128
    assert relerr(bt.sparse(B).toarray(), D) == 0
    L = bt.as_linear_operator(A)
    assert L.dtype == np.complex128
    x = rng.standard_normal(50) + 1j * rng.standard_normal(50)
    y = rng.standard_normal(70) + 1j * rng.standard_normal(70)
    assert relerr(L.matvec(x), D @ x) < TOL
    assert relerr(L.rmatvec(y), D.conj().T @ y) < TOL
