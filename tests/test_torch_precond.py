"""The port's preconditioners on the CPU: port vs JAX package vs dense math.

Each case of ``tests/test_precond.py`` runs on the same numpy inputs from
a seed through the JAX package (``backend="xla"``, x64) and the port
(``device="cpu"``).  ``M @ x`` of the port's ``jacobi`` / ``block_jacobi``
agrees with the JAX one within 1e-13 relative (to max(1, max|ref|)) and
with the case's dense oracle.  The slice as a whole: ``block_jacobi`` +
``cg`` / ``gmres`` on an SPD ``random_symmetric`` operator built in both
packages, the JAX preconditioner also carried across with
``from_reference``; iterations equal, x within 1e-10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import blocksparse_tpu as bst
import blocksparse_tpu_torch as bt
from blocksparse_tpu_torch.utils import testmatrices as tm

torch.set_num_threads(2)

TOL = 1e-12
PORT_TOL = 1e-13


def relerr(a, b):
    a = np.asarray(a, dtype=np.complex128)
    b = np.asarray(b, dtype=np.complex128)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b))) / max(1.0, float(np.max(np.abs(b))))


def pair(cls, *args, **kw):
    """(JAX operator, port operator) of one format on the same blocks."""
    return (getattr(bst, cls)(*args, backend="xla", **kw),
            getattr(bt, cls)(*args, device="cpu", **kw))


def applied(Mj, Mp, x):
    """``M @ x`` of both preconditioners, held to each other."""
    got = (Mp @ torch.from_numpy(x)).numpy()
    assert relerr(got, np.asarray(Mj @ jnp.asarray(x))) < PORT_TOL
    return got


def spd_symmetric(seed=0, n=600, ngroups=24, noffdiag=24):
    """``test_precond.py::_spd_symmetric``: random symmetric + dominant
    diagonal blocks, as (JAX, port) operators and the rng."""
    rng = np.random.default_rng(seed)
    d, di, o, ri, ci, shape = tm.random_symmetric(
        seed, n=n, ngroups=ngroups, noffdiag=noffdiag, dtype=np.float64)
    d = [b @ b.T + (b.shape[0] + 50.0) * np.eye(b.shape[0]) for b in d]
    return pair("SymmetricBlockMatrix", d, di, o, ri, ci, shape) + (rng,)


@pytest.mark.parametrize("dtype", [np.complex128, np.float64])
def test_diagonal_operator_algebra(dtype):
    rng = np.random.default_rng(1)

    def draw(*shape):
        v = rng.standard_normal(shape)
        return v + 1j * rng.standard_normal(shape) if dtype == np.complex128 else v

    d = draw(50)
    D = bt.DiagonalOperator(torch.from_numpy(d))
    Dj = bst.DiagonalOperator(jnp.asarray(d))
    assert D.shape == (50, 50) and D.dtype == torch.from_numpy(d).dtype
    assert D.device == torch.device("cpu")
    x = draw(50)
    xt = torch.from_numpy(x)
    for op, opj, want in ((D, Dj, d * x), (D.T, Dj.T, d * x),
                          (D.H, Dj.H, np.conj(d) * x)):
        got = (op @ xt).numpy()
        assert relerr(got, want) < TOL
        assert relerr(got, np.asarray(opj @ jnp.asarray(x))) < PORT_TOL
    X = rng.standard_normal((50, 3))
    got = (D @ torch.from_numpy(X)).numpy()
    assert relerr(got, d[:, None] * X) < TOL
    assert relerr(got, np.asarray(Dj @ jnp.asarray(X))) < PORT_TOL


def test_jacobi_matches_dense_diagonal():
    blocks, rows, cols, shape = tm.random_block_sparse(
        2, nblocks=40, dtype=np.float64)
    Aj, Ap = pair("BlockSparseMatrix", blocks, rows, cols, shape)
    M = bt.jacobi(Ap)
    assert isinstance(M, bt.DiagonalOperator) and M.device == Ap.device
    d = np.asarray(bst.to_scipy(Aj).todense()).diagonal()
    expect = np.where(d != 0, np.divide(1.0, d, where=d != 0), 1.0)
    x = np.random.default_rng(3).standard_normal(shape[0])
    assert relerr(applied(bst.jacobi(Aj), M, x), expect * x) < TOL


def test_block_jacobi_exact_on_block_diagonal_matrix():
    """On a purely block-diagonal matrix, block-Jacobi IS the inverse."""
    rng = np.random.default_rng(4)
    blocks, rows, cols = [], [], []
    start = 0
    for w in (8, 16, 12, 24):
        blocks.append(rng.standard_normal((w, w)) + w * np.eye(w))
        idx = np.arange(start, start + w)
        rows.append(idx)
        cols.append(idx)
        start += w
    n = start
    Aj, Ap = pair("BlockSparseMatrix", blocks, rows, cols, (n, n))
    M = bt.block_jacobi(Ap)
    assert isinstance(M, bt.BlockSparseMatrix)  # fully covered: no fallback
    assert M.device == Ap.device and M.dtype == Ap.dtype
    x = rng.standard_normal(n)
    y = applied(bst.block_jacobi(Aj), M, (Ap @ torch.from_numpy(x)).numpy())
    assert np.max(np.abs(y - x)) < 1e-9


def test_block_jacobi_includes_overlapping_contributions():
    """The block-diagonal is sliced from the ASSEMBLED matrix, so overlap
    from non-diagonal blocks lands in the preconditioner."""
    rng = np.random.default_rng(5)
    idx = np.arange(0, 10)
    diag = rng.standard_normal((10, 10)) + 20 * np.eye(10)
    extra = rng.standard_normal((5, 5))
    Aj, Ap = pair("BlockSparseMatrix", [diag, extra],
                  [idx, np.arange(5, 10)], [idx, np.arange(5, 10)], (12, 12))
    dense = np.asarray(bst.to_scipy(Aj).todense())
    x = rng.standard_normal(12)
    got = applied(bst.block_jacobi(Aj), bt.block_jacobi(Ap), x)
    expect = np.concatenate([np.linalg.inv(dense[:10, :10]) @ x[:10], x[10:]])
    assert np.max(np.abs(got - expect)) < 1e-10


def test_block_jacobi_uncovered_rows_fall_back_to_point_jacobi():
    rng = np.random.default_rng(6)
    idx = np.arange(0, 8)
    diag = rng.standard_normal((8, 8)) + 10 * np.eye(8)
    off = rng.standard_normal((4, 4)) + 5 * np.eye(4)  # rows 8..11, NOT detected
    Aj, Ap = pair("BlockSparseMatrix", [diag, off], [idx, np.arange(8, 12)],
                  [idx, np.arange(9, 13)], (14, 14))
    M = bt.block_jacobi(Ap)
    assert isinstance(M, bt.SumOperator)
    assert isinstance(M.b, bt.DiagonalOperator) and M.b.device == Ap.device
    dense = np.asarray(bst.to_scipy(Aj).todense())
    d = dense.diagonal()
    x = rng.standard_normal(14)
    got = applied(bst.block_jacobi(Aj), M, x)
    expect = x.copy()
    expect[:8] = np.linalg.inv(dense[:8, :8]) @ x[:8]
    for i in range(8, 14):
        expect[i] = x[i] / d[i] if d[i] != 0 else x[i]
    assert np.max(np.abs(got - expect)) < 1e-10


def test_block_jacobi_symmetric_uses_stored_diagonals():
    Sj, Sp, rng = spd_symmetric()
    dense = np.asarray(bst.to_scipy(Sj).todense())
    x = rng.standard_normal(Sp.shape[0])
    got = applied(bst.block_jacobi(Sj), bt.block_jacobi(Sp), x)
    expect = x.copy()
    for i in range(Sp.ndiagonals):
        idx = np.asarray(Sp.diagonalindices(i))
        expect[idx] = np.linalg.solve(dense[np.ix_(idx, idx)], x[idx])
    assert np.max(np.abs(got - expect)) < 1e-9


def test_block_jacobi_accelerates_cg():
    Sj, Sp, rng = spd_symmetric(seed=7)
    b = rng.standard_normal(Sp.shape[0])
    _, plain = bt.cg(Sp, b, tol=1e-10, maxiter=4000)
    xj, ij = bst.cg(Sj, jnp.asarray(b), tol=1e-10, maxiter=4000,
                    M=bst.block_jacobi(Sj))
    x, info = bt.cg(Sp, b, tol=1e-10, maxiter=4000, M=bt.block_jacobi(Sp))
    assert bool(info.converged)
    assert int(info.iterations) == int(ij.iterations)
    assert int(info.iterations) < int(plain.iterations)
    assert np.linalg.norm(x.numpy() - np.asarray(xj)) / np.linalg.norm(
        np.asarray(xj)) < 1e-10
    r = np.linalg.norm((Sp @ x).numpy() - b) / np.linalg.norm(b)
    assert r < 1e-8


def test_block_jacobi_explicit_index_sets_and_overlap_rejection():
    rng = np.random.default_rng(8)
    dense = rng.standard_normal((16, 16)) + 16 * np.eye(16)
    A = bt.from_dense(dense, block_size=16, device="cpu")
    Aj = bst.from_dense(dense, block_size=16)
    sets = [np.arange(0, 8), np.arange(8, 16)]
    x = rng.standard_normal(16)
    got = applied(bst.block_jacobi(Aj, index_sets=sets),
                  bt.block_jacobi(A, index_sets=sets), x)
    expect = x.copy()
    expect[:8] = np.linalg.solve(dense[:8, :8], x[:8])
    expect[8:] = np.linalg.solve(dense[8:, 8:], x[8:])
    assert np.max(np.abs(got - expect)) < 1e-10
    with pytest.raises(ValueError, match="overlap"):
        bt.block_jacobi(A, index_sets=[np.arange(0, 9), np.arange(8, 16)])


@pytest.mark.parametrize("make", ["jacobi", "block_jacobi"])
def test_preconditioners_reject_rectangular(make):
    A = bt.BlockSparseMatrix([np.ones((3, 4))], [np.arange(3)], [np.arange(4)],
                             (6, 8), device="cpu")
    with pytest.raises(ValueError, match="square"):
        getattr(bt, make)(A)


def test_jacobi_fallback_when_no_diagonal_blocks():
    rng = np.random.default_rng(9)
    Aj, Ap = pair("BlockSparseMatrix", [rng.standard_normal((4, 4))],
                  [np.arange(0, 4)], [np.arange(4, 8)], (8, 8))
    M = bt.block_jacobi(Ap)
    assert isinstance(M, bt.DiagonalOperator)  # pure point-Jacobi fallback
    x = rng.standard_normal(8)
    assert np.max(np.abs(applied(bst.block_jacobi(Aj), M, x) - x)) < TOL


def test_singular_block_takes_the_pseudoinverse():
    """A singular diagonal block warns and takes pinv, in both packages."""
    rng = np.random.default_rng(12)
    sing = rng.standard_normal((6, 6)) + 6 * np.eye(6)
    sing[:, 4] = sing[4] = 0.0  # an all-zero row and column: exactly singular
    Aj, Ap = pair("BlockSparseMatrix", [sing], [np.arange(6)], [np.arange(6)],
                  (6, 6))
    with pytest.warns(UserWarning, match="pseudoinverse"):
        M = bt.block_jacobi(Ap)
    with pytest.warns(UserWarning, match="pseudoinverse"):
        Mj = bst.block_jacobi(Aj)
    x = rng.standard_normal(6)
    assert relerr(applied(Mj, M, x), np.linalg.pinv(sing) @ x) < 1e-10


def test_block_jacobi_keeps_the_operator_dtype():
    """f32 operator -> f32 inverses (computed in f64) on its device."""
    Sj, Sp, rng = spd_symmetric(seed=3, n=240, ngroups=8, noffdiag=10)
    args = [[Sp.diagonal(i).astype(np.float32) for i in range(Sp.ndiagonals)],
            [Sp.diagonalindices(i) for i in range(Sp.ndiagonals)],
            [Sp.offdiagonal(i).astype(np.float32)
             for i in range(Sp.noffdiagonals)],
            [Sp.blockrowindices(i) for i in range(Sp.noffdiagonals)],
            [Sp.blockcolindices(i) for i in range(Sp.noffdiagonals)],
            Sp.shape]
    S32 = bt.SymmetricBlockMatrix(*args, device="cpu")
    M = bt.block_jacobi(S32)
    assert M.dtype == torch.float32 and M.device == S32.device
    x = rng.standard_normal(Sp.shape[0])
    got = (M @ torch.from_numpy(x.astype(np.float32))).numpy()
    want = np.asarray(bst.block_jacobi(Sj) @ jnp.asarray(x))
    assert relerr(got, want) < 1e-5


@pytest.mark.parametrize("name, kw", [
    ("cg", dict(tol=1e-10, maxiter=4000)),
    ("gmres", dict(tol=1e-10, restart=20, maxiter=4000)),
])
def test_slice_block_jacobi_solve(name, kw):
    """The slice as a whole: block_jacobi + a Krylov solve, built in both
    packages; the JAX preconditioner carried across with from_reference
    applies as the port's own."""
    d, di, o, ri, ci, shape = tm.random_symmetric(
        17, n=480, ngroups=16, noffdiag=30, dtype=np.float64)
    d = [0.05 * (b + b.T) + np.eye(len(b)) * len(b) for b in d]
    o = [0.05 * b for b in o]
    Sj, Sp = pair("SymmetricBlockMatrix", d, di, o, ri, ci, shape)
    Mj, Mp = bst.block_jacobi(Sj), bt.block_jacobi(Sp)
    Mx = bt.from_reference(Mj, device="cpu")
    b = np.random.default_rng(18).standard_normal(shape[0])
    xj, ij = getattr(bst, name)(Sj, jnp.asarray(b), M=Mj, **kw)
    for M in (Mp, Mx):
        x, info = getattr(bt, name)(Sp, b, M=M, **kw)
        assert bool(info.converged) == bool(ij.converged) is True
        assert int(info.iterations) == int(ij.iterations)
        assert np.linalg.norm(x.numpy() - np.asarray(xj)) / np.linalg.norm(
            np.asarray(xj)) < 1e-10


def test_from_reference_carries_the_point_jacobi_sum():
    """block_jacobi's ``M + DiagonalOperator`` crosses over as a sum whose
    product equals the JAX one."""
    rng = np.random.default_rng(6)
    idx = np.arange(0, 8)
    Aj, Ap = pair("BlockSparseMatrix",
                  [rng.standard_normal((8, 8)) + 10 * np.eye(8),
                   rng.standard_normal((4, 4)) + 5 * np.eye(4)],
                  [idx, np.arange(8, 12)], [idx, np.arange(9, 13)], (14, 14))
    Mj = bst.block_jacobi(Aj)
    M = bt.from_reference(Mj, device="cpu")
    assert isinstance(M, bt.SumOperator)
    assert isinstance(M.a, bt.BlockSparseMatrix)
    assert isinstance(M.b, bt.DiagonalOperator)
    D = bt.from_reference(Mj.b, device="cpu", dtype=np.float32)
    assert D.dtype == torch.float32 and D.device == torch.device("cpu")
    x = rng.standard_normal(14)
    applied(Mj, M, x)
    applied(Mj, bt.block_jacobi(Ap), x)
