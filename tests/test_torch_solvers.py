"""The port's Krylov solvers on the CPU: port vs JAX package vs dense oracles.

Each case of ``tests/test_solvers.py`` runs here twice on the same numpy
inputs from a seed: through the JAX solver (``backend="xla"``, x64) and
through the port's (``device="cpu"`` operators, the kernels' plain
versions).  In float64 the port's ``SolveInfo.iterations`` and ``converged``
equal the JAX ones and its x agrees within 1e-10 relative; both also meet
the case's own oracle (a dense solve or scipy).  The complex cases run on
dense complex128 matrices, which the solvers accept (the port's formats
still refuse complex).  The two jit cases of the JAX suite have no eager
counterpart: in their place the host reads (``solvers.HOST_CHECKS``) are
held to ``ceil(iterations / CHUNK) + 2`` per solve.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import blocksparse_tpu as bst
import blocksparse_tpu_torch as bt
from blocksparse_tpu_torch import solvers
from blocksparse_tpu_torch.utils import testmatrices as tm

torch.set_num_threads(2)

XTOL = 1e-10


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def spd_args(seed=0, n=600, dtype=np.float64):
    """SPD blocks as ``test_solvers.py::_spd_operator`` makes them."""
    d, di, o, ri, ci, shape = tm.random_symmetric(
        seed, n=n, ngroups=24, noffdiag=40, dtype=dtype)
    d = [0.05 * (b + b.T.conj()) + np.eye(len(b), dtype=dtype) * len(b)
         for b in d]
    o = [0.05 * b for b in o]
    return d, di, o, ri, ci, shape


def spd_pair(seed=0, n=600):
    """(JAX operator, port operator) on one set of SPD blocks."""
    args = spd_args(seed, n)
    return (bst.SymmetricBlockMatrix(*args, backend="xla"),
            bt.SymmetricBlockMatrix(*args, device="cpu"))


def both(name, Aj, Ap, b, Mj=None, Mp=None, **kw):
    """Solve with the JAX solver and the port's; hold the port to JAX."""
    xj, ij = getattr(bst, name)(Aj, jnp.asarray(b), M=Mj, **kw)
    xp, ip = getattr(bt, name)(Ap, b, M=Mp, **kw)
    assert isinstance(xp, torch.Tensor)
    assert int(ip.iterations) == int(ij.iterations)
    assert bool(ip.converged) == bool(ij.converged)
    assert rel(xp, xj) < XTOL
    return xp, ip


def test_cg_matches_dense_solve():
    Sj, Sp = spd_pair()
    A = np.asarray(bst.to_scipy(Sj).todense())
    b = np.random.default_rng(1).standard_normal(Sp.shape[0])
    x, info = both("cg", Sj, Sp, b, tol=1e-12, maxiter=2000)
    assert bool(info.converged) and int(info.iterations) > 0
    assert rel(x, np.linalg.solve(A, b)) < 1e-8


def test_cg_preconditioned_converges_faster():
    Sj, Sp = spd_pair()
    dinv = 1.0 / bst.to_scipy(Sj).diagonal()
    dinv_t = torch.from_numpy(dinv)
    b = np.random.default_rng(2).standard_normal(Sp.shape[0])
    _, plain = both("cg", Sj, Sp, b, tol=1e-10)
    _, pre = both("cg", Sj, Sp, b, Mj=lambda r: jnp.asarray(dinv) * r,
                  Mp=lambda r: dinv_t * r, tol=1e-10)
    assert bool(pre.converged) and bool(plain.converged)
    assert int(pre.iterations) <= int(plain.iterations)


def complex_hermitian_dense():
    """``test_cg_complex_hermitian``'s matrix, assembled: a real symmetric
    PD block operator in complex128."""
    d, di, o, ri, ci, shape = tm.random_symmetric(
        3, n=400, ngroups=16, noffdiag=24, dtype=np.complex128)
    d = [0.05 * (b + b.conj().T) + np.eye(len(b)) * len(b) for b in d]
    o = [0.05 * b for b in o]
    d = [b.real.astype(np.complex128) for b in d]
    o = [b.real.astype(np.complex128) for b in o]
    S = bst.SymmetricBlockMatrix(d, di, o, ri, ci, shape)
    return np.asarray(bst.to_scipy(S).todense())


def test_cg_complex_hermitian():
    A = complex_hermitian_dense()
    rng = np.random.default_rng(4)
    b = rng.standard_normal(A.shape[0]) + 1j * rng.standard_normal(A.shape[0])
    x, info = both("cg", jnp.asarray(A), torch.from_numpy(A), b, tol=1e-12)
    assert x.dtype == torch.complex128
    assert bool(info.converged)
    assert rel(x, np.linalg.solve(A, b)) < 1e-8


def test_bicgstab_nonsymmetric():
    blocks, rows, cols, shape = tm.random_block_sparse(
        5, shape=(500, 500), nblocks=60, max_block=40, dtype=np.float64)
    eye_blocks = [np.eye(50) * 40.0 for _ in range(10)]
    eye_idx = [np.arange(i * 50, (i + 1) * 50) for i in range(10)]
    args = (list(blocks) + eye_blocks, list(rows) + eye_idx,
            list(cols) + eye_idx, shape)
    Aj = bst.BlockSparseMatrix(*args, backend="xla")
    Ap = bt.BlockSparseMatrix(*args, device="cpu")
    D = np.asarray(bst.to_scipy(Aj).todense())
    b = np.random.default_rng(6).standard_normal(shape[0])
    x, info = both("bicgstab", Aj, Ap, b, tol=1e-12, maxiter=4000)
    assert bool(info.converged)
    assert rel(x, np.linalg.solve(D, b)) < 1e-6


def test_gmres_native():
    """Restarted GMRES (Arnoldi + Givens) reports its true iterations."""
    Sj, Sp = spd_pair(seed=7, n=300)
    b = np.random.default_rng(8).standard_normal(Sp.shape[0])
    x, info = both("gmres", Sj, Sp, b, tol=1e-10, restart=40, maxiter=400)
    assert bool(info.converged) and int(info.iterations) > 0
    r = b - (Sp @ x).numpy()
    assert np.linalg.norm(r) <= max(1e-10 * np.linalg.norm(b), 1e-12) * 10


def test_gmres_matches_scipy():
    import scipy.sparse.linalg as spla

    rng = np.random.default_rng(21)
    n = 180
    A = np.eye(n) * 8 + 0.5 * rng.standard_normal((n, n))
    b = rng.standard_normal(n)
    x, info = both("gmres", jnp.asarray(A), torch.from_numpy(A), b,
                   tol=1e-12, restart=30,
                   maxiter=600)
    x_sp, code = spla.gmres(A, b, rtol=1e-12, restart=30, maxiter=600)
    assert code == 0 and bool(info.converged)
    ref = np.linalg.solve(A, b)
    assert rel(x, ref) < 1e-9 and rel(x_sp, ref) < 1e-9


def test_gmres_complex_and_preconditioned():
    rng = np.random.default_rng(22)
    n = 120
    A = (np.eye(n) * 6 + 0.4 * (rng.standard_normal((n, n))
                                + 1j * rng.standard_normal((n, n))))
    b = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    M = np.diag(1.0 / np.diag(A))
    x, info = both("gmres", jnp.asarray(A), torch.from_numpy(A), b,
                   Mj=jnp.asarray(M), Mp=M,
                   tol=1e-12, restart=25, maxiter=500)
    assert bool(info.converged) and int(info.iterations) > 0
    assert rel(x, np.linalg.solve(A, b)) < 1e-8


@pytest.mark.parametrize("name, seed, n, kw", [
    ("gmres", 23, 200, dict(tol=1e-10, restart=30)),
    ("cg", 9, 300, dict(tol=1e-10)),
    ("bicgstab", 9, 300, dict(tol=1e-10)),
])
def test_host_checks_per_chunk(name, seed, n, kw):
    """In place of the JAX suite's jit cases: the loop runs on the device
    and the host reads its flag once per CHUNK iterations."""
    Sj, Sp = spd_pair(seed=seed, n=n)
    b = np.random.default_rng(seed + 1).standard_normal(Sp.shape[0])
    solvers.HOST_CHECKS = 0
    x, info = both(name, Sj, Sp, b, **kw)
    r = (Sp @ x).numpy() - b
    assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-8
    k = int(info.iterations)
    assert 0 < solvers.HOST_CHECKS <= math.ceil(k / solvers.CHUNK) + 2, (
        solvers.HOST_CHECKS, k)


def test_gmres_reads_per_cycle():
    """Across restarts GMRES reads at each cycle's chunk boundaries, the
    last of which also decides the next cycle."""
    Sj, Sp = spd_pair(seed=23, n=200)
    b = np.random.default_rng(24).standard_normal(Sp.shape[0])
    m = 6
    solvers.HOST_CHECKS = 0
    _, info = both("gmres", Sj, Sp, b, tol=1e-10, restart=m)
    cycles = math.ceil(int(info.iterations) / m)
    assert cycles > 1
    assert solvers.HOST_CHECKS <= cycles * math.ceil(m / solvers.CHUNK)


def test_solver_accepts_dense_and_callable():
    rng = np.random.default_rng(11)
    n = 64
    Q = rng.standard_normal((n, n))
    A = Q @ Q.T + n * np.eye(n)
    b = rng.standard_normal(n)
    At = torch.from_numpy(A)
    x1, i1 = both("cg", jnp.asarray(A), At, b, tol=1e-12)
    x2, i2 = bt.cg(lambda v: At @ v, torch.from_numpy(b), tol=1e-12)
    ref = np.linalg.solve(A, b)
    assert np.allclose(x1.numpy(), ref, atol=1e-8)
    assert np.allclose(x2.numpy(), ref, atol=1e-8)
    assert int(i1.iterations) == int(i2.iterations)


def test_frozen_steps_change_nothing():
    """b an eigenvector of A: CG converges in one iteration, and the frozen
    steps after it divide by the vanished rz (0 / 0); torch.where keeps the
    iterate finite and equal to the JAX one."""
    n = 48
    A = np.diag(np.arange(1.0, n + 1))
    b = np.zeros(n)
    b[5] = 3.0
    x, info = both("cg", jnp.asarray(A), torch.from_numpy(A), b, tol=1e-12)
    assert int(info.iterations) == 1 and bool(info.converged)
    assert torch.isfinite(x).all() and rel(x, b / 6.0) < 1e-15


@pytest.mark.parametrize("name", ["cg", "bicgstab", "gmres"])
def test_maxiter_caps_the_count(name):
    """An exhausted maxiter stops the count where the JAX loop stops it,
    mid-chunk, with converged False in both."""
    Sj, Sp = spd_pair(seed=9, n=300)
    b = np.random.default_rng(10).standard_normal(Sp.shape[0])
    _, info = both(name, Sj, Sp, b, tol=1e-14, maxiter=5)
    assert int(info.iterations) == 5 and not bool(info.converged)


def test_info_on_the_operator_device_and_dtype_rule():
    Sj, Sp = spd_pair(seed=9, n=300)
    b = np.random.default_rng(10).standard_normal(Sp.shape[0])
    x, info = bt.cg(Sp, b, tol=1e-8)
    for field in info:
        assert isinstance(field, torch.Tensor) and field.ndim == 0
        assert field.device == Sp.device
    assert info.iterations.dtype == torch.int32
    assert info.converged.dtype == torch.bool
    assert x.device == Sp.device and x.dtype == Sp.dtype
    with pytest.raises(TypeError, match="dtype"):
        bt.cg(Sp, b.astype(np.float32))


@pytest.mark.parametrize("name", ["cg", "bicgstab", "gmres"])
def test_numpy_inputs_solve_on_the_card(name):
    """With a dense numpy ``A`` (or a callable) and a numpy ``b`` nothing
    names a device, so the solve runs on the card, and without one it
    raises instead of running on the CPU; so do ``as_matvec`` of a numpy
    matrix and ``DiagonalOperator`` of a numpy vector."""
    rng = np.random.default_rng(12)
    n = 32
    A = np.eye(n) * 4 + 0.1 * rng.standard_normal((n, n))
    A = A @ A.T
    b = rng.standard_normal(n)
    At = torch.from_numpy(A)
    calls = {
        "dense": lambda: getattr(bt, name)(A, b, tol=1e-10),
        "callable": lambda: getattr(bt, name)(lambda v: At.to(v.device) @ v,
                                               b, tol=1e-10),
        "as_matvec": lambda: (solvers.as_matvec(A)(torch.from_numpy(b).to(
            "cuda")), None),
        "diagonal": lambda: (bt.DiagonalOperator(np.diag(A).copy()).d, None),
    }
    for kind, call in calls.items():
        if torch.cuda.is_available():
            out = call()[0]
            assert out.device.type == "cuda", kind
        else:
            with pytest.raises(RuntimeError, match="no CUDA card"):
                call()
