"""Complex dtypes in the port on the CPU: port vs JAX package vs scipy.

The same numpy blocks from a seed go into the JAX package's operators
(``backend="xla"``, x64) and the port's (``device="cpu"``: the plain
versions of kernels B1 and B9's element pass, which on the card run their
complex instances).  Products agree with each other and with scipy at
1e-13 (complex128) or 1e-5 (complex64), relative to max(1, max|ref|):

- every case of ``tests/test_complex_split.py``: ``split_complex`` /
  ``ComplexSplitOperator`` (its jit case becomes a check that the split
  children are real port operators and that ``mv_split`` / ``mm_split``
  take and return real tensors);
- both cases of ``tests/test_dtypes.py::test_complex64``;
- the complex128 cases of ``test_block_sparse.py``, ``test_symmetric.py``,
  ``test_vbcrs.py`` and ``test_operator.py``: ``A``, ``A.T``, ``A.H``,
  ``A.conj()``, ``axpby(x, y, 1j, 2j)``, multi-RHS, serial == colored;
- the gradients of every mode (``dx = A^H g``, the values' ``g x^H``)
  against torch autograd over a dense complex assembly;
- no complex product reaches the patch (B2, B3, B7) or stream (B5, B8,
  B10) routes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import blocksparse_tpu as bst
import blocksparse_tpu_torch as bt
from blocksparse_tpu_torch.formats import stream as stream_format
from blocksparse_tpu_torch.ops import dispatch, patch_engine
from blocksparse_tpu_torch.ops.kernels import fused_spmm, mask_select
from blocksparse_tpu_torch.ops.kernels.fused_spmm import BucketTable
from blocksparse_tpu_torch.utils.testmatrices import (random_block_sparse,
                                                      random_symmetric,
                                                      random_vbcrs)

torch.set_num_threads(2)

TOL = 1e-13
TOL64 = 1e-5  # complex64


def relerr(a, b):
    a, b = (v.detach().resolve_conj().numpy() if isinstance(v, torch.Tensor)
            else v for v in (a, b))
    a = np.asarray(a, dtype=np.complex128)
    b = np.asarray(b, dtype=np.complex128)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(1.0, float(np.max(np.abs(b))) if b.size else 1.0)
    return float(np.max(np.abs(a - b))) / scale if a.size else 0.0


def cvec(rng, *shape, dtype=np.complex128):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(dtype)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def held(port, jax_out, oracle, tol=TOL):
    """The port's product held to the JAX package's and to the oracle."""
    got = port.numpy() if isinstance(port, torch.Tensor) else port
    assert relerr(got, oracle) < tol
    if jax_out is not None:
        assert relerr(got, np.asarray(jax_out)) < tol


# -- split_complex / ComplexSplitOperator (tests/test_complex_split.py) --------

def test_block_sparse_split():
    rng = np.random.default_rng(0)
    blocks, rows, cols, shape = random_block_sparse(
        111, shape=(300, 300), nblocks=20, max_block=40, dtype=np.complex128)
    Aj = bst.BlockSparseMatrix(blocks, rows, cols, shape, backend="xla")
    A = bt.BlockSparseMatrix(blocks, rows, cols, shape, device="cpu")
    P, Pj = bt.split_complex(A), bst.split_complex(Aj)
    S = bt.to_scipy(A)
    x = cvec(rng, 300)
    xt, xj = t(x), jnp.asarray(x)
    held(P @ xt, Pj @ xj, S @ x)
    held(P.T @ xt, Pj.T @ xj, S.T @ x)
    held(P.H @ xt, Pj.H @ xj, S.conj().T @ x)
    held(P.conj() @ xt, Pj.conj() @ xj, S.conj() @ x)
    held(P.axpby(xt, xt, 1j, 2j), Pj.axpby(xj, xj, 1j, 2j),
         1j * (S @ x) + 2j * x)
    # the split API: real tensors in, real tensors out
    yr, yi = P.mv_split(x.real.copy(), x.imag.copy())
    jr, ji = Pj.mv_split(x.real, x.imag)
    held(yr.numpy() + 1j * yi.numpy(), np.asarray(jr) + 1j * np.asarray(ji),
         S @ x)
    X = cvec(rng, 300, 4)
    Yr, Yi = P.mm_split(X.real.copy(), X.imag.copy())
    held(Yr.numpy() + 1j * Yi.numpy(), None, S @ X)
    # the operator's own split form: cached, the same numbers
    assert A.split() is A.split()
    Ar, Ai = A.mv_split(x.real.copy(), x.imag.copy())
    held(Ar.numpy() + 1j * Ai.numpy(), None, S @ x)


def test_symmetric_split():
    rng = np.random.default_rng(1)
    d, di, o, ri, ci, shape = random_symmetric(
        112, n=400, ngroups=10, noffdiag=15, dtype=np.complex128)
    Sj = bst.SymmetricBlockMatrix(d, di, o, ri, ci, shape, backend="xla")
    S_op = bt.SymmetricBlockMatrix(d, di, o, ri, ci, shape, device="cpu")
    P, Pj = bt.split_complex(S_op), bst.split_complex(Sj)
    S = bt.to_scipy(S_op)
    x = cvec(rng, 400)
    xt, xj = t(x), jnp.asarray(x)
    held(P @ xt, Pj @ xj, S @ x)
    held(P.T @ xt, Pj.T @ xj, S.T @ x)
    held(P.H @ xt, Pj.H @ xj, S.conj().T @ x)
    assert P.schedule == S_op.schedule == Pj.schedule


def test_split_children_are_real_port_operators():
    """In place of the JAX suite's pytree/jit case: the split children are
    real port operators of the format, carrying the operator's options,
    and ``mv_split`` / ``mm_split`` take and return real tensors."""
    rng = np.random.default_rng(2)
    blocks, rows, cols, shape = random_block_sparse(
        113, shape=(120, 120), nblocks=8, max_block=20, dtype=np.complex128)
    A = bt.BlockSparseMatrix(blocks, rows, cols, shape, device="cpu",
                             schedule="colored", precision=None,
                             patch="never", panel="v2")
    Aj = bst.BlockSparseMatrix(blocks, rows, cols, shape, backend="xla")
    P = bt.split_complex(A)
    assert isinstance(P, bt.ComplexSplitOperator)
    for child in (P.re_op, P.im_op):
        assert type(child) is bt.BlockSparseMatrix
        assert child.dtype == torch.float64 and child.device == A.device
        assert (child.schedule, child.precision, child.patch, child.panel) == (
            "colored", None, "never", "v2")
    assert P.dtype == torch.complex128 and P.shape == A.shape
    xr, xi = rng.standard_normal(120), rng.standard_normal(120)
    yr, yi = P.mv_split(xr, xi)
    assert yr.dtype == yi.dtype == torch.float64 and not yr.is_complex()
    jr, ji = bst.split_complex(Aj).mv_split(xr, xi)
    ref = bt.to_scipy(A) @ (xr + 1j * xi)
    held(yr.numpy() + 1j * yi.numpy(), np.asarray(jr) + 1j * np.asarray(ji),
         ref)
    Yr, Yi = P.mm_split(rng.standard_normal((120, 3)),
                        rng.standard_normal((120, 3)))
    assert Yr.shape == Yi.shape == (120, 3) and not Yr.is_complex()
    # kwargs override the inherited options
    Q = bt.split_complex(A, schedule="serial", patch="auto")
    assert Q.re_op.schedule == "serial" and Q.re_op.patch == "auto"


def test_split_vbcrs_and_bad_inputs():
    rng = np.random.default_rng(3)
    blocks, rs, cs, shape = random_vbcrs(3, shape=(400, 360), nrowgroups=10,
                                         ncolgroups=9, dtype=np.complex128)
    V = bt.VariableBlockCompressedRowStorage(blocks, rs, cs, shape,
                                             device="cpu")
    P = bt.split_complex(V)
    assert type(P.re_op) is bt.VariableBlockCompressedRowStorage
    S = bt.to_scipy(V)
    x = cvec(rng, shape[1])
    y = cvec(rng, shape[0])
    held(P @ t(x), None, S @ x)
    held(P.H @ t(y), None, S.conj().T @ y)
    with pytest.raises(TypeError, match="unsupported operator"):
        bt.split_complex(bt.DiagonalOperator(torch.ones(4)))
    with pytest.raises(ValueError, match="shape mismatch"):
        bt.ComplexSplitOperator(P.re_op, P.re_op.T)
    with pytest.raises(TypeError, match="dtype"):
        P @ torch.zeros(shape[1], dtype=torch.complex64)


# -- complex64 (tests/test_dtypes.py::test_complex64) ---------------------------

@pytest.mark.parametrize("contiguous", [False, True])
def test_complex64(contiguous):
    """BEM's dtype through the element and chunked buckets."""
    rng = np.random.default_rng(4)
    blocks, rows, cols, shape = random_block_sparse(
        101, shape=(300, 300), nblocks=20, max_block=40, dtype=np.complex64,
        contiguous=contiguous)
    Aj = bst.BlockSparseMatrix(blocks, rows, cols, shape, backend="xla")
    A = bt.BlockSparseMatrix(blocks, rows, cols, shape, device="cpu")
    assert A.dtype == torch.complex64
    S = bt.to_scipy(A).astype(np.complex128)
    x = cvec(rng, 300, dtype=np.complex64)
    xt, xj = t(x), jnp.asarray(x)
    for got, want, ref in ((A @ xt, Aj @ xj, S @ x),
                           (A.H @ xt, Aj.H @ xj, S.conj().T @ x),
                           (A.conj() @ xt, Aj.conj() @ xj, S.conj() @ x)):
        assert got.dtype == torch.complex64
        held(got, want, ref, TOL64)


# -- complex128 oracles (test_block_sparse / symmetric / vbcrs / operator) ------

FIXTURES = {
    "sphere": dict(seed=1, shape=(1203, 1203), nblocks=100, max_block=60),
    "cuboid": dict(seed=2, shape=(1344, 1344), nblocks=96, max_block=141),
}


def bsm_pair(name, schedule, dtype=np.complex128):
    cfg = FIXTURES[name]
    blocks, rows, cols, shape = random_block_sparse(
        cfg["seed"], shape=cfg["shape"], nblocks=cfg["nblocks"],
        max_block=cfg["max_block"], dtype=dtype)
    return (bst.BlockSparseMatrix(blocks, rows, cols, shape,
                                  schedule=schedule, granularity=(32, 32),
                                  backend="xla"),
            bt.BlockSparseMatrix(blocks, rows, cols, shape, schedule=schedule,
                                 granularity=(32, 32), device="cpu"))


def oracle_products(Aj, A, rng, reps=2):
    """A, A.T, A.H, A.conj() and axpby(x, y, 1j, 2j) against scipy, the
    first draw also against the JAX package."""
    S = bt.to_scipy(A)
    m, n = A.shape
    for k in range(reps):
        x, y = cvec(rng, n), cvec(rng, m)
        xt, yt = t(x), t(y)
        jx = (lambda op, v: op @ jnp.asarray(v)) if k == 0 else (
            lambda op, v: None)
        held(A @ xt, jx(Aj, x), S @ x)
        held(A.T @ yt, jx(Aj.T, y), S.T @ y)
        held(A.H @ yt, jx(Aj.H, y), S.conj().T @ y)
        held(A.conj() @ xt, jx(Aj.conj(), x), S.conj() @ x)
        held(A.axpby(xt, yt, 1j, 2j),
             Aj.axpby(jnp.asarray(x), jnp.asarray(y), 1j, 2j) if k == 0
             else None, 1j * (S @ x) + 2j * y)


@pytest.mark.parametrize("name", ["sphere", "cuboid"])
@pytest.mark.parametrize("schedule", [bt.SERIAL, bt.COLORED])
def test_bsm_oracle_products(name, schedule):
    Aj, A = bsm_pair(name, schedule)
    assert A.dtype == torch.complex128
    oracle_products(Aj, A, np.random.default_rng(5))


def test_bsm_multi_rhs_and_todense():
    rng = np.random.default_rng(6)
    Aj, A = bsm_pair("sphere", bt.SERIAL)
    S = bt.to_scipy(A)
    X, Y = cvec(rng, A.shape[1], 7), cvec(rng, A.shape[0], 7)
    held(A @ t(X), Aj @ jnp.asarray(X), S @ X)
    held(A.T @ t(Y), None, S.T @ Y)
    held(A.H @ t(Y), Aj.H @ jnp.asarray(Y), S.conj().T @ Y)
    held(A.mm(t(X)), None, S @ X)
    held(A.todense(), None, S.toarray())


def test_bsm_serial_vs_colored():
    rng = np.random.default_rng(7)
    _, a = bsm_pair("cuboid", bt.SERIAL)
    _, b = bsm_pair("cuboid", bt.COLORED)
    x = t(cvec(rng, a.shape[1]))
    for op_a, op_b in ((a, b), (a.H, b.H), (a.conj(), b.conj())):
        assert relerr(op_a @ x, op_b @ x) < TOL


def sym_pair(seed, schedule, symmetric_diag=False, dtype=np.complex128):
    d, di, o, ri, ci, shape = random_symmetric(
        seed, n=1203 if seed == 1 else 1344, dtype=dtype)
    if symmetric_diag:
        d = [(b + b.T) / 2 for b in d]
    return (bst.SymmetricBlockMatrix(d, di, o, ri, ci, shape,
                                     schedule=schedule, granularity=(32, 32),
                                     backend="xla"),
            bt.SymmetricBlockMatrix(d, di, o, ri, ci, shape,
                                    schedule=schedule, granularity=(32, 32),
                                    device="cpu"))


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("schedule", [bt.SERIAL, bt.COLORED])
def test_symmetric_oracle_products(seed, schedule):
    Sj, S_op = sym_pair(seed, schedule)
    oracle_products(Sj, S_op, np.random.default_rng(8))


def test_symmetric_is_complex_symmetric():
    """S.T @ y == S @ y and S.H @ y == conj(S) @ y where the diagonal
    blocks are symmetric (``test_symmetric_oracle_is_symmetric``), and the
    multi-RHS products match scipy."""
    rng = np.random.default_rng(9)
    Sj, S_op = sym_pair(1, bt.COLORED, symmetric_diag=True)
    S = bt.to_scipy(S_op).toarray()
    assert relerr(S, S.T) < TOL
    y = t(cvec(rng, S_op.shape[0]))
    assert relerr(S_op @ y, S_op.T @ y) < TOL
    assert relerr(S_op.H @ y, S_op.conj() @ y) < TOL
    Y = cvec(rng, S_op.shape[0], 5)
    held(S_op @ t(Y), Sj @ jnp.asarray(Y), S @ Y)
    held(S_op.H @ t(Y), None, S.conj().T @ Y)
    held(S_op.todense(), None, S)


def test_symmetric_serial_vs_colored():
    rng = np.random.default_rng(10)
    _, a = sym_pair(2, bt.SERIAL)
    _, b = sym_pair(2, bt.COLORED)
    x = t(cvec(rng, a.shape[0]))
    for op_a, op_b in ((a, b), (a.H, b.H), (a.conj(), b.conj())):
        assert relerr(op_a @ x, op_b @ x) < TOL


@pytest.mark.parametrize("schedule", [bt.SERIAL, bt.COLORED])
def test_vbcrs_oracle_products(schedule):
    blocks, rs, cs, shape = random_vbcrs(3, dtype=np.complex128)
    Vj = bst.VariableBlockCompressedRowStorage(
        blocks, rs, cs, shape, schedule=schedule, granularity=(32, 32),
        backend="xla")
    V = bt.VariableBlockCompressedRowStorage(
        blocks, rs, cs, shape, schedule=schedule, granularity=(32, 32),
        device="cpu")
    rng = np.random.default_rng(11)
    oracle_products(Vj, V, rng)
    S = bt.to_scipy(V)
    X = cvec(rng, shape[1], 3)
    held(V @ t(X), Vj @ jnp.asarray(X), S @ X)


def test_operator_algebra_complex():
    """``test_operator.py::test_scaled_sum_composed`` on complex operators."""
    rng = np.random.default_rng(12)

    def build(seed):
        blocks, rows, cols, shp = random_block_sparse(
            seed, shape=(200, 200), nblocks=20, max_block=30,
            dtype=np.complex128)
        return bt.BlockSparseMatrix(blocks, rows, cols, shp, device="cpu")

    A, B = build(21), build(22)
    Sa, Sb = bt.to_scipy(A).toarray(), bt.to_scipy(B).toarray()
    x = cvec(rng, 200)
    xt = t(x)
    for got, want in (((2.5 * A) @ xt, 2.5 * (Sa @ x)),
                      ((A * 1j) @ xt, 1j * (Sa @ x)),
                      ((A + B) @ xt, (Sa + Sb) @ x),
                      ((A - B) @ xt, (Sa - Sb) @ x),
                      ((-A) @ xt, -(Sa @ x)),
                      ((A @ B) @ xt, Sa @ (Sb @ x)),
                      ((A @ B).T @ xt, (Sa @ Sb).T @ x),
                      ((A @ B).H @ xt, (Sa @ Sb).conj().T @ x),
                      ((2.0 * A).H @ xt, 2.0 * Sa.conj().T @ x),
                      ((1j * A).H @ xt, (1j * Sa).conj().T @ x)):
        assert relerr(got, want) < TOL
    assert isinstance(A.T.H, bt.ConjOperator)
    assert A.conj().conj() is A


# -- gradients against autograd over a dense assembly ---------------------------

MODES = {"forward": {}, "transpose": {"transpose": True},
         "symmetric": {"symmetric": True}}


def dense_of(vals, rows, cols, shape, *, transpose, symmetric, conj):
    """The operator that a launch over the buckets ``(values, element rows,
    element cols)`` applies, assembled densely with differentiable torch
    ops (sentinel rows and columns land in a dropped last row / column)."""
    m, n = shape
    M = torch.zeros(m + 1, n + 1, dtype=vals[0].dtype)
    for v, ri, ci in zip(vals, rows, cols):
        v = v.conj() if conj else v
        r = ri.long().clamp(max=m)[:, :, None].expand(v.shape)
        c = ci.long().clamp(max=n)[:, None, :].expand(v.shape)
        if transpose:
            M = M.index_put((c.clamp(max=m).flatten(), r.clamp(max=n).flatten()),
                            v.flatten(), accumulate=True)
        else:
            M = M.index_put((r.flatten(), c.flatten()), v.flatten(),
                            accumulate=True)
        if symmetric:
            M = M.index_put((c.clamp(max=m).flatten(),
                             r.clamp(max=n).flatten()), v.flatten(),
                            accumulate=True)
    return M[:m, :n]


def chunked_table(rng, n, dtype):
    """Two chunked buckets of an n x n operand (chunk 4 and 8), chunk ids
    repeating across blocks and one past n (its rows read zero)."""
    out = []
    for nb, mp, kp, C in ((3, 8, 16, 4), (2, 16, 8, 8)):
        vals = t(cvec(rng, nb, mp, kp, dtype=dtype))
        rc = t(rng.integers(0, n // C + 1, (nb, mp // C)).astype(np.int32))
        cc = t(rng.integers(0, n // C + 1, (nb, kp // C)).astype(np.int32))
        out.append((vals, rc, cc, C))
    return out


def element_table(rng, n, dtype):
    """Two element buckets of an n x n operand with repeats and sentinel
    lanes (index n)."""
    out = []
    for nb, mp, kp in ((4, 5, 3), (3, 2, 7)):
        ri = rng.integers(0, n + 1, (nb, mp)).astype(np.int32)
        ci = rng.integers(0, n + 1, (nb, kp)).astype(np.int32)
        out.append((t(cvec(rng, nb, mp, kp, dtype=dtype)), t(ri), t(ci), 1))
    return out


@pytest.mark.parametrize("kind", ["B1", "B9 element"])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("conj", [False, True])
def test_gradients_match_dense_autograd(kind, mode, conj):
    """x's and the values' cotangents of one launch over a table, in every
    mode, against autograd through the dense operator it applies."""
    rng = np.random.default_rng(13)
    n, r = 32, 3
    spec = (chunked_table if kind == "B1" else element_table)(
        rng, n, np.complex128)
    launch = (fused_spmm.multi_fused_apply if kind == "B1"
              else mask_select.element_fused_apply)
    rows = [fused_spmm.chunk_rows(rc, C) for _, rc, _, C in spec]
    cols = [fused_spmm.chunk_rows(cc, C) for _, _, cc, C in spec]
    x0 = t(cvec(rng, n, r))
    w = t(cvec(rng, n, r))

    def loss(y):
        return (y * w).sum().real + (y * y.conj()).real.sum()

    x1 = x0.clone().requires_grad_()
    v1 = [s[0].clone().requires_grad_() for s in spec]
    table = BucketTable([(v, rc, cc, C) for v, (_, rc, cc, C) in zip(v1, spec)])
    loss(launch(table, x1, out=torch.zeros(n, r, dtype=torch.complex128),
                conj=conj, **MODES[mode])).backward()
    x2 = x0.clone().requires_grad_()
    v2 = [s[0].clone().requires_grad_() for s in spec]
    M = dense_of(v2, rows, cols, (n, n), conj=conj,
                 transpose=mode == "transpose", symmetric=mode == "symmetric")
    loss(M @ x2).backward()
    assert relerr(x1.grad, x2.grad) < TOL
    for a, b in zip(v1, v2):
        assert relerr(a.grad, b.grad) < TOL


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("conj", [False, True])
def test_gradcheck_complex(mode, conj):
    """torch's own complex gradcheck (Wirtinger derivatives) on B1's and the
    element pass's autograd."""
    rng = np.random.default_rng(14)
    n = 24
    chunked = chunked_table(rng, n, np.complex128)
    elem = element_table(rng, n, np.complex128)
    x = t(cvec(rng, n, 2)).requires_grad_()
    vals = [s[0].clone().requires_grad_() for s in chunked + elem]

    def fn(x_, *v):
        tc = BucketTable([(vv, rc, cc, C)
                          for vv, (_, rc, cc, C) in zip(v, chunked)])
        te = BucketTable([(vv, ri, ci, 1)
                          for vv, (_, ri, ci, _c) in zip(v[len(chunked):],
                                                         elem)])
        y = fused_spmm.multi_fused_apply(
            tc, x_, out=torch.zeros(n, 2, dtype=torch.complex128), conj=conj,
            **MODES[mode])
        return mask_select.element_fused_apply(te, x_, out=y, conj=conj,
                                               **MODES[mode])
    assert torch.autograd.gradcheck(fn, (x, *vals))


@pytest.mark.parametrize("fmt", ["general", "symmetric"])
@pytest.mark.parametrize("op", ["A", "A.T", "A.H", "A.conj()"])
def test_operator_dx_matches_dense_autograd(fmt, op):
    """x's cotangent through a whole complex operator (both bucket kinds,
    the symmetric one's diagonal and off-diagonal passes) against
    autograd through its dense assembly."""
    rng = np.random.default_rng(15)
    if fmt == "general":
        blocks, rows, cols, shape = random_block_sparse(
            16, shape=(150, 150), nblocks=14, max_block=30,
            dtype=np.complex128)
        A = bt.BlockSparseMatrix(blocks, rows, cols, shape, device="cpu")
    else:
        A = bt.SymmetricBlockMatrix(*random_symmetric(
            17, n=160, ngroups=6, noffdiag=8, dtype=np.complex128),
            device="cpu")
    D = t(bt.to_scipy(A).toarray())
    wrap = {"A": (lambda a: a), "A.T": (lambda a: a.T),
            "A.H": (lambda a: a.H), "A.conj()": (lambda a: a.conj())}[op]
    dense = {"A": D, "A.T": D.T, "A.H": D.conj().T, "A.conj()": D.conj()}[op]
    x0 = t(cvec(rng, A.shape[0], 2))
    w = t(cvec(rng, A.shape[0], 2))
    x1, x2 = x0.clone().requires_grad_(), x0.clone().requires_grad_()
    ((wrap(A) @ x1) * w).sum().real.backward()
    ((dense @ x2) * w).sum().real.backward()
    assert relerr(x1.grad, x2.grad) < TOL


# -- routing: complex products take the bucket route only ------------------------

def complex64_operators():
    blocks, rows, cols, shape = random_block_sparse(
        19, shape=(512, 512), nblocks=24, max_block=64, dtype=np.complex64,
        contiguous=True)
    yield "general", bt.BlockSparseMatrix(blocks, rows, cols, shape,
                                          device="cpu", patch="always")
    yield "symmetric", bt.SymmetricBlockMatrix(*random_symmetric(
        20, n=512, ngroups=8, noffdiag=12, dtype=np.complex64,
        contiguous=True), device="cpu", patch="always")
    vb, rs, cs, vshape = random_vbcrs(21, dtype=np.complex64)
    yield "vbcrs", bt.VariableBlockCompressedRowStorage(
        vb, rs, cs, vshape, device="cpu", patch="always")


def test_no_complex_product_reaches_patch_or_stream(monkeypatch):
    """complex64 is the patch and stream kernels' element size, but not
    their type: under ``patch="always"`` every product of every format at
    r = 1 and r = 64 runs B1 / B9's element pass, and the patch engine and
    the stream route are never entered."""
    def refuse(*a, **k):
        raise AssertionError("a complex product reached an f32-only route")

    monkeypatch.setattr(patch_engine, "patch_apply", refuse)
    monkeypatch.setattr(stream_format.StreamRouted, "_stream_apply", refuse)
    launched = []
    for mod, name in ((fused_spmm, "multi_block_apply"),
                      (mask_select, "element_apply")):
        orig = getattr(mod, name)

        def spy(table, x, *, _orig=orig, _name=name, **kw):
            launched.append((_name, table.dtype, kw.get("conj", False)))
            return _orig(table, x, **kw)
        monkeypatch.setattr(mod, name, spy)
    rng = np.random.default_rng(22)
    for fmt, op in complex64_operators():
        assert not dispatch.patch_eligible(
            torch.zeros(op.shape[1], 64, dtype=torch.complex64), op.dtype,
            "always")
        assert not dispatch.strip_eligible(
            torch.zeros(op.shape[1], dtype=torch.complex64), op.dtype)
        S = bt.to_scipy(op).astype(np.complex128)
        for r in (1, 64):
            x = cvec(rng, *((op.shape[1],) if r == 1 else (op.shape[1], r)),
                     dtype=np.complex64)
            launched.clear()
            held(op @ t(x), None, S @ x, TOL64)
            held(op.H @ t(x), None, S.conj().T @ x, TOL64)
            assert launched and all(d == torch.complex64
                                    for _, d, _c in launched), (fmt, launched)
            assert any(c for _, _, c in launched), (fmt, launched)


# -- the slice as a whole: a complex Helmholtz BEM solve ------------------------

def helmholtz_system(npts=512, nclusters=8, thresh=0.9, k=4.0, self_term=8.0,
                     dtype=np.complex128):
    """``chip_smoke.py``'s phase-13 recipe at a small size: points on a
    Fibonacci sphere sorted by z, contiguous z-slice clusters,
    exp(i k r) / (4 pi r) blocks between clusters whose centres lie closer
    than ``thresh`` (each stored once), ``self_term`` on the diagonal."""
    i = np.arange(npts)
    z = 1 - 2 * (i + 0.5) / npts
    phi = np.pi * (3.0 - np.sqrt(5.0)) * i
    rho = np.sqrt(1 - z * z)
    pts = np.stack([rho * np.cos(phi), rho * np.sin(phi), z], axis=1)
    pts = pts[np.argsort(pts[:, 2], kind="stable")]
    bounds = np.linspace(0, npts, nclusters + 1).astype(int)
    clusters = [np.arange(bounds[c], bounds[c + 1]) for c in range(nclusters)]
    centers = np.stack([pts[c].mean(axis=0) for c in clusters])

    def block(ci, cj, diagonal):
        d = np.linalg.norm(pts[ci][:, None] - pts[cj][None], axis=-1)
        if diagonal:
            np.fill_diagonal(d, 1.0)  # replaced by the self-term below
        blk = np.exp(1j * k * d) / (4 * np.pi * np.maximum(d, 1e-9))
        if diagonal:
            blk[np.diag_indices_from(blk)] = self_term
        return blk.astype(dtype)

    diag, off, rows, cols = [], [], [], []
    for a in range(nclusters):
        diag.append(block(clusters[a], clusters[a], True))
        for b in range(a + 1, nclusters):
            if np.linalg.norm(centers[a] - centers[b]) < thresh:
                off.append(block(clusters[a], clusters[b], False))
                rows.append(clusters[a])
                cols.append(clusters[b])
    return diag, clusters, off, rows, cols, (npts, npts)


def test_helmholtz_bem_gmres_block_jacobi():
    """GMRES(20) + block_jacobi on the complex symmetric BEM system: the
    port's complex128 solve equals the JAX package's (iterations, x within
    1e-10) and scipy's solution; the complex64 solve converges to tol 1e-5
    on its preconditioned residual."""
    args = helmholtz_system()
    Sj = bst.SymmetricBlockMatrix(*args, backend="xla")
    Sp = bt.SymmetricBlockMatrix(*args, device="cpu")
    assert Sp.dtype == torch.complex128 and Sp.noffdiagonals > 0
    A = bt.to_scipy(Sp).toarray()
    assert relerr(A, A.T) < TOL  # complex symmetric, not Hermitian
    b = cvec(np.random.default_rng(23), Sp.shape[0])
    xp, ip = bt.gmres(Sp, t(b), M=bt.block_jacobi(Sp), tol=1e-12, restart=20)
    xj, ij = bst.gmres(Sj, jnp.asarray(b), M=bst.block_jacobi(Sj), tol=1e-12,
                       restart=20)
    assert bool(ip.converged) and int(ip.iterations) == int(ij.iterations)
    assert relerr(xp, np.asarray(xj)) < 1e-10
    assert relerr(xp, np.linalg.solve(A, b)) < 1e-9
    args64 = helmholtz_system(dtype=np.complex64)
    S64 = bt.SymmetricBlockMatrix(*args64, device="cpu")
    M64 = bt.block_jacobi(S64)
    b64 = t(b.astype(np.complex64))
    x64, i64 = bt.gmres(S64, b64, M=M64, tol=1e-5, restart=20)
    assert x64.dtype == torch.complex64 and bool(i64.converged)
    res = (M64 @ (b64 - S64 @ x64)).abs().pow(2).sum().sqrt()
    assert float(res) <= 2e-5 * float((M64 @ b64).abs().pow(2).sum().sqrt())


def test_batched_products_loop_on_complex(monkeypatch):
    """``batched_mm`` / ``batched_mv`` of complex operators loop over their
    products (B4 and B6 are f32), each on its complex bucket route."""
    from blocksparse_tpu_torch.ops import batched

    def refuse(*a, **k):
        raise AssertionError("a complex batch reached an f32 batched kernel")

    monkeypatch.setattr(batched, "batched_spmm_apply", refuse)
    monkeypatch.setattr(batched, "panel_apply_batched", refuse)
    rng = np.random.default_rng(24)
    blocks, rows, cols, shape = random_block_sparse(
        25, shape=(160, 160), nblocks=10, max_block=32, dtype=np.complex64,
        contiguous=True)
    ops = [bt.BlockSparseMatrix([b * s for b in blocks], rows, cols, shape,
                                device="cpu") for s in (1.0, 0.5 - 2j)]
    Xs = cvec(rng, 2, 160, 4, dtype=np.complex64)
    xs = cvec(rng, 2, 160, dtype=np.complex64)
    Ys, ys = batched.batched_mm(ops, t(Xs)), batched.batched_mv(ops, t(xs))
    for p, op in enumerate(ops):
        S = bt.to_scipy(op).astype(np.complex128)
        held(Ys[p], None, S @ Xs[p], TOL64)
        held(ys[p], None, S @ xs[p], TOL64)
