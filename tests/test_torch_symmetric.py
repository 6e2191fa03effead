"""The port's SymmetricBlockMatrix on the CPU: port vs JAX package vs scipy.

The same numpy blocks (``random_symmetric``, diagonal blocks left
nonsymmetric so that S^T != S) go into a JAX ``SymmetricBlockMatrix``
(``backend="xla"``, and ``"pallas-interpret"``, which reaches B1's
symmetric pass and ``_kern_mir``) and into the port's.  Products agree with
each other and with scipy at 1e-13 (f64) or 1e-5 (f32), relative to
max(1, max|ref|).  On CPU tensors the port runs its kernels' plain versions
through the routes the card uses: B3 for f32 r > 1, B1 for the rest, and
B9 for the gathers and scatter-adds of f32 element buckets at r = 1.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import blocksparse_tpu as bst
from blocksparse_tpu.core.layout import build_layout as jax_build_layout
from blocksparse_tpu.core.patch import build_patch_plan as jax_build_patch_plan
from blocksparse_tpu.ops import patch_engine as jax_patch

import blocksparse_tpu_torch as bt
from blocksparse_tpu_torch import coloring
from blocksparse_tpu_torch.core.layout import build_layout
from blocksparse_tpu_torch.core.patch import build_patch_plan
from blocksparse_tpu_torch.ops import patch_engine
from blocksparse_tpu_torch.ops.kernels import (fused_spmm, mask_select,
                                               panel_spmv)
from blocksparse_tpu_torch.utils.testmatrices import random_symmetric

torch.set_num_threads(2)

TOL64, TOL32 = 1e-13, 1e-5


def relerr(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    if a.size == 0:
        return 0.0
    return float(np.max(np.abs(a - b))) / max(1.0, float(np.max(np.abs(b))))


def fixture(kind, dtype=np.float64, symmetric_diag=False):
    """"contiguous" / "scattered" groups; "small" is a contiguous one sized
    for the interpret-mode Pallas kernels, which run slowly on the CPU."""
    size = (dict(n=160, ngroups=5, noffdiag=6) if kind == "small"
            else dict(n=288, ngroups=9, noffdiag=12))
    d, di, o, ri, ci, shape = random_symmetric(
        52 if kind == "scattered" else 51, dtype=np.float64,
        contiguous=kind != "scattered", **size)
    if symmetric_diag:
        d = [(b + b.T) / 2 for b in d]
    return ([b.astype(dtype) for b in d], di, [b.astype(dtype) for b in o],
            ri, ci, shape)


@functools.lru_cache(maxsize=None)
def operators(kind, dtype=np.float64, schedule="colored", pallas=False):
    """(JAX xla, JAX pallas-interpret or None, port, scipy) on one fixture;
    cached, since building the JAX operators dominates the run time."""
    args = fixture(kind, dtype)
    J = bst.SymmetricBlockMatrix(*args, backend="xla", schedule=schedule)
    P = bt.SymmetricBlockMatrix(*args, schedule=schedule, device="cpu")
    Jp = (bst.SymmetricBlockMatrix(*args, backend="pallas-interpret",
                                   schedule=schedule) if pallas else None)
    return J, Jp, P, bst.to_scipy(J)


def operands(n, dtype, seed=53):
    rng = np.random.default_rng(seed)
    return dict(x=rng.standard_normal(n).astype(dtype),
                X=rng.standard_normal((n, 3)).astype(dtype),
                y=rng.standard_normal(n).astype(dtype))


CASES = {
    "S @ x": (lambda A, v: A @ v["x"], lambda S, v: S @ v["x"]),
    "S @ X": (lambda A, v: A @ v["X"], lambda S, v: S @ v["X"]),
    "S.T @ x": (lambda A, v: A.T @ v["x"], lambda S, v: S.T @ v["x"]),
    "S.T @ X": (lambda A, v: A.T @ v["X"], lambda S, v: S.T @ v["X"]),
    "S.H @ X": (lambda A, v: A.H @ v["X"], lambda S, v: S.T @ v["X"]),
    "S.conj() @ x": (lambda A, v: A.conj() @ v["x"], lambda S, v: S @ v["x"]),
    "axpby": (lambda A, v: A.axpby(v["x"], v["y"], 2.0, 0.5),
              lambda S, v: 2.0 * (S @ v["x"]) + 0.5 * v["y"]),
    "(S @ S.T) @ X": (lambda A, v: (A @ A.T) @ v["X"],
                      lambda S, v: S @ (S.T @ v["X"])),
}


def to_torch(v):
    return {k: torch.from_numpy(a) for k, a in v.items()}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("kind", ["contiguous", "scattered"])
def test_port_matches_jax_and_scipy_f64(kind, case):
    J, _, P, S = operators(kind)
    assert relerr(S.toarray(), S.toarray().T) > 1e-3   # S^T != S
    v = operands(P.shape[0], np.float64)
    apply, oracle = CASES[case]
    got = apply(P, to_torch(v))
    assert got.dtype == torch.float64
    assert relerr(got, oracle(S, v)) <= TOL64
    assert relerr(got, apply(J, v)) <= TOL64


@pytest.mark.parametrize("case", ["S @ x", "S @ X", "S.T @ X"])
def test_port_matches_pallas_interpret_f64(case):
    """B1's symmetric pass in interpret mode vs the port's plain B1."""
    _, Jp, P, S = operators("small", pallas=True)
    v = operands(P.shape[0], np.float64)
    apply, oracle = CASES[case]
    got = apply(P, to_torch(v))
    assert relerr(got, apply(Jp, v)) <= TOL64
    assert relerr(got, oracle(S, v)) <= TOL64


def spy_on(fn_owner, name, store):
    orig = getattr(fn_owner, name)

    def wrapped(*a, **k):
        store.append(1)
        return orig(*a, **k)
    return orig, wrapped


@pytest.mark.parametrize("case", ["S @ x", "S @ X", "S.T @ x", "S.T @ X",
                                  "S.H @ X"])
def test_port_matches_jax_f32_routes(case):
    """f32: r > 1 takes the symmetric patch route (B3's plain version, on
    the plan for S or S^T) and r = 1 the stream route on the fused panel
    plan (B5's plain version): charged the port's H100 cost
    (``ops/panel_router.py::route_bytes``) it beats the bucket route here,
    where the JAX package takes the chunk-table route.  The JAX
    pallas-interpret operator runs _kern_mir."""
    J, Jp, P, S = operators("small", np.float32, pallas=True)
    v = operands(P.shape[0], np.float32)
    apply, oracle = CASES[case]
    b1, b3, b5 = [], [], []
    o1, w1 = spy_on(fused_spmm, "chunked_block_apply_plain", b1)
    o3, w3 = spy_on(patch_engine, "bucket_spmm_sym_plain", b3)
    o5, w5 = spy_on(panel_spmv, "panel_apply_plain", b5)
    try:
        fused_spmm.chunked_block_apply_plain = w1
        patch_engine.bucket_spmm_sym_plain = w3
        panel_spmv.panel_apply_plain = w5
        got = apply(P, to_torch(v))
    finally:
        fused_spmm.chunked_block_apply_plain = o1
        patch_engine.bucket_spmm_sym_plain = o3
        panel_spmv.panel_apply_plain = o5
    assert (len(b3) > 0) == ("X" in case) and (len(b5) > 0) == ("x" in case)
    assert not b1
    assert got.dtype == torch.float32
    v64 = {k: a.astype(np.float64) for k, a in v.items()}
    assert relerr(got, oracle(S, v64)) <= TOL32
    assert relerr(got, apply(Jp, v)) <= TOL32
    assert relerr(got, apply(J, v)) <= TOL32


@pytest.mark.parametrize("schedule", ["serial", "colored"])
@pytest.mark.parametrize("case", ["S @ x", "S.T @ x"])
def test_element_buckets_take_b9_f32(case, schedule):
    """f32 r = 1 on scattered index lists: the element buckets' gathers
    (and, without a colored plan, their scatter-adds) go through B9's
    plain versions, and the product matches the JAX package and scipy."""
    J, _, P, S = operators("scattered", np.float32, schedule=schedule)
    v = operands(P.shape[0], np.float32)
    apply, oracle = CASES[case]
    gathers, scatters = [], []
    og, wg = spy_on(mask_select, "mask_gather_plain", gathers)
    os_, ws = spy_on(mask_select, "mask_scatter_add_plain", scatters)
    try:
        mask_select.mask_gather_plain = wg
        mask_select.mask_scatter_add_plain = ws
        got = apply(P, to_torch(v))
    finally:
        mask_select.mask_gather_plain = og
        mask_select.mask_scatter_add_plain = os_
    assert gathers and (scatters or schedule == "colored")
    v64 = {k: a.astype(np.float64) for k, a in v.items()}
    assert relerr(got, oracle(S, v64)) <= TOL32
    assert relerr(got, apply(J, v)) <= TOL32


@pytest.mark.parametrize("r", [1, 3, 64])
@pytest.mark.parametrize("transpose", [False, True])
def test_patch_route_decision_matches_jax(transpose, r):
    """The port takes the symmetric patch route exactly where the JAX
    package's rule does; at r = 1 neither does (the JAX package's r = 1
    patch kernels run only under its BST_PATCH=always override)."""
    from blocksparse_tpu.ops.dispatch import patch_wins as jax_patch_wins
    from blocksparse_tpu_torch.ops.dispatch import patch_wins

    d, di, o, ri, ci, shape = fixture("small", np.float32)
    jd = jax_build_layout(d, di, di, shape, granularity="pow2")
    jo = jax_build_layout(o, ri, ci, shape, granularity="pow2")
    pd, po = build_layout(d, di, di, shape), build_layout(o, ri, ci, shape)
    ref = jax_build_patch_plan(jd, extra_layout=jo, transpose_main=transpose)
    mine = build_patch_plan(pd, extra_layout=po, transpose_main=transpose)
    assert patch_wins(mine, [(pd, 1), (po, 2)], r) == jax_patch_wins(
        ref, [(jd, 1), (jo, 2)], r)
    assert not patch_wins(mine, [(pd, 1), (po, 2)], 1)


def patch_pair(transpose_main):
    d, di, o, ri, ci, shape = fixture("small", np.float32)
    mine = build_patch_plan(build_layout(d, di, di, shape),
                            extra_layout=build_layout(o, ri, ci, shape),
                            transpose_main=transpose_main)
    ref = jax_build_patch_plan(
        jax_build_layout(d, di, di, shape, granularity="pow2"),
        extra_layout=jax_build_layout(o, ri, ci, shape, granularity="pow2"),
        transpose_main=transpose_main)
    return mine, ref, shape


@pytest.mark.parametrize("transpose_main", [False, True])
def test_b3_plain_vs_kern_mir_interpret(transpose_main, r=3):
    mine, ref, shape = patch_pair(transpose_main)
    X = np.random.default_rng(54).standard_normal((shape[0], r)).astype(
        np.float32)
    want = jax_patch.patch_spmm(ref, jax_patch.patch_device_arrays(ref),
                                jnp.asarray(X), interpret=True)
    dev = patch_engine.patch_device_arrays(mine, "cpu")
    got = patch_engine.patch_spmm_plain(mine, dev, torch.from_numpy(X))
    assert relerr(got.numpy(), want) <= TOL32
    before = patch_engine.SYM_LAUNCHES
    wrapped = patch_engine.patch_spmm(mine, dev, torch.from_numpy(X))
    assert torch.equal(wrapped, got)
    assert patch_engine.SYM_LAUNCHES == before


def test_b3_adjoint_is_the_transposed_plan():
    """B3's adjoint mode on the plan for S equals the plan for S^T."""
    plan_n, _, shape = patch_pair(False)
    plan_t, _, _ = patch_pair(True)
    X = torch.from_numpy(np.random.default_rng(55).standard_normal(
        (shape[0], 4)))
    dev_n = [tuple(t.double() if t.is_floating_point() else t for t in b)
             for b in patch_engine.patch_device_arrays(plan_n, "cpu")]
    dev_t = [tuple(t.double() if t.is_floating_point() else t for t in b)
             for b in patch_engine.patch_device_arrays(plan_t, "cpu")]
    adj = patch_engine.bucket_spmm_sym(*dev_n[0], X, adjoint=True)
    assert relerr(adj, patch_engine.patch_spmm_plain(plan_t, dev_t, X)) <= TOL64
    with pytest.raises(ValueError, match="transpose_main"):
        patch_engine.patch_spmm_plain(plan_n, dev_n, X, transpose=True)


@pytest.mark.parametrize("adjoint", [False, True])
def test_b3_gradcheck(adjoint):
    plan, _, shape = patch_pair(False)
    vals, cc, rs, mk = patch_engine.patch_device_arrays(plan, "cpu")[0]
    keep = torch.nonzero(mk > 0)[:3, 0]
    vals = vals[keep].double().requires_grad_()
    cc, rs, mk = cc[keep], rs[keep], mk[keep]
    X = torch.randn(shape[0], 2, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda v_, x_: patch_engine._PatchSpmmSym.apply(v_, cc, rs, mk, x_,
                                                        adjoint),
        (vals, X), fast_mode=True)


def test_gradients_match_jax_grad_f64():
    J, _, P, _ = operators("scattered")
    rng = np.random.default_rng(56)
    X = rng.standard_normal((P.shape[0], 2))
    W = rng.standard_normal((P.shape[0], 2))
    for op in (lambda A: A, lambda A: A.T):
        want = jax.grad(lambda X_: jnp.vdot(jnp.asarray(W), op(J) @ X_))(
            jnp.asarray(X))
        Xt = torch.from_numpy(X).requires_grad_()
        (torch.from_numpy(W) * (op(P) @ Xt)).sum().backward()
        assert relerr(Xt.grad, want) <= TOL64
        xt = torch.from_numpy(X[:, 0].copy()).requires_grad_()
        (torch.from_numpy(W[:, 0]) * (op(P) @ xt)).sum().backward()
        assert relerr(xt.grad, want[:, 0]) <= TOL64


def test_gradients_through_b3_and_b1_f32():
    J, _, P, S = operators("contiguous", np.float32)
    rng = np.random.default_rng(57)
    X = rng.standard_normal((P.shape[0], 3)).astype(np.float32)
    W = rng.standard_normal((P.shape[0], 3)).astype(np.float32)
    for r in (3, 1):
        Xr, Wr = (X, W) if r > 1 else (X[:, 0].copy(), W[:, 0].copy())
        want = jax.grad(lambda X_: jnp.vdot(jnp.asarray(Wr), J @ X_))(
            jnp.asarray(Xr))
        Xt = torch.from_numpy(Xr).requires_grad_()
        (torch.from_numpy(Wr) * (P @ Xt)).sum().backward()
        assert relerr(Xt.grad, want) <= TOL32
        assert relerr(Xt.grad, S.T @ Wr.astype(np.float64)) <= TOL32


@pytest.mark.parametrize("kind", ["contiguous", "scattered"])
def test_serial_vs_colored_duality(kind):
    _, _, P_ser, S = operators(kind, schedule="serial")
    _, _, P_col, _ = operators(kind, schedule="colored")
    assert P_ser.schedule == bt.SERIAL and P_col.schedule == bt.COLORED
    v = operands(P_ser.shape[0], np.float64, seed=58)
    for case in ("S @ x", "S.T @ X"):
        apply = CASES[case][0]
        a, b = apply(P_ser, to_torch(v)), apply(P_col, to_torch(v))
        assert relerr(a, b) <= TOL64
        assert relerr(b, CASES[case][1](S, v)) <= TOL64


@pytest.mark.parametrize("schedule", ["serial", "colored"])
def test_accessors_match_jax(schedule):
    J, _, P, S = operators("scattered", schedule=schedule)
    assert (P.ndiagonals, P.noffdiagonals) == (J.ndiagonals, J.noffdiagonals)
    assert bt.nnz(P) == bst.nnz(J) == bt.nnz(P.T) == bt.nnz(P.H)
    expect = sum(P.diagonal(i).size for i in range(P.ndiagonals)) + 2 * sum(
        P.offdiagonal(i).size for i in range(P.noffdiagonals))
    assert P.nnz == expect
    # the four color sets are computed under either schedule
    assert P.diagonalcolors() == J.diagonalcolors()
    assert P.offdiagonalcolors() == J.offdiagonalcolors()
    assert P.transposeoffdiagonalcolors() == J.transposeoffdiagonalcolors()
    assert P.fusedcolors() == J.fusedcolors()
    union = [np.concatenate([P.blockrowindices(i), P.blockcolindices(i)])
             for i in range(P.noffdiagonals)]
    assert coloring.validate_coloring(union, P.fusedcolors())
    for i in range(P.ndiagonals):
        np.testing.assert_array_equal(P.diagonal(i), J.diagonal(i))
        np.testing.assert_array_equal(P.diagonalindices(i), J.diagonalindices(i))
    for i in range(P.noffdiagonals):
        np.testing.assert_array_equal(P.offdiagonal(i), J.offdiagonal(i))
        np.testing.assert_array_equal(bt.rowindices(P.T, i),
                                      bst.rowindices(J.T, i))
    for mine, ref in zip(bt.rowcolvals(P), bst.rowcolvals(J)):
        np.testing.assert_array_equal(mine, ref)   # emission order too
    assert (bt.to_scipy(P) != S).nnz == 0
    assert relerr(P.todense(), S.toarray()) <= TOL64
    for op in (P, P.T, P.H):
        assert "SymmetricBlockMatrix" in repr(op) or "Operator" in repr(op)


def test_from_reference_carries_symmetric():
    J, _, _, S = operators("scattered")
    P = bt.from_reference(J, schedule="serial", device="cpu")
    assert isinstance(P, bt.SymmetricBlockMatrix)
    assert P.schedule == bt.SERIAL and P.fusedcolors() == J.fusedcolors()
    for mine, ref in zip(bt.rowcolvals(P), bst.rowcolvals(J)):
        np.testing.assert_array_equal(mine, ref)
    v = operands(P.shape[0], np.float64, seed=59)
    for case in ("S @ X", "S.T @ x", "axpby"):
        apply, oracle = CASES[case]
        got = apply(P, to_torch(v))
        assert got.dtype == torch.float64
        assert relerr(got, apply(J, v)) <= TOL64
        assert relerr(got, oracle(S, v)) <= TOL64


def test_symmetric_diagonals_give_a_symmetric_matrix():
    P = bt.SymmetricBlockMatrix(*fixture("contiguous", symmetric_diag=True),
                                device="cpu")
    S = bt.to_scipy(P).toarray()
    assert relerr(S, S.T) <= TOL64
    y = torch.from_numpy(np.random.default_rng(60).standard_normal(P.shape[0]))
    assert relerr(P @ y, P.T @ y) <= TOL64


def test_unsorted_index_lists():
    """Permuting a block's rows/cols with its index lists leaves S as it is."""
    d, di, o, ri, ci, shape = fixture("scattered")
    prng = np.random.default_rng(5)
    d2, di2, o2, ri2, ci2 = [], [], [], [], []
    for b, g in zip(d, di):
        p = prng.permutation(len(g))
        d2.append(b[p][:, p])
        di2.append(np.asarray(g)[p])
    for b, r, c in zip(o, ri, ci):
        pr, pc = prng.permutation(len(r)), prng.permutation(len(c))
        o2.append(b[pr][:, pc])
        ri2.append(np.asarray(r)[pr])
        ci2.append(np.asarray(c)[pc])
    S = bt.to_scipy(bt.SymmetricBlockMatrix(d, di, o, ri, ci, shape,
                                            device="cpu"))
    for schedule in ("serial", "colored"):
        P = bt.SymmetricBlockMatrix(d2, di2, o2, ri2, ci2, shape,
                                    schedule=schedule, device="cpu")
        x = np.random.default_rng(61).standard_normal(shape[0])
        assert relerr(P @ torch.from_numpy(x), S @ x) <= TOL64
        assert relerr(P.T @ torch.from_numpy(x), S.T @ x) <= TOL64


def test_zero_blocks_and_bad_inputs():
    P = bt.SymmetricBlockMatrix([], [], [], [], [], (6, 6), device="cpu")
    got = P @ torch.arange(6.0, dtype=torch.float64)
    assert got.shape == (6,) and not got.any()
    args = fixture("contiguous")
    with pytest.raises(ValueError, match="square"):
        bt.SymmetricBlockMatrix(*args[:5], (288, 290), device="cpu")
    with pytest.raises(ValueError, match="granularity"):
        bt.SymmetricBlockMatrix(*args, granularity="exact", device="cpu")
    # complex dtypes build and apply (tests/test_torch_complex.py covers them)
    d, di, o, ri, ci, shape = fixture("contiguous", np.complex128)
    C = bt.SymmetricBlockMatrix([b * (1 + 2j) for b in d], di,
                                [b * (2 - 1j) for b in o], ri, ci, shape,
                                device="cpu")
    assert C.dtype == torch.complex128
    xc = np.random.default_rng(62).standard_normal(288) * (1 + 1j)
    got = (C.H @ torch.from_numpy(xc)).numpy()
    want = bt.to_scipy(C).conj().T @ xc
    assert np.abs(got - want).max() <= TOL64 * max(1.0, np.abs(want).max())
    with pytest.raises(ValueError, match="precision"):
        bt.SymmetricBlockMatrix(*args, precision="fast", device="cpu")
    P = bt.SymmetricBlockMatrix(*args, device="cpu")
    # an operand of another dtype is promoted (tests/test_torch_options.py)
    x32 = torch.from_numpy(np.random.default_rng(63).standard_normal(288)
                           .astype(np.float32))
    got = P @ x32
    assert got.dtype == torch.float64
    assert relerr(got, P @ x32.double()) == 0
    with pytest.raises(ValueError, match="operand length"):
        P @ torch.zeros(287, dtype=torch.float64)
