"""The port's VariableBlockCompressedRowStorage on the CPU.

Mirrors ``tests/test_vbcrs.py`` on the port: oracle products against scipy
(1e-13 in float64, 1e-5 relative to max(1, max|ref|) in float32), the
(row, col) sort and ``rowptr`` equal to the JAX package's, cross-format
products against the port's BSM and SBM, the contiguity errors, unsorted
input and ``repr``; and the port against a JAX VBCRS on the same numpy
blocks.  f32 vector products take the stream route where the JAX decision
does (kernel B5/B8's plain version on the CPU), r = 7 the patch or bucket
route.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import blocksparse_tpu as bst
from blocksparse_tpu.utils import testmatrices as jtm

import blocksparse_tpu_torch as bt
from blocksparse_tpu_torch.ops.kernels import panel_spmv
from blocksparse_tpu_torch.utils.testmatrices import (random_symmetric,
                                                      random_vbcrs)

torch.set_num_threads(2)

TOL = {np.float64: 1e-13, np.float32: 1e-5}


def relerr(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    if a.size == 0:
        return 0.0
    return float(np.max(np.abs(a - b))) / max(1.0, float(np.max(np.abs(b))))


@functools.lru_cache(maxsize=None)
def build(seed=3, dtype=np.float64, schedule="serial"):
    """(port VBCRS, JAX VBCRS (xla), float64 scipy oracle, inputs)."""
    blocks, rs, cs, shape = random_vbcrs(seed, dtype=dtype)
    kw = dict(schedule=schedule, granularity=(32, 32))
    V = bt.VariableBlockCompressedRowStorage(blocks, rs, cs, shape, **kw,
                                             device="cpu")
    J = bst.VariableBlockCompressedRowStorage(blocks, rs, cs, shape,
                                              backend="xla", **kw)
    S = bst.to_scipy(bst.VariableBlockCompressedRowStorage(
        [b.astype(np.float64) for b in blocks], rs, cs, shape))
    return V, J, S, (blocks, rs, cs, shape)


CASES = {
    "V @ x": (lambda A, v: A @ v["x"], lambda S, v: S @ v["x"]),
    "V.T @ y": (lambda A, v: A.T @ v["y"], lambda S, v: S.T @ v["y"]),
    "V.H @ y": (lambda A, v: A.H @ v["y"], lambda S, v: S.T @ v["y"]),
    "V @ X": (lambda A, v: A @ v["X"], lambda S, v: S @ v["X"]),
    "V.T @ Y": (lambda A, v: A.T @ v["Y"], lambda S, v: S.T @ v["Y"]),
    "V.H @ Y": (lambda A, v: A.H @ v["Y"], lambda S, v: S.T @ v["Y"]),
    "axpby": (lambda A, v: A.axpby(v["x"], v["y"], 2.0, 3.0),
              lambda S, v: 2.0 * (S @ v["x"]) + 3.0 * v["y"]),
}


def operands(m, n, dtype, seed=71):
    rng = np.random.default_rng(seed)
    return dict(x=rng.standard_normal(n).astype(dtype),
                y=rng.standard_normal(m).astype(dtype),
                X=rng.standard_normal((n, 7)).astype(dtype),
                Y=rng.standard_normal((m, 7)).astype(dtype))


def to_torch(v):
    return {k: torch.from_numpy(a) for k, a in v.items()}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype,schedule", [
    (np.float64, "serial"), (np.float64, "colored"),
    (np.float32, "serial"), (np.float32, "colored")])
def test_oracle_products(dtype, schedule, case):
    V, J, S, _ = build(dtype=dtype, schedule=schedule)
    v = operands(*V.shape, dtype)
    apply, oracle = CASES[case]
    got = apply(V, to_torch(v))
    assert got.dtype == (torch.float64 if dtype == np.float64
                         else torch.float32)
    v64 = {k: a.astype(np.float64) for k, a in v.items()}
    assert relerr(got, oracle(S, v64)) <= TOL[dtype]
    assert relerr(got, apply(J, v)) <= TOL[dtype]


def test_f32_vector_products_take_the_stream_route():
    V, _, S, _ = build(dtype=np.float32)
    ran = []
    orig = panel_spmv.panel_apply_plain

    def spy(*a, **k):
        ran.append(1)
        return orig(*a, **k)
    panel_spmv.panel_apply_plain = spy
    try:
        for op in (V, V.T):
            x = np.random.default_rng(72).standard_normal(
                op.shape[1]).astype(np.float32)
            before = len(ran)
            y = op @ torch.from_numpy(x)
            choice = V._stream_entry(op is not V)[0]
            assert choice == "panel" and len(ran) == before + 1
            ref = (S if op is V else S.T) @ x.astype(np.float64)
            assert relerr(y, ref) <= TOL[np.float32]
    finally:
        panel_spmv.panel_apply_plain = orig


def test_port_matches_jax_pallas_interpret_f32():
    """The JAX VBCRS on the pallas-interpret backend runs its panel kernel
    (test_panel.py::test_routing_uses_panel_when_cheaper); the port runs
    B5's plain version on the same plan."""
    blocks, rs, cs, shape = jtm.random_vbcrs(16, dtype=np.float32)
    J = bst.VariableBlockCompressedRowStorage(blocks, rs, cs, shape,
                                              backend="pallas-interpret")
    V = bt.VariableBlockCompressedRowStorage(blocks, rs, cs, shape,
                                             device="cpu")
    x = np.random.default_rng(73).standard_normal(shape[1]).astype(np.float32)
    got = V @ torch.from_numpy(x)
    assert V._stream_entry(False)[0] == "panel"
    assert relerr(got, np.asarray(J @ jnp.asarray(x))) <= TOL[np.float32]


def test_sorted_csr_structure_equals_jax():
    V, J, _, (blocks, rs, cs, shape) = build()
    assert V.rowptr == J.rowptr
    assert V.nblockrows == J.nblockrows and V.nblocks == J.nblocks
    assert V.rowptr[0] == 0 and V.rowptr[-1] == V.nblocks
    keys = [(V.row_start(i), V.col_start(i)) for i in range(V.nblocks)]
    assert keys == sorted(keys)
    assert keys == [(J.row_start(i), J.col_start(i))
                    for i in range(J.nblocks)]
    for i in range(V.nblocks):
        assert np.array_equal(V.block(i), J.block(i))
        assert np.array_equal(V.blockrowindices(i), J.blockrowindices(i))
        assert np.array_equal(V.blockcolindices(i), J.blockcolindices(i))
    starts = [V.row_start(V.rowptr[r]) for r in range(V.nblockrows)]
    assert starts == sorted(starts) and len(set(starts)) == len(starts)
    assert list(V.blockrow_starts) == starts
    assert V.nnz == J.nnz == bt.nnz(V.T)


def test_cross_format_vs_block_sparse():
    V, _, _, (blocks, rs, cs, shape) = build()
    rows = [np.arange(r, r + b.shape[0]) for r, b in zip(rs, blocks)]
    cols = [np.arange(c, c + b.shape[1]) for c, b in zip(cs, blocks)]
    B = bt.BlockSparseMatrix(blocks, rows, cols, shape, device="cpu")
    x = torch.from_numpy(np.random.default_rng(74).standard_normal(shape[1]))
    assert relerr(B @ x, V @ x) <= TOL[np.float64]
    V2 = bt.VariableBlockCompressedRowStorage.from_block_sparse(B)
    assert relerr(V2 @ x, V @ x) <= TOL[np.float64]
    assert V2.nnz == V.nnz and V2.schedule == B.schedule
    assert relerr(bt.to_scipy(V2).toarray(), bt.to_scipy(V).toarray()) == 0


def test_from_symmetric_expansion():
    d, di, o, ri, ci, shape = random_symmetric(
        5, n=600, ngroups=20, noffdiag=30, dtype=np.float64, contiguous=True)
    S_op = bt.SymmetricBlockMatrix(d, di, o, ri, ci, shape, device="cpu")
    V = bt.VariableBlockCompressedRowStorage.from_symmetric(S_op)
    x = torch.from_numpy(np.random.default_rng(75).standard_normal(shape[1]))
    assert relerr(V @ x, S_op @ x) <= TOL[np.float64]
    assert relerr(V.T @ x, S_op.T @ x) <= TOL[np.float64]
    assert V.nblocks == S_op.ndiagonals + 2 * S_op.noffdiagonals
    assert V.nnz == bt.nnz(S_op)
    assert V.schedule == S_op.schedule


def test_contiguity_validation():
    blocks = [np.ones((2, 2))]
    with pytest.raises(ValueError, match="contiguous range"):
        bt.VariableBlockCompressedRowStorage(
            blocks, [np.array([0, 2])], [np.array([0, 1])], (4, 4),
            device="cpu")
    with pytest.raises(ValueError, match="index list length 3 != block "
                                         "extent 2"):
        bt.VariableBlockCompressedRowStorage(
            blocks, [np.array([0, 1])], [np.array([0, 1, 2])], (4, 4),
            device="cpu")
    # check=False takes the first index as the start, as the JAX package
    v0 = bt.VariableBlockCompressedRowStorage(
        blocks, [np.array([1, 3])], [0], (4, 4), check=False, device="cpu")
    assert v0.row_start(0) == 1
    # scalar starts and full ranges both accepted
    v1 = bt.VariableBlockCompressedRowStorage(blocks, [0], [1], (4, 4),
                                              device="cpu")
    v2 = bt.VariableBlockCompressedRowStorage(
        blocks, [np.array([0, 1])], [np.array([1, 2])], (4, 4), device="cpu")
    assert relerr(v1.todense(), v2.todense()) == 0
    with pytest.raises(ValueError, match="shape"):
        bt.VariableBlockCompressedRowStorage(blocks, [0], [0], device="cpu")


def test_unsorted_input_blocks():
    blocks, rs, cs, shape = random_vbcrs(7)
    perm = np.random.default_rng(76).permutation(len(blocks))
    V1 = bt.VariableBlockCompressedRowStorage(blocks, rs, cs, shape,
                                              device="cpu")
    V2 = bt.VariableBlockCompressedRowStorage(
        [blocks[i] for i in perm], [rs[i] for i in perm],
        [cs[i] for i in perm], shape, device="cpu")
    assert V1.rowptr == V2.rowptr
    x = torch.from_numpy(np.random.default_rng(77).standard_normal(shape[1]))
    assert relerr(V1 @ x, V2 @ x) <= TOL[np.float64]


def test_repr_interop_and_empty():
    V, J, S, _ = build()
    text = repr(V)
    assert text.startswith("VariableBlockCompressedRowStorage(1200x1200, ")
    assert f"{V.nblocks} blocks in {V.nblockrows} block rows" in text
    assert "schedule='serial'" in text
    for op in (V, V.T, V.H):
        repr(op)
    assert relerr(bt.to_scipy(V).toarray(), S.toarray()) == 0
    r, c, v = bt.rowcolvals(V)
    assert r.size == c.size == v.size == V.nnz
    P = bt.from_reference(J, granularity=(32, 32), device="cpu")
    assert isinstance(P, bt.VariableBlockCompressedRowStorage)
    assert P.rowptr == V.rowptr
    x = torch.from_numpy(np.random.default_rng(78).standard_normal(1200))
    assert relerr(P @ x, V @ x) == 0
    E = bt.VariableBlockCompressedRowStorage([], [], [], (5, 4), device="cpu")
    assert E.nblocks == 0 and E.rowptr == (0, 0)
    assert not (E @ torch.zeros(4, dtype=torch.float64)).any()


def test_bad_operands_and_options():
    V, *_ = build()
    # an operand of another dtype is promoted (tests/test_torch_options.py)
    x32 = torch.from_numpy(np.random.default_rng(79).standard_normal(1200)
                           .astype(np.float32))
    got = V @ x32
    assert got.dtype == torch.float64
    assert relerr(got, V @ x32.double()) == 0
    with pytest.raises(ValueError, match="operand length"):
        V @ torch.zeros(1199, dtype=torch.float64)
    blocks, rs, cs, shape = random_vbcrs(3)
    with pytest.raises(ValueError, match="precision"):
        bt.VariableBlockCompressedRowStorage(blocks, rs, cs, shape,
                                             precision="fast", device="cpu")
    # complex dtypes build and apply (tests/test_torch_complex.py covers them)
    C = bt.VariableBlockCompressedRowStorage(
        [b.astype(np.complex128) * (2 - 1j) for b in blocks], rs, cs, shape,
        device="cpu")
    assert C.dtype == torch.complex128
    xc = np.random.default_rng(80).standard_normal(shape[1]) * (1 + 1j)
    got = (C.conj() @ torch.from_numpy(xc)).numpy()
    want = bt.to_scipy(C).conj() @ xc
    assert np.abs(got - want).max() <= TOL[np.float64] * max(
        1.0, np.abs(want).max())


def test_gradient_matches_transpose_f64_and_f32():
    for dtype in (np.float64, np.float32):
        V, J, S, _ = build(dtype=dtype)
        rng = np.random.default_rng(79)
        x = torch.from_numpy(rng.standard_normal(V.shape[1]).astype(dtype))
        w = rng.standard_normal(V.shape[0]).astype(dtype)
        x.requires_grad_()
        (torch.from_numpy(w) * (V @ x)).sum().backward()
        assert relerr(x.grad, S.T @ w.astype(np.float64)) <= TOL[dtype]
