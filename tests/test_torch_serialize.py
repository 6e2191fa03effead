"""The port's interop modules on the CPU, held to the JAX package.

- ``save`` / ``load`` (``interop/serialize.py``): every case of
  ``tests/test_serialize.py``, and cross-loading in both directions for
  each format in float32, float64, complex64 and complex128 (a file the JAX
  package saved loads in the port and one the port saved loads in the JAX
  package, with equal products and settings); bf16 both ways (the port
  writes float32 values and a ``dtype`` key, and reads the JAX package's
  raw ``|V2`` blocks by their bits);
- ``to_bcoo`` / ``from_bcoo`` (``interop/bcoo.py``): every case of
  ``tests/test_bcoo.py`` on torch sparse COO tensors, and ``to_bcoo``'s
  indices and values against the JAX ``to_bcoo(A).indices`` / ``.data``;
- ``spy`` / ``show`` / ``blocksummary`` (``interop/viz.py``): the strings
  character-equal to the JAX package's.

Tolerances: 1e-13 relative to max(1, max|ref|) for f64 / c128, 1e-6 for f32
/ c64 (the JAX tests' own).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import blocksparse_tpu as bst
import blocksparse_tpu_torch as bt
from blocksparse_tpu_torch.utils.testmatrices import (random_block_sparse,
                                                      random_symmetric,
                                                      random_vbcrs)

torch.set_num_threads(2)

TOL = 1e-13
TOLS = {"float32": 1e-6, "complex64": 1e-6, "float64": TOL,
        "complex128": TOL}
KINDS = {"general": "BlockSparseMatrix", "symmetric": "SymmetricBlockMatrix",
         "vbcrs": "VariableBlockCompressedRowStorage"}


def relerr(a, b):
    a = np.asarray(a, dtype=np.complex128)
    b = np.asarray(b, dtype=np.complex128)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(1.0, float(np.max(np.abs(b))) if b.size else 1.0)
    return float(np.max(np.abs(a - b))) / scale if b.size else 0.0


def vec(rng, n, dtype=np.float64):
    x = rng.standard_normal(n)
    if np.issubdtype(np.dtype(dtype), np.complexfloating):
        x = x + 1j * rng.standard_normal(n)
    return x.astype(dtype)


# -- tests/test_serialize.py ---------------------------------------------------


def test_roundtrip_block_sparse(tmp_path):
    rng = np.random.default_rng(1234)
    blocks, rows, cols, shape = random_block_sparse(
        71, shape=(300, 300), nblocks=20, max_block=30, dtype=np.complex128)
    A = bt.BlockSparseMatrix(blocks, rows, cols, shape, schedule="colored",
                             device="cpu")
    p = tmp_path / "a.npz"
    bt.save(p, A)
    B = bt.load(p, device="cpu")
    x = torch.from_numpy(vec(rng, 300, np.complex128))
    assert relerr(B @ x, A @ x) < TOL
    assert B.schedule == A.schedule and B.nnz == A.nnz and B.shape == A.shape


def test_roundtrip_symmetric(tmp_path):
    rng = np.random.default_rng(1234)
    d, di, o, ri, ci, shape = random_symmetric(
        72, n=250, ngroups=8, noffdiag=10, dtype=np.complex128)
    S = bt.SymmetricBlockMatrix(d, di, o, ri, ci, shape, device="cpu")
    p = tmp_path / "s.npz"
    bt.save(p, S)
    S2 = bt.load(p, device="cpu")
    x = torch.from_numpy(vec(rng, 250, np.complex128))
    assert relerr(S2 @ x, S @ x) < TOL
    assert relerr(S2.H @ x, S.H @ x) < TOL
    assert S2.nnz == S.nnz


def test_roundtrip_vbcrs(tmp_path):
    rng = np.random.default_rng(1234)
    blocks, rs, cs, shape = random_vbcrs(73, shape=(300, 300), nrowgroups=6,
                                         ncolgroups=6)
    V = bt.VariableBlockCompressedRowStorage(blocks, rs, cs, shape,
                                             device="cpu")
    p = tmp_path / "v.npz"
    bt.save(p, V)
    V2 = bt.load(p, device="cpu", backend="xla")
    assert V2._backend == "xla"
    x = torch.from_numpy(rng.standard_normal(300))
    assert relerr(V2 @ x, V @ x) < TOL
    assert V2.rowptr == V.rowptr


def test_roundtrip_autotune_policy(tmp_path):
    """The measured winners travel with the file: the port keeps them on
    the loaded operator, applies no policy (one engine per device), and a
    second save writes them back unchanged; the JAX ``load`` re-registers
    a port-saved file's winners."""
    blocks, rows, cols, shape = random_block_sparse(
        75, shape=(256, 256), nblocks=12, max_block=32, dtype=np.float32)
    A = bt.BlockSparseMatrix(blocks, rows, cols, shape, device="cpu")
    A._autotune_reports = {
        "spmv": {"kind": "spmv", "winner": "pallas", "applied": True},
        "spmm": {"kind": "spmm", "winner": "xla", "applied": True},
    }
    p, q = tmp_path / "tuned.npz", tmp_path / "again.npz"
    bt.save(p, A)
    B = bt.load(p, device="cpu")
    assert B._autotune_reports["spmv"]["winner"] == "pallas"
    assert B._autotune_reports["spmm"]["winner"] == "xla"
    assert not B._autotune_reports["spmv"]["applied"]
    bt.save(q, B)
    with np.load(p) as a, np.load(q) as b:
        assert json.loads(str(a["autotune"])) == json.loads(str(b["autotune"]))
    from blocksparse_tpu.ops.dispatch import _POPULATION_POLICY, auto_policy

    _POPULATION_POLICY.clear()
    try:
        J = bst.load(q)
        assert auto_policy("spmv", J._layout) == "pallas"
        assert auto_policy("spmm", J._layout) == "xla"
    finally:
        _POPULATION_POLICY.clear()
    C = bt.BlockSparseMatrix(blocks, rows, cols, shape, device="cpu")
    bt.save(p, C)
    with np.load(p) as a:
        assert "autotune" not in a


def test_save_wrapper_rejected(tmp_path):
    blocks, rows, cols, shape = random_block_sparse(
        74, shape=(100, 100), nblocks=5, max_block=10, dtype=np.float64)
    A = bt.BlockSparseMatrix(blocks, rows, cols, shape, device="cpu")
    with pytest.raises(TypeError):
        bt.save(tmp_path / "t.npz", A.T)


def test_roundtrip_optimize(tmp_path):
    blocks, rows, cols, shape = random_block_sparse(
        81, shape=(256, 256), nblocks=6, max_block=32, dtype=np.float32,
        contiguous=True)
    A = bt.BlockSparseMatrix(blocks, rows, cols, shape, optimize="latency",
                             device="cpu")
    p = tmp_path / "opt.npz"
    bt.save(p, A)
    assert bt.load(p, device="cpu")._optimize == "latency"
    assert bt.load(p, device="cpu", optimize="throughput")._optimize == \
        "throughput"
    D0 = bt.BlockSparseMatrix(blocks, rows, cols, shape, device="cpu")
    bt.save(p, D0)
    assert bt.load(p, device="cpu")._optimize is None


# -- cross-loading -------------------------------------------------------------


def construction(fmt, dtype):
    if fmt == "general":
        return random_block_sparse(76, shape=(200, 180), nblocks=14,
                                   max_block=24, dtype=dtype)
    if fmt == "symmetric":
        return random_symmetric(77, n=200, ngroups=8, noffdiag=9, dtype=dtype)
    return random_vbcrs(78, shape=(200, 180), nrowgroups=6, ncolgroups=5,
                        dtype=dtype)


SETTINGS = {"general": dict(schedule="auto", precision=None,
                            granularity=(8, 16), scatter="sorted",
                            optimize="latency", backend="pallas"),
            "symmetric": dict(schedule="serial", precision="high",
                              granularity=(4, 4), optimize="throughput"),
            "vbcrs": dict(schedule="colored", granularity="pow2",
                          scatter="sorted", backend="xla")}


def settings_of(op):
    return {"schedule": op._schedule, "precision": op._precision,
            "granularity": tuple(op._granularity)
            if not isinstance(op._granularity, str) else op._granularity,
            "scatter": getattr(op, "_scatter", "atomic"),
            "optimize": op._optimize, "backend": op._backend}


def products_equal(port, jax_op, dtype, rng):
    for transpose in (False, True):
        n = port.shape[0] if transpose else port.shape[1]
        x = vec(rng, n, dtype)
        got = port.apply(torch.from_numpy(x), transpose=transpose)
        want = np.asarray((jax_op.T if transpose else jax_op)
                          @ jnp.asarray(x))
        assert str(got.dtype).split(".")[1] == str(want.dtype)
        assert relerr(got.numpy(), want) < TOLS[np.dtype(dtype).name]


@pytest.mark.parametrize("fmt", list(KINDS))
@pytest.mark.parametrize("dtype", ["float32", "float64", "complex64",
                                   "complex128"])
def test_jax_file_loads_in_the_port(fmt, dtype, tmp_path):
    args = construction(fmt, np.dtype(dtype))
    J = getattr(bst, KINDS[fmt])(*args, **SETTINGS[fmt])
    p = tmp_path / "jax.npz"
    bst.save(p, J)
    P = bt.load(p, device="cpu")
    assert type(P).__name__ == KINDS[fmt]
    assert P.dtype == getattr(torch, dtype)
    assert settings_of(P) == settings_of(J)
    products_equal(P, J, dtype, np.random.default_rng(79))


@pytest.mark.parametrize("fmt", list(KINDS))
@pytest.mark.parametrize("dtype", ["float32", "float64", "complex64",
                                   "complex128"])
def test_port_file_loads_in_jax(fmt, dtype, tmp_path):
    args = construction(fmt, np.dtype(dtype))
    P = getattr(bt, KINDS[fmt])(*args, device="cpu", patch="never",
                                panel="v2", **SETTINGS[fmt])
    p = tmp_path / "port.npz"
    bt.save(p, P)
    J = bst.load(p)
    assert type(J).__name__ == KINDS[fmt]
    assert str(np.dtype(J.dtype)) == dtype
    assert settings_of(J) == settings_of(P)
    products_equal(P, J, dtype, np.random.default_rng(80))
    Q = bt.load(p, device="cpu")  # the port's own keys come back too
    assert (Q.patch, Q.panel) == ("never", "v2")


@pytest.mark.parametrize("fmt", ["general", "vbcrs"])
def test_bf16_files_cross_load(fmt, tmp_path):
    """The port writes bf16 as float32 values plus ``dtype = "bfloat16"``:
    the JAX package loads an f32 operator with the same values, the port a
    bf16 one with the same bits; the port also reads a JAX-written bf16
    file (raw ``|V2`` blocks, which the JAX ``load`` itself refuses)."""
    args = construction(fmt, np.float32)
    P = getattr(bt, KINDS[fmt])(*args, device="cpu", dtype=torch.bfloat16)
    p = tmp_path / "port16.npz"
    bt.save(p, P)
    J = bst.load(p)
    assert np.dtype(J.dtype) == np.float32
    Q = bt.load(p, device="cpu")
    assert Q.dtype == torch.bfloat16
    for a, b in zip(P._buckets, Q._buckets):
        assert torch.equal(a[0].view(torch.int16), b[0].view(torch.int16))
    x = vec(np.random.default_rng(81), P.shape[1], np.float32)
    got = (P @ torch.from_numpy(x)).numpy()
    assert relerr(got, np.asarray(J @ jnp.asarray(x))) < TOLS["float32"]
    assert relerr((Q @ torch.from_numpy(x)).numpy(), got) == 0.0

    Jb = getattr(bst, KINDS[fmt])(*args, dtype=jnp.bfloat16)
    q = tmp_path / "jax16.npz"
    bst.save(q, Jb)
    with np.load(q) as data:
        assert data["blocks_0"].dtype.kind == "V"
    with pytest.raises(TypeError):
        bst.load(q)
    R = bt.load(q, device="cpu")
    assert R.dtype == torch.bfloat16
    for a, b in zip(P._buckets, R._buckets):
        assert torch.equal(a[0].view(torch.int16), b[0].view(torch.int16))


def test_load_settings_and_overrides(tmp_path):
    args = construction("general", np.float64)
    P = bt.BlockSparseMatrix(*args, device="cpu", **SETTINGS["general"])
    p = tmp_path / "s.npz"
    bt.save(p, P)
    Q = bt.load(p, device="cpu", scatter="atomic", precision="highest")
    assert (Q._scatter, Q._precision, Q.schedule) == ("atomic", "highest",
                                                      "auto")
    with pytest.raises(ValueError, match="backend"):
        bt.load(p, device="cpu", backend="tpu")


# -- tests/test_bcoo.py --------------------------------------------------------


def test_to_bcoo_matches_scipy_oracle():
    blocks, rows, cols, shape = random_block_sparse(0, nblocks=40,
                                                    dtype=np.float64)
    A = bt.BlockSparseMatrix(blocks, rows, cols, shape, device="cpu")
    mat = bt.to_bcoo(A)
    assert mat.is_sparse and mat.is_coalesced() and mat.device == A.device
    dense = mat.to_dense().numpy()
    oracle = bt.to_scipy(A).toarray()
    assert dense.shape == tuple(shape)
    assert np.max(np.abs(dense - oracle)) < TOL
    J = bst.to_bcoo(bst.BlockSparseMatrix(blocks, rows, cols, shape))
    assert np.array_equal(mat.indices().T.numpy(), np.asarray(J.indices))
    assert relerr(mat.values().numpy(), np.asarray(J.data)) < TOL


def test_to_bcoo_symmetric_and_wrappers():
    d, di, o, ri, ci, shape = random_symmetric(1, n=400, ngroups=16,
                                               noffdiag=20)
    S = bt.SymmetricBlockMatrix(d, di, o, ri, ci, shape, device="cpu")
    Sj = bst.SymmetricBlockMatrix(d, di, o, ri, ci, shape)
    for op, jop in ((S, Sj), (S.T, Sj.T), (S.H, Sj.H), (2j * S, 2j * Sj)):
        mat = bt.to_bcoo(op)
        dense = mat.to_dense().numpy()
        oracle = bt.to_scipy(op).toarray()
        assert np.max(np.abs(dense - oracle)) < TOL
        J = bst.to_bcoo(jop)
        assert np.array_equal(mat.indices().T.numpy(), np.asarray(J.indices))
        assert relerr(mat.values().numpy(), np.asarray(J.data)) < TOL


def test_from_bcoo_round_trip():
    rng = np.random.default_rng(2)
    D = np.zeros((96, 96))
    for bi, bj in [(0, 0), (32, 64), (64, 32)]:
        D[bi:bi + 32, bj:bj + 32] = rng.standard_normal((32, 32))
    mat = torch.from_numpy(D).to_sparse()
    A = bt.from_bcoo(mat, 32, device="cpu")
    assert np.max(np.abs(A.todense().numpy() - D)) < TOL
    x = rng.standard_normal(96)
    assert np.max(np.abs(A.mv(torch.from_numpy(x)).numpy() - D @ x)) < 1e-12


def test_from_bcoo_rectangular_tiles():
    rng = np.random.default_rng(5)
    D = np.zeros((64, 96))
    D[0:16, 0:32] = rng.standard_normal((16, 32))
    D[48:64, 64:96] = rng.standard_normal((16, 32))
    A = bt.from_bcoo(torch.from_numpy(D).to_sparse(), (16, 32), device="cpu")
    assert len(list(A.eachblockindex())) == 2
    assert np.max(np.abs(A.todense().numpy() - D)) < TOL


def test_bcoo_matvec_agrees_with_operator():
    blocks, rows, cols, shape = random_block_sparse(3, nblocks=30,
                                                    dtype=np.float64)
    A = bt.BlockSparseMatrix(blocks, rows, cols, shape, device="cpu")
    mat = bt.to_bcoo(A)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(shape[1]))
    want = mat.to_dense() @ x  # the assembled matrix, no sparse product
    assert np.max(np.abs((want - A.mv(x)).numpy())) < 1e-10


def test_from_bcoo_uncoalesced_and_bf16():
    """Duplicates of an uncoalesced tensor sum; bf16 values give a bf16
    operator; anything but a 2-D sparse COO tensor raises."""
    idx = torch.tensor([[0, 0, 5, 9], [1, 1, 7, 2]])
    val = torch.tensor([1.5, 2.0, -3.0, 4.0])
    mat = torch.sparse_coo_tensor(idx, val, (10, 10), check_invariants=True)
    A = bt.from_bcoo(mat, 4, device="cpu")
    assert A.todense()[0, 1] == 3.5 and A.todense()[9, 2] == 4.0
    B = bt.from_bcoo(mat.to(torch.bfloat16), 4, device="cpu")
    assert B.dtype == torch.bfloat16
    assert torch.equal(bt.to_bcoo(B).to_dense().float(), mat.to_dense())
    with pytest.raises(ValueError, match="sparse"):
        bt.from_bcoo(mat.to_dense(), 4, device="cpu")


# -- viz -----------------------------------------------------------------------


def test_viz_strings_equal_the_jax_package():
    blocks, rows, cols, shape = random_block_sparse(
        7, shape=(300, 260), nblocks=25, max_block=40, dtype=np.float64)
    A = bt.BlockSparseMatrix(blocks, rows, cols, shape, device="cpu")
    Aj = bst.BlockSparseMatrix(blocks, rows, cols, shape)
    d, di, o, ri, ci, sshape = random_symmetric(8, n=200, ngroups=8,
                                                noffdiag=9, dtype=np.float64)
    S = bt.SymmetricBlockMatrix(d, di, o, ri, ci, sshape, device="cpu")
    Sj = bst.SymmetricBlockMatrix(d, di, o, ri, ci, sshape)
    vb, rs, cs, vshape = random_vbcrs(9, shape=(120, 90), nrowgroups=5,
                                      ncolgroups=4)
    V = bt.VariableBlockCompressedRowStorage(vb, rs, cs, vshape, device="cpu")
    Vj = bst.VariableBlockCompressedRowStorage(vb, rs, cs, vshape)
    E = bt.BlockSparseMatrix([], [], [], (5, 4), device="cpu")
    Ej = bst.BlockSparseMatrix([], [], [], (5, 4))
    for op, jop in ((A, Aj), (A.T, Aj.T), (A.H, Aj.H), (S, Sj), (S.T, Sj.T),
                    (V, Vj), (3.0 * V, 3.0 * Vj), (E, Ej)):
        assert bt.blocksummary(op) == bst.blocksummary(jop)
        assert bt.spy(op) == bst.spy(jop)
        assert bt.spy(op, width=17, height=5) == bst.spy(jop, width=17,
                                                         height=5)
    assert bt.show(S, width=30, height=8) == bst.show(Sj, width=30, height=8)
