"""The port's slice end to end on the CPU: port vs JAX package vs scipy.

The same numpy blocks go into a JAX ``BlockSparseMatrix`` (``backend="xla"``
and ``"pallas-interpret"``) and into the port's; products agree with each
other and with the scipy oracle at 1e-13 (f64) or 1e-5 (f32), relative to
max(1, max|ref|).  On CPU tensors the port runs its kernels' plain
versions through the same routing the card uses.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import blocksparse_tpu as bst
import blocksparse_tpu_torch as bt
from blocksparse_tpu_torch.ops import patch_engine
from blocksparse_tpu_torch.ops.kernels import fused_spmm
from blocksparse_tpu_torch.utils.testmatrices import random_block_sparse

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
TOL64, TOL32 = 1e-13, 1e-5


def relerr(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    if a.size == 0:
        return 0.0
    return float(np.max(np.abs(a - b))) / max(1.0, float(np.max(np.abs(b))))


def population(kind, dtype=np.float64):
    if kind == "contiguous":
        out = random_block_sparse(41, shape=(224, 192), nblocks=14,
                                  max_block=48, dtype=np.float64,
                                  contiguous=True)
    elif kind == "scattered":
        out = random_block_sparse(42, shape=(160, 176), nblocks=10,
                                  max_block=24, dtype=np.float64)
    else:   # overlapping: the same index lists twice, plus a partial overlap
        blocks, rows, cols, shape = random_block_sparse(
            43, shape=(128, 128), nblocks=6, max_block=40, dtype=np.float64,
            contiguous=True)
        rng = np.random.default_rng(44)
        blocks += [rng.standard_normal(b.shape) for b in blocks[:3]]
        rows += rows[:3]
        cols += cols[:3]
        out = (blocks, rows, cols, shape)
    blocks, rows, cols, shape = out
    return [b.astype(dtype) for b in blocks], rows, cols, shape


def operators(kind, dtype=np.float64):
    blocks, rows, cols, shape = population(kind, dtype)
    A_xla = bst.BlockSparseMatrix(blocks, rows, cols, shape, backend="xla")
    A_pi = bst.BlockSparseMatrix(blocks, rows, cols, shape,
                                 backend="pallas-interpret")
    P = bt.BlockSparseMatrix(blocks, rows, cols, shape, device="cpu")
    return A_xla, A_pi, P, bst.to_scipy(A_xla)


def products(m, n, dtype, seed=45):
    rng = np.random.default_rng(seed)
    return dict(
        x=rng.standard_normal(n).astype(dtype),
        X=rng.standard_normal((n, 3)).astype(dtype),
        xt=rng.standard_normal(m).astype(dtype),
        Xt=rng.standard_normal((m, 3)).astype(dtype),
        y=rng.standard_normal(m).astype(dtype),
    )


CASES = {
    "A @ x": (lambda A, v: A @ v["x"], lambda S, v: S @ v["x"]),
    "A @ X": (lambda A, v: A @ v["X"], lambda S, v: S @ v["X"]),
    "A.T @ x": (lambda A, v: A.T @ v["xt"], lambda S, v: S.T @ v["xt"]),
    "A.H @ X": (lambda A, v: A.H @ v["Xt"], lambda S, v: S.T @ v["Xt"]),
    "axpby": (lambda A, v: A.axpby(v["x"], v["y"], 2.0, 0.5),
              lambda S, v: 2.0 * (S @ v["x"]) + 0.5 * v["y"]),
    "(A @ A.T) @ x": (lambda A, v: (A @ A.T) @ v["xt"],
                      lambda S, v: S @ (S.T @ v["xt"])),
}


def to_torch(v):
    return {k: torch.from_numpy(a) for k, a in v.items()}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("kind", ["contiguous", "scattered", "overlapping"])
def test_port_matches_jax_and_scipy_f64(kind, case):
    A_xla, A_pi, P, S = operators(kind)
    v = products(*P.shape, np.float64)
    apply, oracle = CASES[case]
    ref = oracle(S, v)
    got = apply(P, to_torch(v))
    assert got.dtype == torch.float64
    assert relerr(got, ref) <= TOL64
    assert relerr(got, apply(A_xla, v)) <= TOL64
    assert relerr(got, apply(A_pi, v)) <= TOL64


@pytest.mark.parametrize("case", ["A @ x", "A @ X", "A.T @ x", "A.H @ X"])
def test_port_matches_jax_f32_routes(case):
    """f32: r > 1 takes the patch route (kernel B2's plain version) and r = 1
    the chunk-table route (kernel B1's plain version), as on the card."""
    A_xla, A_pi, P, S = operators("contiguous", np.float32)
    v = products(*P.shape, np.float32)
    apply, oracle = CASES[case]
    b1, b2 = [], []
    orig_b1, orig_b2 = fused_spmm.chunked_block_apply_plain, patch_engine.bucket_spmm_plain

    def spy(store, fn):
        def wrapped(*a, **k):
            store.append(1)
            return fn(*a, **k)
        return wrapped

    try:
        fused_spmm.chunked_block_apply_plain = spy(b1, orig_b1)
        patch_engine.bucket_spmm_plain = spy(b2, orig_b2)
        got = apply(P, to_torch(v))
    finally:
        fused_spmm.chunked_block_apply_plain = orig_b1
        patch_engine.bucket_spmm_plain = orig_b2
    assert (len(b2) > 0) == ("X" in case) and (len(b1) > 0) == ("x" in case)
    assert got.dtype == torch.float32
    assert relerr(got, oracle(S, {k: a.astype(np.float64) for k, a in v.items()})) <= TOL32
    assert relerr(got, apply(A_pi, v)) <= TOL32
    assert relerr(got, apply(A_xla, v)) <= TOL32


def test_gradient_matches_jax_grad():
    A_xla, _, P, _ = operators("contiguous")
    rng = np.random.default_rng(46)
    X = rng.standard_normal((P.shape[1], 2))
    W = rng.standard_normal((P.shape[0], 2))
    want = jax.grad(lambda X_: jnp.vdot(jnp.asarray(W), A_xla @ X_))(
        jnp.asarray(X))
    Xt = torch.from_numpy(X).requires_grad_()
    (torch.from_numpy(W) * (P @ Xt)).sum().backward()
    assert relerr(Xt.grad, want) <= TOL64
    xt = torch.from_numpy(X[:, 0].copy()).requires_grad_()
    (torch.from_numpy(W[:, 0]) * (P @ xt)).sum().backward()
    assert relerr(xt.grad, want[:, 0]) <= TOL64


def test_gradient_through_patch_route_f32():
    A_xla, _, P, _ = operators("contiguous", np.float32)
    rng = np.random.default_rng(47)
    X = rng.standard_normal((P.shape[0], 3)).astype(np.float32)
    W = rng.standard_normal((P.shape[1], 3)).astype(np.float32)
    want = jax.grad(lambda X_: jnp.vdot(jnp.asarray(W), A_xla.T @ X_))(
        jnp.asarray(X))
    Xt = torch.from_numpy(X).requires_grad_()
    (torch.from_numpy(W) * (P.T @ Xt)).sum().backward()
    assert relerr(Xt.grad, want) <= TOL32


def test_zero_blocks_and_todense():
    P = bt.BlockSparseMatrix([], [], [], (5, 7), device="cpu")
    A = bst.BlockSparseMatrix([], [], [], (5, 7))
    x = np.arange(7.0)
    got = P @ torch.from_numpy(x)
    assert got.shape == (5,) and not got.any()
    assert relerr(got, A @ x) == 0.0
    assert (P.T @ torch.zeros(5, dtype=torch.float64)).shape == (7,)
    _, _, P, S = operators("overlapping")
    assert relerr(P.todense(), S.toarray()) <= TOL64


def test_wrong_length_names_both_sizes():
    _, _, P, _ = operators("contiguous")
    m, n = P.shape
    with pytest.raises(ValueError, match=f"operand length {n - 1} != operator ncols {n}"):
        P @ torch.zeros(n - 1, dtype=torch.float64)
    with pytest.raises(ValueError, match=f"operand rows {n + 2} != operator ncols {n}"):
        P @ torch.zeros(n + 2, 3, dtype=torch.float64)
    with pytest.raises(ValueError, match=f"operand length {n} != operator ncols {m}"):
        P.T @ torch.zeros(n, dtype=torch.float64)
    with pytest.raises(ValueError, match="inner dim mismatch"):
        P @ P


def test_device_dtype_and_unported_options_raise():
    blocks, rows, cols, shape = population("contiguous")
    M = bt.BlockSparseMatrix(blocks, rows, cols, shape, device="meta")
    assert M.device.type == "meta"
    with pytest.raises(ValueError, match="operand on cpu, operator on meta"):
        M @ torch.zeros(shape[1], dtype=torch.float64)
    P = bt.BlockSparseMatrix(blocks, rows, cols, shape, device="cpu")
    # an f32 operand on an f64 operator comes out f64, as in the JAX package
    x32 = torch.from_numpy(np.random.default_rng(44).standard_normal(shape[1])
                           .astype(np.float32))
    got = P @ x32
    assert got.dtype == torch.float64
    assert relerr(got.numpy(), bt.to_scipy(P) @ x32.double().numpy()) <= TOL64
    # complex dtypes build and apply (tests/test_torch_complex.py covers them)
    C = bt.BlockSparseMatrix([b.astype(np.complex128) * (1 + 2j)
                              for b in blocks], rows, cols, shape, device="cpu")
    assert C.dtype == torch.complex128
    xc = np.random.default_rng(45).standard_normal(max(shape)) * (1 - 1j)
    got = (C.H @ torch.from_numpy(xc[:shape[0]].copy())).numpy()
    want = bt.to_scipy(C).conj().T @ xc[:shape[0]]
    assert np.abs(got - want).max() <= TOL64 * max(1.0, np.abs(want).max())
    # "auto" builds and runs the colored path (tests/test_torch_options.py)
    Q = bt.BlockSparseMatrix(blocks, rows, cols, shape, schedule="auto",
                             device="cpu")
    assert Q.schedule == "auto" and Q.colors() != (tuple(range(Q.nblocks)),)
    with pytest.raises(ValueError, match="schedule"):
        bt.BlockSparseMatrix(blocks, rows, cols, shape, schedule="fast",
                             device="cpu")
    with pytest.raises(ValueError, match="precision"):
        bt.BlockSparseMatrix(blocks, rows, cols, shape, precision="fast",
                             device="cpu")


@pytest.mark.parametrize("fmt", ["general", "symmetric", "vbcrs"])
def test_formats_default_to_the_card(fmt, monkeypatch):
    """Without ``device=`` an operator is built on the card; with no card
    present that raises instead of building a CPU operator."""
    from blocksparse_tpu_torch.utils.testmatrices import random_symmetric

    blocks, rows, cols, shape = population("contiguous")
    ctor = {
        "general": lambda **kw: bt.BlockSparseMatrix(blocks, rows, cols,
                                                     shape, **kw),
        "symmetric": lambda **kw: bt.SymmetricBlockMatrix(*random_symmetric(
            3, n=256, ngroups=8, noffdiag=10, dtype=np.float64,
            contiguous=True), **kw),
        "vbcrs": lambda **kw: bt.VariableBlockCompressedRowStorage(
            [np.ones((4, 6))], [8], [2], (16, 16), **kw),
    }[fmt]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="no CUDA card.*device='cpu'"):
            ctor(**kw)
    if fmt == "general":
        with pytest.raises(RuntimeError, match="no CUDA card"):
            bt.from_reference(ctor(device="cpu"))
    assert ctor(device="cpu").device == torch.device("cpu")


def test_from_reference_and_accessors():
    A_xla, _, _, S = operators("scattered")
    P = bt.from_reference(A_xla, dtype=np.float64, device="cpu")
    assert P.shape == A_xla.shape and P.nblocks == A_xla.nblocks
    assert bt.nnz(P) == bst.nnz(A_xla) == bt.nnz(P.H)
    assert (bt.to_scipy(P) != S).nnz == 0
    for i in range(P.nblocks):
        np.testing.assert_array_equal(bt.block(P.T, i), bst.block(A_xla.T, i))
        np.testing.assert_array_equal(bt.rowindices(P.H, i),
                                      bst.colindices(A_xla, i))
        np.testing.assert_array_equal(bt.colindices(P.conj(), i),
                                      bst.colindices(A_xla, i))
    assert bt.colors(P) == bst.colors(A_xla)
    assert P.schedule == bt.SERIAL and P.T.schedule == bt.SERIAL
    x = np.random.default_rng(48).standard_normal(P.shape[1])
    assert relerr(P @ torch.from_numpy(x), S @ x) <= TOL64
    assert relerr((2 * P - P) @ torch.from_numpy(x), S @ x) <= TOL64


def test_import_pulls_in_no_jax():
    code = (
        "import sys, blocksparse_tpu_torch\n"
        "bad = [m for m in sys.modules if m in ('jax', 'blocksparse_tpu')"
        " or m.startswith(('jax.', 'blocksparse_tpu.'))]\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_sources_import_no_jax():
    for path in sorted((REPO / "blocksparse_tpu_torch").rglob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "blocksparse_tpu"), (
                    f"{path}: imports {name}")
