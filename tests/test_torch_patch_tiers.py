"""Kernel B2 (general patch SpMM) and its precision tiers, on the CPU.

On the card B2's forward and its transpose run on wgmma, each after a
prologue launch that writes the K-major copy X^T (hi = tf32(X)^T and, at
"highest"/"high", lo = (X - hi)^T), both at the operator's tier
(``tests/test_torch_patch_transpose.py`` holds the transpose on its own).
Here, where the wrappers take the plain versions:

  - the prologue's plain split: hi has its low 13 bits zero, hi + lo == X
    bit for bit, and the rounding is cvt.rna's (nearest, ties away from
    zero), held against a numpy emulation written from the definition;
  - BlockSparseMatrix and VariableBlockCompressedRowStorage hand their
    ``precision`` to B2 in the forward, the transpose and the gradient;
  - B2's plain version equals the JAX package's ``patch_spmm`` in interpret
    mode at each of its tiers (f32, 1e-5) and the JAX package's f64
    products (1e-13: the Pallas kernel computes in f32 only);
  - unknown tiers raise ``ValueError``.

Tolerances relative to max(1, max|ref|).
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import blocksparse_tpu as bst
from blocksparse_tpu.core.layout import build_layout as jax_build_layout
from blocksparse_tpu.core.patch import build_patch_plan as jax_build_patch_plan
from blocksparse_tpu.ops import patch_engine as jax_patch

import blocksparse_tpu_torch as bt
from blocksparse_tpu_torch.core.layout import build_layout
from blocksparse_tpu_torch.core.patch import build_patch_plan
from blocksparse_tpu_torch.ops import patch_engine
from blocksparse_tpu_torch.utils.testmatrices import (random_block_sparse,
                                                      random_vbcrs)

torch.set_num_threads(2)

TOL64, TOL32 = 1e-13, 1e-5
PRECISIONS = ["highest", "high", None]


def relerr(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b))) / max(1.0, float(np.max(np.abs(b))))


def rna_tf32_numpy(x: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32 from its definition: the nearest float32 with 10
    explicit mantissa bits, ties away from zero (finite normal inputs)."""
    x = x.astype(np.float64)
    ulp = np.exp2(np.floor(np.log2(np.abs(x))) - 10)   # tf32 ulp of |x|
    q = np.abs(x) / ulp
    return (np.sign(x) * np.floor(q + 0.5) * ulp).astype(np.float32)


# -- (a) the prologue's plain split ----------------------------------------------

def wide_range_values(seed=81, n=300, r=7):
    rng = np.random.default_rng(seed)
    X = (rng.standard_normal((n, r))
         * np.exp2(rng.integers(-20, 20, (n, r)))).astype(np.float32)
    X[0, :4] = [1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 3.0 * 2.0 ** -12 + 1.0,
                0.0]                                    # ties and a zero
    return X


def test_tf32_round_matches_rna_emulation():
    X = wide_range_values()
    got = patch_engine.tf32_round(torch.from_numpy(X)).numpy()
    nz = X != 0
    assert np.array_equal(got[nz], rna_tf32_numpy(X[nz]))
    assert (got[~nz] == 0).all()
    # ties go away from zero
    assert got[0, 0] == np.float32(1.0 + 2.0 ** -10)
    assert got[0, 1] == np.float32(-(1.0 + 2.0 ** -10))


@pytest.mark.parametrize("n", [5, 8, 33])
def test_prologue_split_is_exact(n):
    X = torch.from_numpy(wide_range_values(n=n))
    hi, lo = patch_engine.patch_xt(X, 1)            # CPU: the plain version
    ld = -(-n // 4) * 4
    assert hi.shape == lo.shape == (X.shape[1], ld)
    assert (hi[:, n:] == 0).all() and (lo[:, n:] == 0).all()
    hbits = hi.contiguous().view(torch.int32)
    assert ((hbits & 0x1FFF) == 0).all()            # low 13 mantissa bits
    assert torch.equal(hi[:, :n] + lo[:, :n], X.t())  # exact in fp32
    assert torch.equal(hi[:, :n], patch_engine.tf32_round(X).t())
    hi0, lo0 = patch_engine.patch_xt(X, 0)
    assert lo0 is None and torch.equal(hi0, hi)


def test_prologue_launches_nothing_on_the_cpu():
    before = patch_engine.XT_LAUNCHES
    patch_engine.patch_xt(torch.ones((9, 3)), 1)
    assert patch_engine.XT_LAUNCHES == before
    with pytest.raises(ValueError, match="tier"):
        patch_engine.patch_xt(torch.ones((9, 3)), 2)
    with pytest.raises(TypeError, match="float32"):
        patch_engine.patch_xt(torch.ones((9, 3), dtype=torch.float64), 1)


# -- (b) the formats hand their tier to B2 ---------------------------------------

def recorder(monkeypatch):
    seen = []
    orig = patch_engine.bucket_spmm

    def wrapped(*a, **k):
        seen.append((k["precision"], k["transpose"]))
        return orig(*a, **k)
    monkeypatch.setattr(patch_engine, "bucket_spmm", wrapped)
    return seen


def bsm_inputs():
    return random_block_sparse(31, shape=(256, 224), nblocks=12, max_block=50,
                               dtype=np.float32, contiguous=True)


def vbcrs_inputs():
    return random_vbcrs(3, dtype=np.float32)


FORMATS = {
    "bsm": (bsm_inputs, lambda a, **k: bt.BlockSparseMatrix(*a, **k),
            lambda a: bst.BlockSparseMatrix(
                [b.astype(np.float64) for b in a[0]], *a[1:])),
    "vbcrs": (vbcrs_inputs,
              lambda a, **k: bt.VariableBlockCompressedRowStorage(
                  *a, granularity=(32, 32), **k),
              lambda a: bst.VariableBlockCompressedRowStorage(
                  [b.astype(np.float64) for b in a[0]], *a[1:])),
}


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("fmt", list(FORMATS))
def test_format_hands_its_tier_to_b2(monkeypatch, fmt, precision):
    inputs, port, jax_op = FORMATS[fmt]
    args = inputs()
    A = port(args, device="cpu", precision=precision)
    assert A.precision == precision and A._patch_for() is not None
    S = bst.to_scipy(jax_op(args))
    m, n = A.shape
    rng = np.random.default_rng(82)
    X = torch.from_numpy(rng.standard_normal((n, 6)).astype(
        np.float32)).requires_grad_()
    G = torch.from_numpy(rng.standard_normal((m, 6)).astype(
        np.float32)).requires_grad_()
    seen = recorder(monkeypatch)
    Y = A @ X                                       # forward
    assert seen == [(precision, False)]
    Y.sum().backward()                              # dX: the transpose
    assert seen[1:] == [(precision, True)]
    Z = A.H @ G                                     # transpose
    assert seen[2:] == [(precision, True)]
    Z.sum().backward()                              # dG: the forward
    assert seen[3:] == [(precision, False)]
    assert relerr(Y.detach(), S @ X.detach().double().numpy()) <= TOL32
    assert relerr(Z.detach(), S.T @ G.detach().double().numpy()) <= TOL32
    assert relerr(X.grad, S.T @ np.ones((m, 6))) <= TOL32
    assert relerr(G.grad, S @ np.ones((n, 6))) <= TOL32


# -- (c) the plain version against the JAX package --------------------------------

def plan_pair():
    blocks, rows, cols, shape = bsm_inputs()
    mine = build_patch_plan(build_layout(blocks, rows, cols, shape))
    ref = jax_build_patch_plan(
        jax_build_layout(blocks, rows, cols, shape, granularity="pow2"))
    return mine, ref, shape


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("transpose", [False, True])
def test_b2_plain_equals_jax_patch_spmm_f32(transpose, precision, r=5):
    mine, ref, shape = plan_pair()
    rng = np.random.default_rng(83)
    X = rng.standard_normal((shape[0] if transpose else shape[1], r)).astype(
        np.float32)
    want = jax_patch.patch_spmm(ref, jax_patch.patch_device_arrays(ref),
                                jnp.asarray(X), transpose=transpose,
                                interpret=True, precision=precision)
    dev = patch_engine.patch_device_arrays(mine, "cpu")
    before = patch_engine.LAUNCHES
    got = patch_engine.patch_spmm(mine, dev, torch.from_numpy(X),
                                  transpose=transpose, precision=precision)
    assert patch_engine.LAUNCHES == before          # CPU: the plain version
    assert got.dtype == torch.float32
    assert relerr(got, np.asarray(want)) <= TOL32


@pytest.mark.parametrize("transpose", [False, True])
def test_b2_plain_equals_jax_product_f64(transpose, r=4):
    """The plan's f32 values carried exactly into f64, bucket by bucket,
    against the JAX package's f64 operator on the same values."""
    blocks, rows, cols, shape = bsm_inputs()
    mine = build_patch_plan(build_layout(blocks, rows, cols, shape))
    J = bst.BlockSparseMatrix([b.astype(np.float64) for b in blocks], rows,
                              cols, shape, backend="xla")
    rng = np.random.default_rng(84)
    X = rng.standard_normal((shape[0] if transpose else shape[1], r))
    want = np.asarray((J.T if transpose else J) @ jnp.asarray(X))
    n_out = shape[1] if transpose else shape[0]
    got = torch.zeros((n_out, r), dtype=torch.float64)
    for vals, cc, rs, _mk in patch_engine.patch_device_arrays(mine, "cpu"):
        parts = [patch_engine.bucket_spmm(
            vals.double(), cc, rs, torch.from_numpy(X), n_out,
            transpose=transpose, precision=precision)
            for precision in PRECISIONS]
        assert parts[0].dtype == torch.float64
        assert all(torch.equal(p, parts[0]) for p in parts)  # every tier exact
        got += parts[0]
    assert relerr(got, want) <= TOL64


# -- (d) refusals ------------------------------------------------------------------

def test_unknown_tiers_raise():
    mine, _, shape = plan_pair()
    dev = patch_engine.patch_device_arrays(mine, "cpu")
    vals, cc, rs, _mk = dev[0]
    X = torch.zeros((shape[1], 2))
    with pytest.raises(ValueError, match="precision"):
        patch_engine.bucket_spmm(vals, cc, rs, X, shape[0], precision="fast")
    with pytest.raises(ValueError, match="precision"):
        patch_engine.patch_spmm(mine, dev, X, precision="medium")
    with pytest.raises(ValueError, match="precision"):
        patch_engine.bucket_spmm(vals, cc, rs, X, shape[0], transpose=True,
                                 precision="low")
    with pytest.raises(ValueError, match="precision"):
        bt.BlockSparseMatrix(*bsm_inputs(), device="cpu", precision="fast")
    with pytest.raises(ValueError, match="precision"):
        bt.VariableBlockCompressedRowStorage(*vbcrs_inputs(), device="cpu",
                                             precision="tf32")


def test_b2_defaults_to_highest():
    for fn in (patch_engine.bucket_spmm, patch_engine.patch_spmm,
               patch_engine.patch_apply, patch_engine._PatchSpmm.forward):
        assert inspect.signature(fn).parameters["precision"].default == \
            "highest"
    blocks, rows, cols, shape = bsm_inputs()
    assert bt.BlockSparseMatrix(blocks, rows, cols, shape,
                                device="cpu").precision == "highest"
