"""Kernel B2's transposed product, on the CPU.

On the card ``A.T @ X``, ``A.H @ X``, every dX of ``A @ X`` and the dX of
``batched_mm`` run B2's transposed kernel (``csrc/patch_spmm_tr.cu``) after
the prologue that writes X^T, one launch each for all P products of a
batch.  Here, where the wrappers take the plain versions:

  - the transposed route's plain version equals the JAX package's
    ``patch_spmm(..., transpose=True)`` in interpret mode at each tier (f32,
    1e-5; r = 5 and r = 70, which on the card spans two column tiles with
    r % 4 != 0, the shape added into Y with scalar atomics) and the JAX
    package's f64 product (1e-13), on plans of 8-, 24- and 128-row slots
    (24: not a multiple of 32, so the kernel's last window box holds rows
    of other slots);
  - inf / NaN in the rows of X that no window covers reach neither
    package's result;
  - the prologue's plain version with a product axis: per product hi + lo
    == X bit for bit, hi equal to the one-product split, zeros past n; the
    kernel alone on the prologue's output (``patch_tr``) takes its plain
    version on X = (hi + lo)^T;
  - ``batched_spmm_plain(transpose=True)`` at P in {2, 3} equals P single
    transposes and the JAX package's ``batched_mm`` dX (``jax.grad``
    through ``_batched_bwd``).

Tolerances relative to max(1, max|ref|).
"""

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
from blocksparse_tpu_torch.core.layout import build_layout
from blocksparse_tpu_torch.core.patch import build_patch_plan
from blocksparse_tpu_torch.ops import batched as pb
from blocksparse_tpu_torch.ops import patch_engine
from blocksparse_tpu_torch.ops.kernels import batched_spmm
from blocksparse_tpu_torch.utils.testmatrices import random_block_sparse

torch.set_num_threads(2)

TOL64, TOL32 = 1e-13, 1e-5
PRECISIONS = ["highest", "high", None]


def relerr(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b))) / max(1.0, float(np.max(np.abs(b))))


def uniform_blocks(n, nblocks, bs, seed):
    """nblocks bs x bs f32 blocks at distinct bs-aligned positions of an
    n x n matrix: the patch plan's slots are bs rows tall."""
    rng = np.random.default_rng(seed)
    ntiles = n // bs
    pos = rng.choice(ntiles * ntiles, size=nblocks, replace=False)
    blocks = [rng.standard_normal((bs, bs)).astype(np.float32)
              for _ in range(nblocks)]
    return (blocks, [np.arange(r, r + bs) for r in (pos // ntiles) * bs],
            [np.arange(c, c + bs) for c in (pos % ntiles) * bs], (n, n))


INPUTS = {  # slot rows (MP) -> the blocks of a plan with that MP
    8: lambda: random_block_sparse(31, shape=(256, 224), nblocks=12,
                                   max_block=50, dtype=np.float32,
                                   contiguous=True),
    24: lambda: uniform_blocks(480, 12, 24, 3),
    128: lambda: uniform_blocks(512, 6, 128, 3),
}


def plan_pair(MP):
    blocks, rows, cols, shape = INPUTS[MP]()
    mine = build_patch_plan(build_layout(blocks, rows, cols, shape))
    ref = jax_build_patch_plan(
        jax_build_layout(blocks, rows, cols, shape, granularity="pow2"))
    assert [b.MP for b in mine.buckets] == [b.MP for b in ref.buckets] == [MP]
    return mine, ref, (blocks, rows, cols, shape)


def uncovered_rows(plan, n):
    """Rows of X [n, r] that no slot window of ``plan`` covers."""
    covered = np.zeros(n, bool)
    for b in plan.buckets:
        for w in b.row_start:
            covered[w:w + b.MP] = True
    return ~covered


# -- the plain version against the JAX package --------------------------------

@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("MP", list(INPUTS))
def test_transpose_plain_equals_jax_interpret(MP, precision, r=5):
    mine, ref, (_, _, _, shape) = plan_pair(MP)
    rng = np.random.default_rng(90 + MP)
    X = rng.standard_normal((shape[0], r)).astype(np.float32)
    want = jax_patch.patch_spmm(ref, jax_patch.patch_device_arrays(ref),
                                jnp.asarray(X), transpose=True,
                                interpret=True, precision=precision)
    dev = patch_engine.patch_device_arrays(mine, "cpu")
    before = (patch_engine.TR_LAUNCHES, patch_engine.XT_LAUNCHES)
    got = patch_engine.patch_spmm(mine, dev, torch.from_numpy(X),
                                  transpose=True, precision=precision)
    assert (patch_engine.TR_LAUNCHES, patch_engine.XT_LAUNCHES) == before
    assert got.dtype == torch.float32 and got.shape == (shape[1], r)
    assert relerr(got, np.asarray(want)) <= TOL32


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("MP", list(INPUTS))
def test_transpose_plain_equals_jax_interpret_wide(MP, precision):
    test_transpose_plain_equals_jax_interpret(MP, precision, r=70)


@pytest.mark.parametrize("MP", list(INPUTS))
def test_transpose_plain_equals_jax_product_f64(MP, r=4):
    """The plan's f32 values carried exactly into f64, bucket by bucket,
    against the JAX package's f64 operator's A.T @ X on the same values."""
    mine, _, (blocks, rows, cols, shape) = plan_pair(MP)
    J = bst.BlockSparseMatrix([b.astype(np.float64) for b in blocks], rows,
                              cols, shape, backend="xla")
    rng = np.random.default_rng(95 + MP)
    X = rng.standard_normal((shape[0], r))
    want = np.asarray(J.T @ jnp.asarray(X))
    got = torch.zeros((shape[1], r), dtype=torch.float64)
    for vals, cc, rs, _mk in patch_engine.patch_device_arrays(mine, "cpu"):
        parts = [patch_engine.bucket_spmm(
            vals.double(), cc, rs, torch.from_numpy(X), shape[1],
            transpose=True, precision=precision) for precision in PRECISIONS]
        assert all(torch.equal(p, parts[0]) for p in parts)  # every tier exact
        got += parts[0]
    assert relerr(got, want) <= TOL64


@pytest.mark.parametrize("package", ["port", "jax"])
def test_nonfinite_rows_outside_windows_do_not_reach_the_result(package):
    """inf / NaN in every row of X that no window covers (on the 24-row
    plan some sit inside a window's last 32-row box, which the kernel
    loads): the result is finite and equals the product with those rows
    zeroed."""
    mine, ref, (_, _, _, shape) = plan_pair(24)
    bad = uncovered_rows(mine, shape[0])
    reach = np.zeros(shape[0], bool)
    for w in mine.buckets[0].row_start:
        reach[w + 24:w + 32] = True
    assert (bad & reach).any()
    rng = np.random.default_rng(97)
    clean = rng.standard_normal((shape[0], 6)).astype(np.float32)
    clean[bad] = 0.0
    dirty = clean.copy()
    dirty[bad] = np.inf
    dirty[np.flatnonzero(bad)[::2]] = np.nan
    if package == "port":
        dev = patch_engine.patch_device_arrays(mine, "cpu")
        run = lambda X: patch_engine.patch_spmm(  # noqa: E731
            mine, dev, torch.from_numpy(X), transpose=True).numpy()
    else:
        jdev = jax_patch.patch_device_arrays(ref)
        run = lambda X: np.asarray(jax_patch.patch_spmm(  # noqa: E731
            ref, jdev, jnp.asarray(X), transpose=True, interpret=True))
    got, want = run(dirty), run(clean)
    assert np.isfinite(got).all()
    assert relerr(got, want) <= TOL32


# -- the prologue's product axis ---------------------------------------------------

@pytest.mark.parametrize("P", [1, 3])
def test_prologue_product_axis_is_exact_per_product(P, n=33, r=7):
    rng = np.random.default_rng(98 + P)
    X = torch.from_numpy((rng.standard_normal((P, n, r))
                          * np.exp2(rng.integers(-20, 20, (P, n, r))))
                         .astype(np.float32))
    before = patch_engine.XT_LAUNCHES
    hi, lo = patch_engine.patch_xt(X, 1)             # CPU: the plain version
    assert patch_engine.XT_LAUNCHES == before
    ld = -(-n // 4) * 4
    assert hi.shape == lo.shape == (P, r, ld)
    assert (hi[..., n:] == 0).all() and (lo[..., n:] == 0).all()
    for p in range(P):
        assert torch.equal(hi[p, :, :n] + lo[p, :, :n], X[p].t())
        one_hi, one_lo = patch_engine.patch_xt_plain(X[p], 1)
        assert torch.equal(hi[p], one_hi) and torch.equal(lo[p], one_lo)
    hi0, lo0 = patch_engine.patch_xt(X, 0)
    assert lo0 is None and torch.equal(hi0, hi)
    with pytest.raises(TypeError, match="P, n, r"):
        patch_engine.patch_xt(X[None], 1)


@pytest.mark.parametrize("tier", [0, 1])
def test_kernel_alone_on_the_prologue_output(tier, P=2, r=9):
    """patch_tr, the transposed kernel on the prologue's hi / lo, takes its
    plain version on the CPU: P transposes of X = (hi + lo)^T (hi alone,
    tf32(X), at tier 0), launching nothing."""
    mine, _, (_, _, _, shape) = plan_pair(24)
    vals, cc, rs, _mk = patch_engine.patch_device_arrays(mine, "cpu")[0]
    rng = np.random.default_rng(96 + tier)
    X = torch.from_numpy(rng.standard_normal((P, shape[0], r)).astype(
        np.float32))
    vals_b = torch.stack([vals * (p + 1) for p in range(P)])
    hi, lo = patch_engine.patch_xt(X, tier)
    before = (patch_engine.TR_LAUNCHES, patch_engine.XT_LAUNCHES)
    got = patch_engine.patch_tr(vals_b, cc, rs, hi, lo, shape[0], shape[1],
                                tier)
    assert (patch_engine.TR_LAUNCHES, patch_engine.XT_LAUNCHES) == before
    used = X if tier else patch_engine.tf32_round(X)
    for p in range(P):
        assert torch.equal(got[p], patch_engine.bucket_spmm_plain(
            vals_b[p], cc, rs, used[p], shape[1], transpose=True))


# -- batched_mm's dX ----------------------------------------------------------------

def batch(P, n=512, nblocks=10, bs=32):
    """P operators of one structure (tests/test_batched.py's recipe),
    values from seeds 1 .. P."""
    rng = np.random.default_rng(7)
    ntiles = n // bs
    pos = rng.choice(ntiles * ntiles, size=nblocks, replace=False)
    rows = [np.arange(r, r + bs) for r in (pos // ntiles) * bs]
    cols = [np.arange(c, c + bs) for c in (pos % ntiles) * bs]
    return [bst.BlockSparseMatrix(
        [np.random.default_rng(seed).standard_normal((bs, bs)).astype(
            np.float32) for _ in range(nblocks)], rows, cols, (n, n),
        backend="pallas-interpret") for seed in range(1, P + 1)]


@pytest.mark.parametrize("P", [2, 3])
def test_batched_transpose_plain_is_p_transposes_and_the_jax_dx(P, r=6):
    J = batch(P)
    ops = [bt.from_reference(A, device="cpu") for A in J]
    entry = pb._stacked_entry(ops)
    assert entry is not None
    _plan, vals_b, cc, rs = entry
    n = ops[0].shape[0]
    rng = np.random.default_rng(99 + P)
    W = rng.standard_normal((P, n, r)).astype(np.float32)
    Wt = torch.from_numpy(W)
    got = batched_spmm.batched_spmm_plain(vals_b, cc, rs, Wt, n,
                                          transpose=True)
    single = torch.stack([patch_engine.bucket_spmm_plain(
        vals_b[p], cc, rs, Wt[p], n, transpose=True) for p in range(P)])
    assert relerr(got, single) <= TOL32
    assert torch.equal(batched_spmm.batched_spmm(
        vals_b, cc, rs, Wt, n, transpose=True, precision=None), got)
    X = rng.standard_normal((P, n, r)).astype(np.float32)
    gj = np.asarray(jax.grad(lambda Xj: jnp.sum(
        jnp.asarray(W) * bst.batched_mm(J, Xj)))(jnp.asarray(X)))
    assert relerr(got, gj) <= TOL32
    for p, A in enumerate(J):
        assert relerr(got[p], bst.to_scipy(A).T @ W[p].astype(
            np.float64)) <= TOL32

