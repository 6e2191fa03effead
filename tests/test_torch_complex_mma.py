"""B1's complex64 tensor-core instance on the CPU: its plain version (the
real embedding) held to the JAX package and scipy, and the rule that
routes a table to it.

On the card, complex64 values with a complex64 operand at r >= the least
r of ``fused_spmm.MMA_RULES`` run ``csrc/complex_mma.cu``: the interleaved V
[M, K] read as a real [M, 2K] times a real B [2K, 2r] whose row 2k is x's
row k as (Xr, Xi) per column and whose row 2k + 1 is (-Xi, Xr) (conj:
(Xi, -Xr)), one real GEMM giving the interleaved complex product.  Its
plain version, ``fused_spmm.complex_mma_apply_plain``, is that embedding
in torch; a CPU tensor runs it wherever the rule picks the instance.  The
same numpy blocks from a seed go into the JAX package's operators
(``backend="xla"``, x64) and into the port.  Tolerances, relative to
max(1, max|ref|): 1e-13 for the float64 analogue (the embedding on
complex128 values), 1e-5 for complex64.

- the embedding's B on a small case, entry by entry;
- a layout's chunked buckets through the embedding, forward, transpose,
  symmetric (the symmetric format's off-diagonal layout) and each with the
  conj bit, r in {2, 16, 64}, against the JAX complex product and scipy,
  in complex128 and complex64; sentinel chunk ids (past n) read zero and
  scatter nowhere, as in the FMA instance's plain version;
- the routing rule ``b1_instance``, and that a CPU product of a complex64
  operator reaches the embedding exactly where the rule says.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import blocksparse_tpu as bst
import blocksparse_tpu_torch as bt
from blocksparse_tpu_torch.ops import dispatch
from blocksparse_tpu_torch.ops.kernels import fused_spmm
from blocksparse_tpu_torch.ops.kernels.fused_spmm import BucketTable
from blocksparse_tpu_torch.utils.testmatrices import (random_block_sparse,
                                                      random_symmetric)

torch.set_num_threads(2)

TOL = {np.complex128: 1e-13, np.complex64: 1e-5}
DTYPES = [np.complex128, np.complex64]
RS = [2, 16, 64]


def relerr(a, b):
    a = np.asarray(a.numpy() if isinstance(a, torch.Tensor) else a,
                   np.complex128)
    b = np.asarray(b, np.complex128)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(1.0, float(np.max(np.abs(b))) if b.size else 1.0)
    return float(np.max(np.abs(a - b))) / scale if a.size else 0.0


def cvec(rng, dtype, *shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(dtype)


def chunked_table(op, layout_attr="layout", staged_attr="_buckets"):
    tables = dispatch.bucket_tables(getattr(op, staged_attr),
                                    getattr(op, layout_attr))
    assert tables["chunked"] is not None
    return tables["chunked"]


def test_embedding_rows():
    """Row 2k of B is x's row k as (Xr, Xi) pairs, row 2k + 1 is (-Xi, Xr),
    and under conj (Xi, -Xr)."""
    rng = np.random.default_rng(0)
    xg = torch.from_numpy(cvec(rng, np.complex128, 2, 3, 4))
    for conj in (False, True):
        B = fused_spmm._embedded(xg, conj).numpy()
        assert B.shape == (2, 6, 8)
        x = xg.numpy()
        sign = -1.0 if conj else 1.0
        for b in range(2):
            for k in range(3):
                for c in range(4):
                    assert B[b, 2 * k, 2 * c] == x[b, k, c].real
                    assert B[b, 2 * k, 2 * c + 1] == x[b, k, c].imag
                    assert B[b, 2 * k + 1, 2 * c] == -sign * x[b, k, c].imag
                    assert B[b, 2 * k + 1, 2 * c + 1] == sign * x[b, k, c].real


@pytest.fixture(scope="module", params=DTYPES, ids=["c128", "c64"])
def general(request):
    dtype = request.param
    args = random_block_sparse(51, shape=(448, 448), nblocks=30,
                               max_block=64, dtype=dtype, contiguous=True)
    A = bt.BlockSparseMatrix(*args, device="cpu")
    J = bst.BlockSparseMatrix(*args, backend="xla")
    return dtype, A, J, bt.to_scipy(A).astype(np.complex128)


# mode -> (transpose, conj, JAX view, scipy view)
MODES = {
    "forward": (False, False, lambda J: J, lambda S: S),
    "transpose": (True, False, lambda J: J.T, lambda S: S.T),
    "forward conj": (False, True, lambda J: J.conj(), lambda S: S.conj()),
    "transpose conj": (True, True, lambda J: J.H, lambda S: S.conj().T),
}


@pytest.mark.parametrize("r", RS)
@pytest.mark.parametrize("mode", list(MODES))
def test_general_layout_through_the_embedding(general, mode, r):
    """Every chunked bucket of a contiguous layout through the embedding
    (one table, as one launch on the card) against the JAX product and
    scipy."""
    dtype, A, J, S = general
    transpose, conj, jax_view, sp_view = MODES[mode]
    table = chunked_table(A)
    assert dispatch.bucket_tables(A._buckets, A.layout)["element"] is None
    x = cvec(np.random.default_rng(r), dtype, A.shape[0], r)
    xt = torch.from_numpy(x)
    out = fused_spmm.complex_mma_apply_plain(
        table, xt, out=torch.zeros_like(xt), transpose=transpose, conj=conj)
    assert out.dtype == xt.dtype
    assert relerr(out, np.asarray(jax_view(J) @ jnp.asarray(x))) < TOL[dtype]
    assert relerr(out, sp_view(S) @ x.astype(np.complex128)) < TOL[dtype]


@pytest.fixture(scope="module", params=DTYPES, ids=["c128", "c64"])
def symmetric(request):
    dtype = request.param
    args = random_symmetric(52, n=512, ngroups=8, noffdiag=12, dtype=dtype,
                            contiguous=True)
    S = bt.SymmetricBlockMatrix(*args, device="cpu")
    J = bst.SymmetricBlockMatrix(*args, backend="xla")
    return dtype, S, J, bt.to_scipy(S).astype(np.complex128)


@pytest.mark.parametrize("r", RS)
@pytest.mark.parametrize("conj", [False, True])
def test_symmetric_mode_through_the_embedding(symmetric, conj, r):
    """S = D + O + O^T: the diagonal layout forward and the off-diagonal
    layout in the symmetric mode (both halves) through the embedding,
    against the JAX product and scipy."""
    dtype, S, J, Sp = symmetric
    diag = chunked_table(S, "_dlayout", "_dbuckets")
    off = chunked_table(S, "_olayout", "_obuckets")
    x = cvec(np.random.default_rng(10 + r), dtype, S.shape[0], r)
    xt = torch.from_numpy(x)
    out = torch.zeros(x.shape, dtype=xt.dtype)
    fused_spmm.complex_mma_apply_plain(diag, xt, out=out, conj=conj)
    fused_spmm.complex_mma_apply_plain(off, xt, out=out, symmetric=True,
                                       conj=conj)
    ref = Sp.conj() if conj else Sp
    jax_out = (J.conj() if conj else J) @ jnp.asarray(x)
    assert relerr(out, np.asarray(jax_out)) < TOL[dtype]
    assert relerr(out, ref @ x.astype(np.complex128)) < TOL[dtype]


@pytest.mark.parametrize("r", RS)
@pytest.mark.parametrize("mode", ["forward", "transpose", "symmetric"])
def test_sentinel_chunks_match_the_fma_plain_version(mode, r):
    """Chunk ids past n (sentinel chunks and ids of rows past the operand)
    read zero and scatter nowhere: the embedding equals the FMA
    instance's plain version on a table of scattered chunk tables,
    adding into a partial sum."""
    rng = np.random.default_rng(60 + r)
    n, nb, mp, kp, C = 256, 12, 32, 48, 16
    vals = torch.from_numpy(cvec(rng, np.complex128, nb, mp, kp))
    rc = torch.from_numpy(rng.integers(0, n // C + 2, (nb, mp // C))
                          .astype(np.int32))
    cc = torch.from_numpy(rng.integers(0, n // C + 2, (nb, kp // C))
                          .astype(np.int32))
    table = BucketTable([(vals, rc, cc, C)])
    x = torch.from_numpy(cvec(rng, np.complex128, n, r))
    prior = torch.from_numpy(cvec(rng, np.complex128, n, r))
    kw = {"transpose": mode == "transpose", "symmetric": mode == "symmetric"}
    for conj in (False, True):
        got = fused_spmm.complex_mma_apply_plain(table, x, out=prior.clone(),
                                                 conj=conj, **kw)
        ref = fused_spmm.multi_block_apply_plain(table, x, out=prior.clone(),
                                                 conj=conj, **kw)
        assert relerr(got, ref.numpy()) < 1e-13


def test_routing_rule():
    """The tensor-core instances take the pairs of ``MMA_RULES`` (complex64,
    and since the f64 / complex128 and bf16 -> f32 instances those too) at
    r >= their least r on blocks at most their cap deep; complex64 values
    take them only with a complex64 operand, and every other pair, r = 1
    and deeper blocks keep the FMA tile core."""
    c64, c128 = torch.complex64, torch.complex128
    rule = fused_spmm.MMA_RULES[(c64, c64)]
    lo, deep = rule.min_r, rule.max_depth
    assert lo >= 2
    assert fused_spmm.b1_instance(c64, c64, lo) == "mma"
    assert fused_spmm.b1_instance(c64, c64, 512, deep) == "mma"
    assert fused_spmm.b1_instance(c64, c64, 512, deep + 1) == "fma"
    assert fused_spmm.b1_instance(c64, c64, lo - 1) == "fma"
    assert fused_spmm.b1_instance(c64, c64, 1) == "fma"
    table = BucketTable([(torch.zeros(2, 16, 48, dtype=c64),
                          torch.zeros(2, 1, dtype=torch.int32),
                          torch.zeros(2, 3, dtype=torch.int32), 16),
                         (torch.zeros(1, 64, 32, dtype=c64),
                          torch.zeros(1, 2, dtype=torch.int32),
                          torch.zeros(1, 1, dtype=torch.int32), 32)])
    assert table.depth == 64
    for (stored, compute), rule in fused_spmm.MMA_RULES.items():
        assert fused_spmm.b1_instance(stored, compute, 1) == "fma"
        for r in (rule.min_r, 64, 200):
            assert fused_spmm.b1_instance(stored, compute, r, 64) == "mma"
        # past its cap (float64 and complex128 have none: IEEE sums)
        over = (rule.max_depth or 1 << 20) + 1
        want = "fma" if rule.max_depth is not None else "mma"
        assert fused_spmm.b1_instance(stored, compute, 64, over) == want
    assert fused_spmm.MMA_RULES[(torch.float64, torch.float64)].max_depth \
        is None
    for stored, compute in ((c64, c128), (torch.float32, torch.float32),
                            (torch.float32, torch.float64),
                            (torch.bfloat16, torch.float64)):
        for r in (1, lo, 64, 200):
            assert fused_spmm.b1_instance(stored, compute, r) == "fma"


@pytest.mark.parametrize("r", [1, 2, 16, 64])
def test_cpu_products_follow_the_rule(monkeypatch, r):
    """A CPU product of a complex64 operator runs the embedding exactly
    where the rule picks the tensor-core instance, the FMA plain version
    elsewhere, and both agree with the JAX product."""
    dtype = np.complex64
    args = random_block_sparse(53, shape=(320, 320), nblocks=16,
                               max_block=48, dtype=dtype, contiguous=True)
    A = bt.BlockSparseMatrix(*args, device="cpu")
    J = bst.BlockSparseMatrix(*args, backend="xla")
    seen = []
    for name in ("complex_mma_apply_plain", "multi_block_apply_plain"):
        orig = getattr(fused_spmm, name)

        def spy(*a, _orig=orig, _name=name, **k):
            seen.append(_name)
            return _orig(*a, **k)
        monkeypatch.setattr(fused_spmm, name, spy)
    shape = (A.shape[1],) if r == 1 else (A.shape[1], r)
    x = cvec(np.random.default_rng(70 + r), dtype, *shape)
    got = A @ torch.from_numpy(x)
    table = dispatch.bucket_tables(A._buckets, A.layout)["chunked"]
    want = ("complex_mma_apply_plain"
            if fused_spmm.b1_instance(torch.complex64, torch.complex64, r,
                                      table.depth)
            == "mma" else "multi_block_apply_plain")
    assert seen == [want]
    assert relerr(got, np.asarray(J @ jnp.asarray(x))) < TOL[dtype]
