"""B1's float64, complex128 and bf16 -> float32 tensor-core instances on the
CPU: their plain version held to the JAX package, scipy and the FMA
instance's plain version, and the rule that routes a table to them.

On the card, float64 and complex128 tables at r >= their least r of
``fused_spmm.MMA_RULES`` run ``csrc/dmma.cu`` (the block's GEMM, or the
real embedding of ``complex_mma.cu``, on f64 ``mma.sync``) and bf16 values
with a float32 operand run ``csrc/bf16_mma.cu`` (x split exactly into three
bf16 parts, three bf16 passes with float32 sums).  Their plain version,
``fused_spmm.mma_apply_plain``, is what a CPU tensor runs wherever the rule
picks them.  The same numpy blocks from a seed go into the JAX package's
operators (``backend="xla"``, x64 on) and into the port.  Tolerances,
relative to max(1, max|ref|): 1e-13 for float64 / complex128; for bf16,
``TOL16`` (2e-2) against the JAX bf16 operator (whose product rounds
differently) and 1e-5 against the float64 product of the operator's own
bf16 values.

- ``split3``: the three bf16 parts sum to x exactly;
- the three formats' products (BSM, ``SymmetricBlockMatrix``, VBCRS) with
  their chunked tables through the plain version, in modes @, .T, .H and
  .conj(), r in {2, 16, 64}, against scipy, and at r = 16 against the JAX
  product (the symmetric bf16 operator has no JAX counterpart);
- the plain version against the FMA instance's on a table of scattered
  chunk tables with sentinel chunk ids and a deep block, forward,
  transpose, symmetric (and conj), adding into a partial sum;
- a CPU product reaches the plain version exactly where the rule says.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import blocksparse_tpu as bst
import blocksparse_tpu_torch as bt
from blocksparse_tpu_torch.ops import dispatch
from blocksparse_tpu_torch.ops.kernels import fused_spmm, mask_select
from blocksparse_tpu_torch.ops.kernels.fused_spmm import BucketTable
from blocksparse_tpu_torch.utils.testmatrices import (random_block_sparse,
                                                      random_symmetric,
                                                      random_vbcrs)

torch.set_num_threads(2)

TOL64, TOL32, TOL16 = 1e-13, 1e-5, 2e-2
RS = [2, 16, 64]
JAX_R = 16  # the r of the JAX comparisons (each compiles its own graph)
# pair -> (numpy dtype of the blocks and the operand, stored, compute)
PAIRS = {"f64": (np.float64, torch.float64, torch.float64),
         "c128": (np.complex128, torch.complex128, torch.complex128),
         "bf16": (np.float32, torch.bfloat16, torch.float32)}
# mode -> (transpose, conj, JAX view, scipy view)
MODES = {
    "@": (False, False, lambda J: J, lambda S: S),
    ".T": (True, False, lambda J: J.T, lambda S: S.T),
    ".H": (True, True, lambda J: J.H, lambda S: S.conj().T),
    ".conj()": (False, True, lambda J: J.conj(), lambda S: S.conj()),
}


def relerr(a, b):
    a = np.asarray(a.numpy() if isinstance(a, torch.Tensor) else a,
                   np.complex128)
    b = np.asarray(b, np.complex128)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(1.0, float(np.max(np.abs(b))) if b.size else 1.0)
    return float(np.max(np.abs(a - b))) / scale if a.size else 0.0


def operand(rng, np_dtype, *shape):
    v = rng.standard_normal(shape)
    if np.issubdtype(np_dtype, np.complexfloating):
        v = v + 1j * rng.standard_normal(shape)
    return v.astype(np_dtype)


def modes_of(pair):
    """The modes that differ for the pair (real values: @ and .T)."""
    return list(MODES) if pair == "c128" else ["@", ".T"]


def layouts(op):
    """(staged buckets, layout, symmetric mode) of each layout of ``op``."""
    if hasattr(op, "_dlayout"):
        return [(op._dbuckets, op._dlayout, False),
                (op._obuckets, op._olayout, True)]
    return [(op._buckets, op._layout, False)]


def bucket_product(op, x, *, transpose=False, conj=False):
    """``op``'s bucket route on the CPU with every chunked table through
    the tensor-core instances' plain version and every element table
    through B9's element pass's (the symmetric format's off-diagonal layout
    in the symmetric mode)."""
    n_out = op.shape[1] if transpose else op.shape[0]
    out = torch.zeros((n_out, x.shape[1]), dtype=x.dtype)
    for staged, layout, sym in layouts(op):
        tabs = dispatch.bucket_tables(staged, layout)
        kw = dict(transpose=transpose and not sym, symmetric=sym, conj=conj)
        if tabs["chunked"] is not None:
            fused_spmm.mma_apply_plain(tabs["chunked"], x, out=out, **kw)
        if tabs["element"] is not None:
            mask_select.element_apply_plain(tabs["element"], x, out=out, **kw)
    return out


def test_split3_is_exact():
    """h + m + l == x exactly for float32 x over many binades, each part
    a bf16 value."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(20000)
         * 2.0 ** rng.integers(-60, 60, 20000)).astype(np.float32)
    h, m, l = fused_spmm.split3(torch.from_numpy(x))
    assert h.dtype == m.dtype == l.dtype == torch.bfloat16
    total = (h.double() + m.double() + l.double()).numpy()
    assert np.array_equal(total, x.astype(np.float64))


FORMATS = ["general", "symmetric", "vbcrs"]


def build(lib, fmt, args, stored):
    cls = {"symmetric": "SymmetricBlockMatrix",
           "vbcrs": "VariableBlockCompressedRowStorage"}.get(
               fmt, "BlockSparseMatrix")
    if lib is bt:
        kw = {"device": "cpu"}
        if stored == torch.bfloat16:
            kw["dtype"] = torch.bfloat16
    else:
        kw = {"backend": "xla"}
        if stored == torch.bfloat16:
            kw["dtype"] = jnp.bfloat16
    return getattr(lib, cls)(*args, **kw)


@pytest.fixture(scope="module", params=[(f, p) for f in FORMATS
                                        for p in PAIRS],
                ids=lambda fp: f"{fp[0]}-{fp[1]}")
def operators(request):
    """(pair, port operator, JAX operator or None, scipy float64 /
    complex128 copy of the port's values)."""
    fmt, pair = request.param
    np_dtype, stored, _ = PAIRS[pair]
    if fmt == "general":
        args = random_block_sparse(51, shape=(448, 448), nblocks=30,
                                   max_block=64, dtype=np_dtype,
                                   contiguous=True)
    elif fmt == "symmetric":
        args = random_symmetric(52, n=512, ngroups=8, noffdiag=12,
                                dtype=np_dtype, contiguous=True)
    else:
        args = random_vbcrs(53, shape=(280, 300), nrowgroups=8, ncolgroups=7,
                            dtype=np_dtype)
    port = build(bt, fmt, args, stored)
    jax_op = (None if fmt == "symmetric" and pair == "bf16"
              else build(bst, fmt, args, stored))
    wide = np.complex128 if pair == "c128" else np.float64
    return pair, port, jax_op, bt.to_scipy(port).astype(wide)


@pytest.mark.parametrize("r", RS)
def test_formats_through_the_plain_version(operators, r):
    """Every mode of a format's product with its chunked tables through the
    plain version against scipy, and at r = ``JAX_R`` against the JAX
    product."""
    pair, port, J, S = operators
    np_dtype, stored, compute = PAIRS[pair]
    assert any(dispatch.bucket_tables(st, lay)["chunked"] is not None
               for st, lay, _ in layouts(port))
    rng = np.random.default_rng(r)
    for mode in modes_of(pair):
        transpose, conj, jax_view, sp_view = MODES[mode]
        n_in = port.shape[0] if transpose else port.shape[1]
        x = operand(rng, np_dtype, n_in, r)
        got = bucket_product(port, torch.from_numpy(x), transpose=transpose,
                             conj=conj)
        assert got.dtype == compute
        ref = sp_view(S) @ x.astype(S.dtype)
        assert relerr(got, ref) < (TOL32 if pair == "bf16" else TOL64), mode
        if J is not None and r == JAX_R:
            want = np.asarray(jax_view(J) @ jnp.asarray(x))
            assert relerr(got, want) < (TOL16 if pair == "bf16" else TOL64), \
                mode


def scattered_table(pair, deep: int) -> BucketTable:
    """Chunk tables drawn with repeats and ids past n = 256 (sentinel chunks
    and rows past the operand: read zero, scatter nowhere), and a bucket of
    ``deep``-column blocks."""
    np_dtype, stored, _ = PAIRS[pair]
    rng = np.random.default_rng(60)
    n, C = 256, 16
    buckets = []
    for nb, mp, kp in ((12, 32, 48), (2, 16, deep)):
        vals = torch.from_numpy(operand(rng, np_dtype, nb, mp, kp)).to(stored)
        rc = rng.integers(0, n // C + 2, (nb, mp // C)).astype(np.int32)
        cc = rng.integers(0, n // C + 2, (nb, kp // C)).astype(np.int32)
        buckets.append((vals.contiguous(), torch.from_numpy(rc),
                        torch.from_numpy(cc), C))
    return BucketTable(buckets)


@pytest.mark.parametrize("r", RS)
@pytest.mark.parametrize("mode", ["forward", "transpose", "symmetric"])
@pytest.mark.parametrize("pair", list(PAIRS))
def test_plain_version_matches_the_fma_plain_version(pair, mode, r):
    """On sentinel chunks and the deepest block the rule admits (its cap;
    2048 columns for the f64 types, which have none), adding into a
    partial sum: the tensor-core instances' plain version equals the FMA
    instance's."""
    np_dtype, stored, compute = PAIRS[pair]
    deep = fused_spmm.MMA_RULES[(stored, compute)].max_depth or 2048
    table = scattered_table(pair, deep)
    assert table.depth == deep
    assert fused_spmm.b1_instance(stored, compute, r, table.depth) == "mma"
    rng = np.random.default_rng(70 + r)
    x = torch.from_numpy(operand(rng, np_dtype, 256, r)).to(compute)
    prior = torch.from_numpy(operand(rng, np_dtype, 256, r)).to(compute)
    kw = {"transpose": mode == "transpose", "symmetric": mode == "symmetric"}
    tol = TOL32 if pair == "bf16" else TOL64
    for conj in ((False, True) if pair == "c128" else (False,)):
        got = fused_spmm.mma_apply_plain(table, x, out=prior.clone(),
                                         conj=conj, **kw)
        ref = fused_spmm.multi_block_apply_plain(table, x, out=prior.clone(),
                                                 conj=conj, **kw)
        assert got.dtype == compute
        assert relerr(got, ref.numpy()) < tol, conj


@pytest.mark.parametrize("r", [1, 2, 16, 64])
@pytest.mark.parametrize("pair", list(PAIRS))
def test_cpu_products_follow_the_rule(monkeypatch, pair, r):
    """A CPU product of an operator of the pair runs the tensor-core
    instances' plain version exactly where the rule picks them, the FMA
    plain version elsewhere, and agrees with the JAX product."""
    np_dtype, stored, compute = PAIRS[pair]
    args = random_block_sparse(53, shape=(320, 320), nblocks=16,
                               max_block=48, dtype=np_dtype, contiguous=True)
    A = build(bt, "general", args, stored)
    J = build(bst, "general", args, stored)
    seen = []
    for name in ("mma_apply_plain", "multi_block_apply_plain"):
        orig = getattr(fused_spmm, name)

        def spy(*a, _orig=orig, _name=name, **k):
            seen.append(_name)
            return _orig(*a, **k)
        monkeypatch.setattr(fused_spmm, name, spy)
    shape = (A.shape[1],) if r == 1 else (A.shape[1], r)
    x = operand(np.random.default_rng(80 + r), np_dtype, *shape)
    got = A @ torch.from_numpy(x)
    table = dispatch.bucket_tables(A._buckets, A._layout)["chunked"]
    want = ("mma_apply_plain"
            if fused_spmm.b1_instance(stored, compute, r, table.depth)
            == "mma" else "multi_block_apply_plain")
    assert seen == [want]
    assert got.dtype == compute
    tol = TOL16 if pair == "bf16" else TOL64
    assert relerr(got, np.asarray(J @ jnp.asarray(x))) < tol
