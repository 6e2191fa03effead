"""The bucket route's multi-bucket launches on the CPU: B1 over a layout's
chunked buckets and B9's element pass over its element buckets.

On CPU tensors both launches run their plain versions (the loop of
``chunked_block_apply_plain`` over the buckets; the per-bucket
``mask_gather_plain`` -> einsum -> ``mask_scatter_add_plain`` chain), which
are held here against the JAX package on the same numpy inputs:
``xla_spmv.chunked_multi_apply`` (its one-gather, one-scatter chain over
same-chunk buckets) and ``chunked_bucket_apply`` per bucket (mixed chunks,
the symmetric mode), and ``xla_spmv.bucket_apply`` with its mask-select
kernels in interpret mode (f32) or as XLA ops (f64).  Tolerance
``tol * max(1, max|ref|)`` with tol 1e-5 (f32) and 1e-13 (f64).  Also: the
descriptor tables (built once per operator, first work items matching the
buckets), gradcheck of the autograd through both launches in x and in the
values, and one call of each launch per layout on every format's bucket
route.  The kernels themselves run only on a CUDA card (``chip_smoke.py``
phase 1).
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blocksparse_tpu.ops import xla_spmv

import blocksparse_tpu_torch as bt
from blocksparse_tpu_torch.ops import dispatch
from blocksparse_tpu_torch.ops.kernels import fused_spmm, mask_select
from blocksparse_tpu_torch.ops.kernels.fused_spmm import BucketTable
from blocksparse_tpu_torch.utils.testmatrices import (random_block_sparse,
                                                      random_symmetric)

torch.set_num_threads(2)

TOL = {np.float64: 1e-13, np.float32: 1e-5}
MODES = {"forward": dict(), "transpose": dict(transpose=True),
         "symmetric": dict(symmetric=True)}


def relerr(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b))) / max(1.0, float(np.max(np.abs(b))))


def chunked_buckets(rng, dtype, chunks, m, n):
    """Host-bucket stand-ins (the fields the JAX chain reads) for an m x n
    operand, one per entry of ``chunks``; chunk ids run one past the last
    partial chunk (reads zero, scatters nowhere) and repeat across blocks."""
    out = []
    for i, C in enumerate(chunks):
        nb, mp, kp = 5 + i, C * (2 + i % 2), C * (3 - i % 2)
        out.append(types.SimpleNamespace(
            chunk=C, mp=mp, kp=kp, nblocks=nb,
            values=rng.standard_normal((nb, mp, kp)).astype(dtype),
            row_chunk_idx=rng.integers(0, -(-m // C) + 1,
                                       (nb, mp // C)).astype(np.int32),
            col_chunk_idx=rng.integers(0, -(-n // C) + 1,
                                       (nb, kp // C)).astype(np.int32)))
    return out


def chunked_table(buckets):
    t = torch.from_numpy
    return BucketTable([(t(b.values), t(b.row_chunk_idx),
                         t(b.col_chunk_idx), b.chunk) for b in buckets])


def operand(rng, n, r, dtype):
    return rng.standard_normal((n, r) if r > 1 else n).astype(dtype)


@pytest.mark.parametrize("r", [1, 3])
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_multi_b1_plain_vs_jax_chunked_multi_apply(dtype, transpose, r):
    """Same-chunk buckets: the JAX engine's minimal-op chain (one gather,
    one einsum per bucket, one one-hot scatter) against one multi call."""
    m, n = 200, 168
    rng = np.random.default_rng(81)
    hbs = chunked_buckets(rng, dtype, (8, 8, 8), m, n)
    n_in, n_out = (m, n) if transpose else (n, m)
    x = operand(rng, n_in, r, dtype)
    want = xla_spmv.chunked_multi_apply(
        hbs, [jnp.asarray(b.values) for b in hbs], n_out, jnp.asarray(x),
        transpose=transpose, precision="highest")
    xt = torch.from_numpy(x)
    out = xt.new_zeros((n_out,) + xt.shape[1:])
    got = fused_spmm.multi_block_apply(chunked_table(hbs), xt, out=out,
                                       transpose=transpose)
    assert got is out
    assert relerr(got, want) <= TOL[dtype]


@pytest.mark.parametrize("r", [1, 3])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_multi_b1_plain_vs_jax_per_bucket(dtype, mode, r):
    """Mixed chunks, every mode: the sum of the JAX engine's per-bucket
    ``chunked_bucket_apply`` against one multi call, which adds into an
    output that already holds a partial sum."""
    sym = mode == "symmetric"
    m, n = (200, 200) if sym else (200, 168)
    rng = np.random.default_rng(82)
    hbs = chunked_buckets(rng, dtype, (4, 16, 8), m, n)
    n_in, n_out = (m, n) if mode == "transpose" else (n, m)
    x = operand(rng, n_in, r, dtype)
    prior = operand(rng, n_out, r, dtype)
    want = prior.astype(np.float64)
    for b in hbs:
        want = want + np.asarray(xla_spmv.chunked_bucket_apply(
            jnp.asarray(b.values), jnp.asarray(b.row_chunk_idx),
            jnp.asarray(b.col_chunk_idx), b.chunk, n_out, jnp.asarray(x),
            precision="highest", **MODES[mode]))
    got = fused_spmm.multi_block_apply(
        chunked_table(hbs), torch.from_numpy(x),
        out=torch.from_numpy(prior.copy()), **MODES[mode])
    assert relerr(got, want) <= TOL[dtype]


def element_buckets(rng, dtype, m, n):
    """Element buckets of an m x n operand: rows drawn with repeats (within
    and across blocks), sentinel lanes (index m / n) in both tables."""
    out = []
    for nb, mp, kp in ((64, 64, 64), (5, 2, 16), (3, 16, 1)):
        ridx = rng.integers(0, m, (nb, mp)).astype(np.int32)
        cidx = rng.integers(0, n, (nb, kp)).astype(np.int32)
        ridx[:, -1] = m
        cidx[1::2, -1] = n
        out.append((rng.standard_normal((nb, mp, kp)).astype(dtype), ridx,
                    cidx))
    return out


def element_table(elem):
    t = torch.from_numpy
    return BucketTable([(t(v), t(ri), t(ci), 1) for v, ri, ci in elem])


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_element_pass_plain_vs_jax_bucket_apply(dtype, mode):
    """The element pass's plain version against the JAX element engine,
    with its mask-select kernels in interpret mode at f32 (the first
    bucket's 4096-index tables take them) and as XLA ops at f64."""
    sym = mode == "symmetric"
    m, n = (300, 300) if sym else (300, 260)
    rng = np.random.default_rng(83)
    elem = element_buckets(rng, dtype, m, n)
    n_in, n_out = (m, n) if mode == "transpose" else (n, m)
    x = rng.standard_normal(n_in).astype(dtype)
    want = xla_spmv.bucket_apply(
        [tuple(map(jnp.asarray, e)) for e in elem], n_out, jnp.asarray(x),
        mask_gs="interpret" if dtype == np.float32 else None,
        precision="highest", **MODES[mode])
    xt = torch.from_numpy(x)
    got = mask_select.element_apply(element_table(elem), xt,
                                    out=xt.new_zeros(n_out), **MODES[mode])
    assert relerr(got, want) <= TOL[dtype]


@pytest.mark.parametrize("mode", list(MODES))
def test_element_pass_plain_multi_rhs_f64(mode):
    """r = 3: the same chain through gather_rows / scatter_rows."""
    rng = np.random.default_rng(84)
    elem = element_buckets(rng, np.float64, 120, 120)
    x = rng.standard_normal((120, 3))
    want = xla_spmv.bucket_apply([tuple(map(jnp.asarray, e)) for e in elem],
                                 120, jnp.asarray(x), **MODES[mode])
    xt = torch.from_numpy(x)
    got = mask_select.element_apply(element_table(elem), xt,
                                    out=torch.zeros(120, 3,
                                                    dtype=torch.float64),
                                    **MODES[mode])
    assert relerr(got, want) <= TOL[np.float64]


def test_descriptor_tables_built_once_per_operator():
    blocks, rows, cols, shape = random_block_sparse(
        85, shape=(220, 190), nblocks=16, max_block=40, dtype=np.float64,
        contiguous=True)
    A = bt.BlockSparseMatrix(blocks, rows, cols, shape, device="cpu")
    assert isinstance(A._buckets, dispatch.StagedBuckets)
    x = torch.randn(shape[1], dtype=torch.float64)
    A @ x
    tables = dict(A._buckets.tables)
    A @ x
    A.T @ torch.randn(shape[0], dtype=torch.float64)
    for kind, want_chunked in (("chunked", True), ("element", False)):
        tab = tables[kind]
        assert A._buckets.tables[kind] is tab
        hbs = [hb for hb in A.layout.buckets if (hb.chunk > 1) == want_chunked]
        assert tab is not None and len(tab) == len(hbs)
        for side, ext in ((0, "mp"), (1, "kp")):
            sizes = [hb.nblocks * -(-getattr(hb, ext) // 64) for hb in hbs]
            assert tab.first[side] == tuple(np.cumsum([0] + sizes)[:-1])
            assert tab.items[side] == sum(sizes)
        rows_ = tab.table.numpy()
        assert rows_.shape == (len(hbs), 9)
        for i, (row, hb, (v, rt, ct, c)) in enumerate(
                zip(rows_, hbs, tab.buckets)):
            assert tuple(row[5:]) == (hb.mp, hb.kp, hb.chunk, hb.nblocks)
            assert tuple(row[:3]) == (v.data_ptr(), rt.data_ptr(),
                                      ct.data_ptr())
            assert (row[3], row[4]) == (tab.first[0][i], tab.first[1][i])
            assert c == hb.chunk


def test_descriptor_tables_symmetric_operator():
    """One pair of tables per layout (diagonal, off-diagonal), kept on the
    operator's staged buckets and reused by the next product."""
    d, di, o, ri, ci, shape = random_symmetric(
        86, n=160, ngroups=5, noffdiag=6, dtype=np.float64, contiguous=True)
    S = bt.SymmetricBlockMatrix(d, di, o, ri, ci, shape, device="cpu",
                                schedule="serial")
    x = torch.randn(shape[0], dtype=torch.float64)
    S @ x
    first = [dict(b.tables) for b in (S._dbuckets, S._obuckets)]
    S.T @ x
    for b, t in zip((S._dbuckets, S._obuckets), first):
        assert all(b.tables[k] is t[k] for k in t)
    assert S._obuckets.tables["chunked"] is not S._dbuckets.tables["chunked"]


@pytest.mark.parametrize("mode", list(MODES))
def test_multi_b1_gradcheck(mode):
    rng = np.random.default_rng(87)
    hbs = chunked_buckets(rng, np.float64, (4, 8), 40, 40)
    t = torch.from_numpy
    vals = [t(b.values).requires_grad_() for b in hbs]
    x = torch.randn(40, 2, dtype=torch.float64, requires_grad=True)

    def fn(x_, *v):
        table = BucketTable([(vv, t(b.row_chunk_idx), t(b.col_chunk_idx),
                              b.chunk) for vv, b in zip(v, hbs)])
        return fused_spmm.multi_fused_apply(
            table, x_, out=torch.zeros(40, 2, dtype=torch.float64),
            **MODES[mode])
    assert torch.autograd.gradcheck(fn, (x, *vals))


@pytest.mark.parametrize("mode", list(MODES))
def test_element_pass_gradcheck(mode):
    rng = np.random.default_rng(88)
    elem = [(v[:3, :4, :6].copy(), ri[:3, :4].copy(), ci[:3, :6].copy())
            for v, ri, ci in element_buckets(rng, np.float64, 30, 30)[:1]]
    elem += [e for e in element_buckets(rng, np.float64, 30, 30)[1:]]
    t = torch.from_numpy
    vals = [t(v).requires_grad_() for v, _, _ in elem]
    x = torch.randn(30, dtype=torch.float64, requires_grad=True)

    def fn(x_, *v):
        table = BucketTable([(vv, t(ri), t(ci), 1)
                             for vv, (_, ri, ci) in zip(v, elem)])
        return mask_select.element_fused_apply(
            table, x_, out=torch.zeros(30, dtype=torch.float64),
            **MODES[mode])
    assert torch.autograd.gradcheck(fn, (x, *vals))


def spy(monkeypatch, module, name, calls=None):
    calls = [] if calls is None else calls
    orig = getattr(module, name)

    def wrapped(*a, **k):
        calls.append(k)
        return orig(*a, **k)
    monkeypatch.setattr(module, name, wrapped)
    return calls


def general_operator(kind):
    blocks, rows, cols, shape = random_block_sparse(
        88, shape=(220, 190), nblocks=16, max_block=40, dtype=np.float64,
        contiguous=True)
    if kind == "vbcrs":
        return bt.VariableBlockCompressedRowStorage(
            blocks, [r[0] for r in rows], [c[0] for c in cols], shape,
            device="cpu")
    return bt.BlockSparseMatrix(blocks, rows, cols, shape, device="cpu")


@pytest.mark.parametrize("r", [1, 4])
@pytest.mark.parametrize("kind", ["bsm", "vbcrs", "symmetric"])
def test_one_launch_of_each_kind_per_layout(monkeypatch, kind, r):
    """f64 products take the bucket route on every format: one multi B1
    call and one element pass per layout and product (the symmetric
    format: the diagonal's, then the off-diagonals' in symmetric mode),
    and the product matches scipy.  A B1 call is the plain version of the
    instance ``fused_spmm.b1_instance`` picks: the FMA tile core's at r =
    1, the f64 tensor-core instance's at r > 1."""
    b1 = []
    for name in ("multi_block_apply_plain", "mma_apply_plain"):
        spy(monkeypatch, fused_spmm, name, b1)
    mma = spy(monkeypatch, fused_spmm, "mma_apply_plain")
    b9 = spy(monkeypatch, mask_select, "element_apply_plain")
    if kind == "symmetric":
        d, di, o, ri, ci, shape = random_symmetric(
            86, n=160, ngroups=5, noffdiag=6, dtype=np.float64,
            contiguous=True)
        op = bt.SymmetricBlockMatrix(d, di, o, ri, ci, shape, device="cpu",
                                     schedule="serial")
        layouts = [op._dlayout, op._olayout]
    else:
        op = general_operator(kind)
        layouts = [op.layout]
    n = op.shape[1]
    x = torch.randn((n, r) if r > 1 else n, dtype=torch.float64)
    got = op @ x
    want_b1 = [any(hb.chunk > 1 for hb in lay.buckets) for lay in layouts]
    want_b9 = [any(hb.chunk == 1 for hb in lay.buckets) for lay in layouts]
    assert all(want_b1) and any(want_b9)
    assert len(b1) == len(layouts) and len(b9) == sum(want_b9)
    assert len(mma) == (len(layouts) if r > 1 else 0)
    if kind == "symmetric":
        assert [c["symmetric"] for c in b1] == [False, True][-len(b1):]
    S = bt.to_scipy(op).toarray()
    assert relerr(got, S @ x.numpy()) <= TOL[np.float64]


@pytest.mark.parametrize("r", [1, 4])
@pytest.mark.parametrize("kind", ["bsm", "symmetric"])
def test_one_launch_of_each_kind_per_layout_colored(monkeypatch, kind, r):
    """Under schedule="colored", with the colored plan made to win: per
    layout one multi B1 call, and the element buckets of each layout in the
    colored element route (one ``colored_apply``: its products pass and one
    rounds launch on the card) in place of the element pass; the product
    matches scipy."""
    b1 = spy(monkeypatch, fused_spmm, "multi_block_apply_plain")
    spy(monkeypatch, fused_spmm, "mma_apply_plain", b1)
    b9 = spy(monkeypatch, mask_select, "element_apply_plain")
    colored = spy(monkeypatch, mask_select, "colored_apply_plain")
    monkeypatch.setattr(dispatch, "colored_wins", lambda *a: True)
    if kind == "symmetric":
        d, di, o, ri, ci, shape = random_symmetric(
            86, n=160, ngroups=5, noffdiag=6, dtype=np.float64,
            contiguous=True)
        op = bt.SymmetricBlockMatrix(d, di, o, ri, ci, shape, device="cpu")
        layouts = [op._dlayout, op._olayout]
    else:
        blocks, rows, cols, shape = random_block_sparse(
            88, shape=(220, 190), nblocks=16, max_block=40, dtype=np.float64,
            contiguous=True)
        op = bt.BlockSparseMatrix(blocks, rows, cols, shape, device="cpu",
                                  schedule="colored")
        layouts = [op.layout]
    x = torch.randn((op.shape[1], r) if r > 1 else op.shape[1],
                    dtype=torch.float64)
    got = op @ x
    want_b9 = [any(hb.chunk == 1 for hb in lay.buckets) for lay in layouts]
    assert any(want_b9)
    assert len(b1) == len(layouts) and not b9
    assert len(colored) == sum(want_b9)
    assert relerr(got, bt.to_scipy(op).toarray() @ x.numpy()) <= \
        TOL[np.float64]


def test_multi_calls_refuse_bad_inputs():
    rng = np.random.default_rng(91)
    hbs = chunked_buckets(rng, np.float32, (8,), 64, 64)
    table = chunked_table(hbs)
    x = torch.zeros(64)
    with pytest.raises(ValueError, match="transpose-invariant"):
        fused_spmm.multi_block_apply(table, x, out=torch.zeros(64),
                                     transpose=True, symmetric=True)
    with pytest.raises(ValueError, match="square"):
        fused_spmm.multi_block_apply(table, x, out=torch.zeros(72),
                                     symmetric=True)
    with pytest.raises(TypeError, match="dtype"):
        fused_spmm.multi_block_apply(table, x.double(), out=torch.zeros(64))
    with pytest.raises(ValueError, match="contiguous"):
        fused_spmm.multi_block_apply(table, torch.zeros(64, 2),
                                     out=torch.zeros(2, 64).T)
    with pytest.raises(ValueError, match="element buckets"):
        mask_select.element_apply(table, x, out=torch.zeros(64))
    with pytest.raises(ValueError, match="does not match"):
        BucketTable([(torch.zeros(2, 8, 8), torch.zeros(2, 2, dtype=torch.int32),
                      torch.zeros(2, 1, dtype=torch.int32), 8)])
    meta = BucketTable([(torch.zeros(1, 8, 8, device="meta"),
                         torch.zeros(1, 1, dtype=torch.int32, device="meta"),
                         torch.zeros(1, 1, dtype=torch.int32, device="meta"),
                         8)])
    with pytest.raises(ValueError, match="no kernel for device"):
        fused_spmm.multi_block_apply(meta, x.to("meta"),
                                     out=torch.zeros(64, device="meta"))
