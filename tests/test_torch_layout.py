"""The port's numpy planners vs the JAX package's originals: bit-identical.

blocksparse_tpu_torch carries its own copies of ``build_layout``,
``build_patch_plan`` and the fixture generators (the card it runs on has no
jax).  These tests hold every array the copies emit equal to the
originals', byte for byte, on contiguous, chunk-scattered,
element-scattered and mixed-size populations.
"""

import numpy as np
import pytest
import torch

from blocksparse_tpu.core.layout import build_layout as jax_build_layout
from blocksparse_tpu.core.patch import build_patch_plan as jax_build_patch_plan
from blocksparse_tpu.utils import testmatrices as jax_tm

from blocksparse_tpu_torch.core.layout import build_layout
from blocksparse_tpu_torch.core.patch import build_patch_plan
from blocksparse_tpu_torch.utils import testmatrices as tm

torch.set_num_threads(2)

_BUCKET_FIELDS = ("values", "row_idx", "col_idx", "block_ids", "true_m",
                  "true_k", "row_start", "col_start", "row_off", "col_off",
                  "row_chunk_idx", "col_chunk_idx")


def chunk_scattered(seed, n=512, nblocks=16, C=16):
    """Blocks whose index lists are unions of two C-aligned runs: scattered
    lists with an exact chunk cover."""
    rng = np.random.default_rng(seed)
    blocks, rows, cols = [], [], []
    for _ in range(nblocks):
        def runs():
            a, b = rng.choice(n // C, size=2, replace=False)
            return np.sort(np.concatenate([np.arange(a * C, a * C + C),
                                           np.arange(b * C, b * C + C)]))
        ri, ci = runs(), runs()
        blocks.append(rng.standard_normal((ri.size, ci.size)))
        rows.append(ri)
        cols.append(ci)
    return blocks, rows, cols, (n, n)


def fixture(kind):
    if kind == "contiguous":
        return tm.random_block_sparse(1, shape=(384, 448), nblocks=20,
                                      max_block=60, dtype=np.float64,
                                      contiguous=True)
    if kind == "aligned":
        rng = np.random.default_rng(7)
        n, bs = 512, 32
        pos = rng.choice((n // bs) ** 2, size=24, replace=False)
        rows = [np.arange(p // (n // bs) * bs, p // (n // bs) * bs + bs)
                for p in pos]
        cols = [np.arange(p % (n // bs) * bs, p % (n // bs) * bs + bs)
                for p in pos]
        return ([rng.standard_normal((bs, bs)) for _ in pos], rows, cols,
                (n, n))
    if kind == "chunk-scattered":
        return chunk_scattered(3)
    if kind == "element-scattered":
        return tm.random_block_sparse(2, shape=(300, 260), nblocks=18,
                                      max_block=24, dtype=np.float64)
    if kind == "mixed":
        b1, r1, c1, shape = tm.random_block_sparse(
            4, shape=(512, 512), nblocks=12, max_block=90, dtype=np.float64,
            contiguous=True)
        b2, r2, c2, _ = chunk_scattered(5, n=512, nblocks=6, C=8)
        b3, r3, c3, _ = tm.random_block_sparse(6, shape=(512, 512),
                                               nblocks=5, max_block=20,
                                               dtype=np.float64)
        return b1 + b2 + b3, r1 + r2 + r3, c1 + c2 + c3, shape
    raise ValueError(kind)


KINDS = ["contiguous", "aligned", "chunk-scattered", "element-scattered",
         "mixed"]


def assert_same_array(a, b, what):
    if a is None or b is None:
        assert a is None and b is None, what
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert a.tobytes() == b.tobytes(), what


def assert_same_layout(mine, ref):
    assert (mine.nrows, mine.ncols, mine.nblocks) == (ref.nrows, ref.ncols,
                                                      ref.nblocks)
    assert len(mine.buckets) == len(ref.buckets)
    for i, (bm, br) in enumerate(zip(mine.buckets, ref.buckets)):
        assert (bm.mp, bm.kp, bm.chunk) == (br.mp, br.kp, br.chunk)
        for f in _BUCKET_FIELDS:
            assert_same_array(getattr(bm, f), getattr(br, f), f"bucket {i} {f}")
    assert mine.block_loc == ref.block_loc
    assert mine.block_nnz == ref.block_nnz
    assert mine.nnz == ref.nnz and mine.padded_nnz == ref.padded_nnz
    assert mine.digest == ref._digest
    for a, b in zip(mine.rowindices + mine.colindices,
                    ref.rowindices + ref.colindices):
        assert_same_array(a, b, "index lists")
    for i in range(mine.nblocks):
        assert_same_array(mine.extract_block(i), ref.extract_block(i),
                          f"block {i}")


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("kind", KINDS)
def test_layout_bit_identical(kind, dtype):
    blocks, rows, cols, shape = fixture(kind)
    blocks = [b.astype(dtype) for b in blocks]
    mine = build_layout(blocks, rows, cols, shape)
    ref = jax_build_layout(blocks, rows, cols, shape, granularity="pow2")
    assert_same_layout(mine, ref)
    if kind in ("chunk-scattered", "mixed"):
        assert any(b.chunk > 1 and not b.all_contiguous for b in mine.buckets)
    if kind == "element-scattered":
        assert any(b.chunk == 1 for b in mine.buckets)


@pytest.mark.parametrize("fmt", ["csr", "csc", "coo"])
@pytest.mark.parametrize("kind", ["contiguous", "element-scattered"])
def test_layout_from_scipy_blocks_bit_identical(kind, fmt):
    """scipy.sparse blocks beside dense ones: densified into the same
    buckets, their stored entry counts kept as ``block_nnz`` and summed by
    ``nnz`` (the reference's rule), byte-equal to the JAX layout."""
    import scipy.sparse as sp

    blocks, rows, cols, shape = fixture(kind)
    blocks = [sp.random(*b.shape, density=0.3, format=fmt, random_state=i)
              if i % 3 == 0 else b for i, b in enumerate(blocks)]
    mine = build_layout(blocks, rows, cols, shape)
    ref = jax_build_layout(blocks, rows, cols, shape, granularity="pow2")
    assert_same_layout(mine, ref)
    assert mine.block_nnz[0] == blocks[0].nnz < np.prod(blocks[0].shape)
    assert mine.nnz < sum(r.size * c.size for r, c in zip(rows, cols))


def test_digest_is_computed_where_read():
    """The digest is the JAX one, computed at its first read and cached;
    layouts of equal content digest equal, and a changed value changes
    it."""
    blocks, rows, cols, shape = fixture("mixed")
    mine = build_layout(blocks, rows, cols, shape)
    assert "digest" not in vars(mine)
    assert mine.digest == jax_build_layout(blocks, rows, cols, shape,
                                           granularity="pow2")._digest
    assert vars(mine)["digest"] == mine.digest
    assert build_layout(blocks, rows, cols, shape).digest == mine.digest
    blocks[0] = blocks[0] + 1.0
    assert build_layout(blocks, rows, cols, shape).digest != mine.digest


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_layout_bit_identical_more_seeds(seed):
    """Mixed populations at further seeds, square and rectangular."""
    blocks, rows, cols, shape = random_block_sparse_mixed(seed)
    mine = build_layout(blocks, rows, cols, shape)
    ref = jax_build_layout(blocks, rows, cols, shape, granularity="pow2")
    assert_same_layout(mine, ref)


@pytest.mark.parametrize("granularity", [(8, 128), (1, 1), (32, 32)])
@pytest.mark.parametrize("kind", ["contiguous", "mixed"])
def test_layout_bit_identical_tuple_granularity(kind, granularity):
    """(gm, gk) bucket keys, as the config-3 recipe's (8, 128)."""
    blocks, rows, cols, shape = fixture(kind)
    mine = build_layout(blocks, rows, cols, shape, granularity=granularity)
    ref = jax_build_layout(blocks, rows, cols, shape, granularity=granularity)
    assert_same_layout(mine, ref)


def test_layout_rejects_bad_granularity():
    blocks, rows, cols, shape = fixture("contiguous")
    for bad in ("exact", (8,), (0, 4)):
        with pytest.raises(ValueError, match="granularity"):
            build_layout(blocks, rows, cols, shape, granularity=bad)


def random_block_sparse_mixed(seed):
    b1, r1, c1, shape = tm.random_block_sparse(
        seed, shape=(448, 320), nblocks=10, max_block=70, dtype=np.float64,
        contiguous=True)
    b2, r2, c2, _ = tm.random_block_sparse(seed + 100, shape=(448, 320),
                                           nblocks=6, max_block=30,
                                           dtype=np.float64)
    return b1 + b2, r1 + r2, c1 + c2, shape


def assert_same_plan(mine, ref):
    assert (mine.nrows, mine.ncols, mine.symmetric, mine.logical_nnz) == (
        ref.nrows, ref.ncols, ref.symmetric, ref.logical_nnz)
    assert len(mine.buckets) == len(ref.buckets)
    for bm, br in zip(mine.buckets, ref.buckets):
        assert (bm.MP, bm.KP, bm.G) == (br.MP, br.KP, br.G)
        for f in ("vals", "col_chunk", "row_start", "mirror_kc"):
            assert_same_array(getattr(bm, f), getattr(br, f), f)
    assert mine.value_bytes == ref.value_bytes


@pytest.mark.parametrize("kind", ["contiguous", "aligned", "mixed"])
def test_patch_plan_bit_identical(kind):
    blocks, rows, cols, shape = fixture(kind)
    blocks = [b.astype(np.float32) for b in blocks]
    mine_l = build_layout(blocks, rows, cols, shape)
    ref_l = jax_build_layout(blocks, rows, cols, shape, granularity="pow2")
    mine = build_patch_plan(mine_l)
    ref = jax_build_patch_plan(ref_l, optimize="auto")
    if kind == "mixed":     # scattered members make the plan ineligible
        assert mine is None and ref is None
        return
    assert mine is not None
    assert_same_plan(mine, ref)


@pytest.mark.parametrize("transpose_main", [False, True])
def test_patch_plan_symmetric_bit_identical(transpose_main):
    d, di, o, ri, ci, shape = tm.random_symmetric(
        8, n=320, ngroups=6, noffdiag=8, dtype=np.float32, contiguous=True)
    mine_d, mine_o = build_layout(d, di, di, shape), build_layout(o, ri, ci, shape)
    ref_d = jax_build_layout(d, di, di, shape, granularity="pow2")
    ref_o = jax_build_layout(o, ri, ci, shape, granularity="pow2")
    mine = build_patch_plan(mine_d, extra_layout=mine_o,
                            transpose_main=transpose_main)
    assert mine.symmetric and mine.buckets[0].mirror_kc.any()
    assert_same_plan(mine, jax_build_patch_plan(
        ref_d, extra_layout=ref_o, transpose_main=transpose_main,
        optimize="auto"))


@pytest.mark.parametrize("optimize", ["auto", "latency", "throughput", None])
@pytest.mark.parametrize("kind", ["contiguous", "aligned", "symmetric",
                                  "wide"])
def test_patch_plan_bias_bit_identical(kind, optimize):
    """``optimize=`` shapes the plan as in the JAX planner: byte-equal
    under every value (None is "auto"; the JAX side gets the value itself,
    so its ``BST_OPT`` fallback is never read)."""
    if kind == "symmetric":
        d, di, o, ri, ci, shape = tm.random_symmetric(
            8, n=320, ngroups=6, noffdiag=8, dtype=np.float32,
            contiguous=True)
        mine = build_patch_plan(build_layout(d, di, di, shape),
                                extra_layout=build_layout(o, ri, ci, shape),
                                optimize=optimize)
        ref = jax_build_patch_plan(
            jax_build_layout(d, di, di, shape, granularity="pow2"),
            extra_layout=jax_build_layout(o, ri, ci, shape,
                                          granularity="pow2"),
            optimize=optimize or "auto")
    else:
        if kind == "wide":  # many slots: the search differs from auto
            blocks, rows, cols, shape = tm.random_block_sparse(
                9, shape=(2048, 2048), nblocks=160, max_block=48,
                dtype=np.float32, contiguous=True)
        else:
            blocks, rows, cols, shape = fixture(kind)
            blocks = [b.astype(np.float32) for b in blocks]
        mine = build_patch_plan(build_layout(blocks, rows, cols, shape),
                                optimize=optimize)
        ref = jax_build_patch_plan(
            jax_build_layout(blocks, rows, cols, shape, granularity="pow2"),
            optimize=optimize or "auto")
    assert_same_plan(mine, ref)


def test_patch_plan_throughput_moves_only_g():
    """On a population with many slots the throughput bias picks another
    grid group than "auto": the same slots, other zero padding."""
    blocks, rows, cols, shape = tm.random_block_sparse(
        9, shape=(2048, 2048), nblocks=160, max_block=48, dtype=np.float32,
        contiguous=True)
    lay = build_layout(blocks, rows, cols, shape)
    auto, thr = (build_patch_plan(lay, optimize=o)
                 for o in ("auto", "throughput"))
    a, t = auto.buckets[0], thr.buckets[0]
    assert (a.MP, a.KP) == (t.MP, t.KP) and a.G != t.G
    real = int((a.vals != 0).any(axis=(1, 2)).sum())
    assert real == int((t.vals != 0).any(axis=(1, 2)).sum())
    with pytest.raises(ValueError, match="optimize"):
        build_patch_plan(lay, optimize="fast")


def test_patch_plan_transpose_main_rectangular():
    """transpose_main on a plain rectangular operand: the plan of A^T."""
    blocks, rows, cols, shape = fixture("contiguous")
    blocks = [b.astype(np.float32) for b in blocks]
    mine = build_patch_plan(build_layout(blocks, rows, cols, shape),
                            transpose_main=True)
    ref = jax_build_patch_plan(
        jax_build_layout(blocks, rows, cols, shape, granularity="pow2"),
        transpose_main=True, optimize="auto")
    assert (mine.nrows, mine.ncols) == (shape[1], shape[0])
    assert_same_plan(mine, ref)


def test_patch_plan_rejects_f64_and_scattered():
    blocks, rows, cols, shape = fixture("contiguous")
    assert build_patch_plan(build_layout(blocks, rows, cols, shape)) is None
    blocks, rows, cols, shape = fixture("element-scattered")
    f32 = [b.astype(np.float32) for b in blocks]
    assert build_patch_plan(build_layout(f32, rows, cols, shape)) is None


@pytest.mark.parametrize("name,kwargs", [
    ("random_block_sparse", dict(shape=(200, 180), nblocks=9, max_block=30)),
    ("random_block_sparse", dict(shape=(200, 180), nblocks=9, max_block=30,
                                 contiguous=True, dtype=np.float32)),
    ("random_symmetric", dict(n=150, ngroups=6, noffdiag=7)),
    ("random_vbcrs", dict(shape=(160, 140), nrowgroups=5, ncolgroups=6)),
])
def test_testmatrices_same_arrays(name, kwargs):
    mine = getattr(tm, name)(13, **kwargs)
    ref = getattr(jax_tm, name)(13, **kwargs)

    def flat(v):
        if isinstance(v, (list, tuple)):
            out = []
            for e in v:
                out.extend(flat(e))
            return out
        return [np.asarray(v)]

    fm, fr = flat(mine), flat(ref)
    assert len(fm) == len(fr)
    for a, b in zip(fm, fr):
        assert_same_array(a, b, name)


def test_formats_take_tuple_granularity():
    """BSM, SBM and VBCRS pass ``granularity`` to their layouts as the JAX
    formats do."""
    import blocksparse_tpu as bst
    import blocksparse_tpu_torch as bt

    g = (8, 128)
    blocks, rows, cols, shape = fixture("contiguous")
    assert_same_layout(
        bt.BlockSparseMatrix(blocks, rows, cols, shape, granularity=g,
                             device="cpu").layout,
        bst.BlockSparseMatrix(blocks, rows, cols, shape, granularity=g).layout)
    d, di, o, ri, ci, shape = tm.random_symmetric(
        8, n=320, ngroups=6, noffdiag=8, dtype=np.float64, contiguous=True)
    P = bt.SymmetricBlockMatrix(d, di, o, ri, ci, shape, granularity=g,
                                device="cpu")
    J = bst.SymmetricBlockMatrix(d, di, o, ri, ci, shape, granularity=g)
    assert_same_layout(P._dlayout, J._dlayout)
    assert_same_layout(P._olayout, J._olayout)
    blocks, rs, cs, shape = tm.random_vbcrs(13, shape=(160, 140),
                                            nrowgroups=5, ncolgroups=6)
    assert_same_layout(
        bt.VariableBlockCompressedRowStorage(blocks, rs, cs, shape,
                                             granularity=g,
                                             device="cpu").layout,
        bst.VariableBlockCompressedRowStorage(blocks, rs, cs, shape,
                                              granularity=g).layout)
