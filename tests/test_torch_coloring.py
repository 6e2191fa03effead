"""The port's coloring and colored plan vs the JAX package's: byte-identical.

``blocksparse_tpu_torch.coloring`` re-implements DSATUR (sparse conflict
graph, heap of candidates); its assignments must equal the JAX package's
pure-Python path byte for byte, and the colored gather tables built from
them must equal the JAX planner's.  The colored plan's result depends on
the coloring: a broken coloring gives a wrong product.  Colored products
run the colored element route (``mask_select.colored_apply``: the products
pass, then the color rounds), held to the per-bucket chain of
``bucket_apply`` on the same plan.
"""

import numpy as np
import pytest
import torch

import blocksparse_tpu as bst
import blocksparse_tpu.coloring as jax_coloring
from blocksparse_tpu.core.layout import build_layout as jax_build_layout
from blocksparse_tpu.ops.colored import _plan_cached as jax_plan_tables
from blocksparse_tpu.ops.colored import colored_wins as jax_colored_wins

import blocksparse_tpu_torch as bt
from blocksparse_tpu_torch import coloring
from blocksparse_tpu_torch.core.layout import build_layout
from blocksparse_tpu_torch.ops.colored import (build_colored_plan,
                                               colored_wins, plan_tables)
from blocksparse_tpu_torch.ops.kernels import mask_select
from blocksparse_tpu_torch.ops.kernels.fused_spmm import BucketTable
from blocksparse_tpu_torch.ops.torch_spmv import bucket_apply
from blocksparse_tpu_torch.utils.testmatrices import (random_block_sparse,
                                                      random_symmetric)

torch.set_num_threads(2)

TOL = 1e-12


def index_lists(kind, seed):
    if kind == "rows":
        _, rows, _, _ = random_block_sparse(seed, shape=(400, 400), nblocks=60,
                                            max_block=40, dtype=np.float64)
        return rows
    _, _, _, ri, ci, _ = random_symmetric(seed, n=600, ngroups=24,
                                          noffdiag=60, dtype=np.float64)
    if kind == "cols":
        return ci
    return [np.concatenate([r, c]) for r, c in zip(ri, ci)]   # "union"


def same_groups(a, b):
    return len(a) == len(b) and all(
        np.asarray(x).dtype == np.asarray(y).dtype
        and np.asarray(x).tobytes() == np.asarray(y).tobytes()
        for x, y in zip(a, b))


@pytest.mark.parametrize("seed", [11, 12, 13])
@pytest.mark.parametrize("kind", ["rows", "cols", "union"])
def test_coloring_byte_identical(kind, seed):
    lists = index_lists(kind, seed)
    assert coloring.conflict_adjacency(lists) == jax_coloring.conflict_adjacency(lists)
    mine = coloring.dsatur_color(coloring.conflict_adjacency(lists))
    ref = jax_coloring.dsatur_color(jax_coloring.conflict_adjacency(lists))
    assert mine.dtype == ref.dtype and mine.tobytes() == ref.tobytes()
    groups = coloring.color_blocks(lists)
    assert same_groups(groups, jax_coloring.color_blocks(lists, use_native=False))
    assert coloring.validate_coloring(lists, groups)
    assert jax_coloring.validate_coloring(lists, groups)


def test_validate_coloring_agrees():
    lists = index_lists("rows", 14)
    good = coloring.color_blocks(lists)
    merged = (np.concatenate(good[:2]),) + good[2:]   # conflicts within a color
    dropped = good[1:]                                # not a partition
    twice = good + (good[0][:1],)                     # a block in two colors
    for groups in (good, merged, dropped, twice):
        assert coloring.validate_coloring(lists, groups) == \
            jax_coloring.validate_coloring(lists, groups)
    assert not coloring.validate_coloring(lists, merged)


@pytest.mark.parametrize("lists,ncolors", [
    ([np.array([0, 1]), np.array([1, 2]), np.array([3, 4])], 2),
    ([np.array([0, 1]), np.array([2, 3]), np.array([4])], 1),
    ([], 0),
])
def test_small_colorings(lists, ncolors):
    groups = coloring.color_blocks(lists)
    assert len(groups) == ncolors
    assert same_groups(groups, jax_coloring.color_blocks(lists, use_native=False))
    info = coloring.ColorInfo(tuple(lists))
    assert info.nblocks == len(lists)
    assert info.max_index == jax_coloring.ColorInfo(tuple(lists)).max_index


def scattered_fixture(rng, n=300, nb=40):
    blocks, rows, cols = [], [], []
    for _ in range(nb):
        m, k = int(rng.integers(3, 20)), int(rng.integers(3, 20))
        blocks.append(rng.standard_normal((m, k)))
        rows.append(np.sort(rng.choice(n, m, replace=False)))
        cols.append(np.sort(rng.choice(n, k, replace=False)))
    return blocks, rows, cols, (n, n)


def element_ids(layout):
    return tuple(i for i, b in enumerate(layout.buckets) if b.chunk == 1)


def assert_same_tables(mine, ref):
    assert (mine is None) == (ref is None)
    if mine is None:
        return
    assert mine[1] == ref[1]
    assert same_groups(mine[0], ref[0])


@pytest.mark.parametrize("transpose", [False, True])
def test_colored_plan_tables_match_jax(transpose):
    blocks, rows, cols, shape = scattered_fixture(np.random.default_rng(0))
    mine_l = build_layout(blocks, rows, cols, shape)
    ref_l = jax_build_layout(blocks, rows, cols, shape, granularity="pow2")
    lists = cols if transpose else rows
    colors = tuple(tuple(int(b) for b in g) for g in coloring.color_blocks(lists))
    sel = element_ids(mine_l)
    assert sel == element_ids(ref_l) and sel
    mine = plan_tables(mine_l, colors, shape[0], transpose, sel, False)
    assert_same_tables(mine, jax_plan_tables(ref_l, colors, shape[0],
                                             transpose, sel, False))
    # an incomplete coloring gives no plan in both
    assert plan_tables(mine_l, colors[1:], shape[0], transpose, sel, False) is None
    assert jax_plan_tables(ref_l, colors[1:], shape[0], transpose, sel,
                           False) is None


def test_symmetric_colored_plan_tables_match_jax():
    _, _, o, ri, ci, shape = random_symmetric(3, n=256, ngroups=10,
                                              noffdiag=14, dtype=np.float64)
    mine_l = build_layout(o, ri, ci, shape)
    ref_l = jax_build_layout(o, ri, ci, shape, granularity="pow2")
    P = bt.SymmetricBlockMatrix(*random_symmetric(3, n=256, ngroups=10,
                                                  noffdiag=14,
                                                  dtype=np.float64),
                                                  device="cpu")
    sel = element_ids(mine_l)
    mine = plan_tables(mine_l, P.fusedcolors(), shape[0], False, sel, True)
    assert mine is not None
    assert_same_tables(mine, jax_plan_tables(ref_l, P.fusedcolors(), shape[0],
                                             False, sel, True))


@pytest.mark.parametrize("args", [(3, 100, 200), (40, 300, 5000), (1, 0, 0),
                                  (9, 1000, 6000)])
def test_colored_wins_matches_jax(args):
    assert colored_wins(*args) == jax_colored_wins(*args)


def colored_product(layout, dev_buckets, colors, out_len, x, transpose=False,
                    symmetric=False):
    sel = element_ids(layout)
    assert len(sel) == len(layout.buckets)   # the plan covers every block
    plan = build_colored_plan(layout, tuple(colors), out_len, transpose,
                              sel, symmetric=symmetric, device=x.device)
    assert plan is not None
    table = BucketTable([(v, ri, ci, 1)
                         for i, (v, ri, ci, _, _) in enumerate(dev_buckets)
                         if i in sel])
    # the colored element route (B9's products pass and colored rounds),
    # held to the JAX engine's per-bucket chain on the same plan
    got = mask_select.colored_apply(
        table, plan, x, out=x.new_zeros((out_len,) + x.shape[1:]),
        transpose=transpose, symmetric=symmetric)
    chain = bucket_apply([b[:3] for b in table.buckets], out_len, x,
                         transpose=transpose, symmetric=symmetric,
                         colored_plan=plan)
    assert torch.allclose(got, chain, rtol=0, atol=1e-13)
    return got


def test_broken_coloring_detected():
    """Two blocks sharing output rows forced into one color overwrite each
    other's table slots: the colored plan's product goes wrong."""
    rng = np.random.default_rng(3)
    n = 120
    blocks = [rng.standard_normal((8, 8)), rng.standard_normal((8, 8))]
    rows = [np.array([10, 12, 14, 16, 18, 20, 22, 24]),
            np.array([14, 16, 21, 30, 41, 52, 63, 74])]  # overlap 14, 16
    cols = [np.array([0, 3, 5, 7, 9, 11, 13, 15]),
            np.array([30, 33, 35, 37, 39, 41, 43, 45])]
    P = bt.BlockSparseMatrix(blocks, rows, cols, (n, n), schedule="colored",
                             device="cpu")
    A = bst.BlockSparseMatrix(blocks, rows, cols, (n, n), schedule="colored",
                              backend="xla")
    assert P.colors() == A.colors() and len(P.colors()) >= 2
    S = bt.to_scipy(P)
    x = rng.standard_normal(n)
    good = colored_product(P.layout, P._buckets, P.colors(), n,
                           torch.from_numpy(x))
    assert np.abs(good.numpy() - S @ x).max() < TOL
    bad = colored_product(P.layout, P._buckets, ((0, 1),), n,
                          torch.from_numpy(x))
    assert np.abs(bad.numpy() - S @ x).max() > 1e-3


def test_colored_schedule_vs_serial_bsm():
    """BlockSparseMatrix(schedule="colored"): colors from DSATUR equal to the
    JAX package's, products equal to the serial schedule's and to the
    colored plan run directly."""
    rng = np.random.default_rng(1)
    blocks, rows, cols, shape = scattered_fixture(rng)
    P_col = bt.BlockSparseMatrix(blocks, rows, cols, shape, schedule="colored",
                                 device="cpu")
    P_ser = bt.BlockSparseMatrix(blocks, rows, cols, shape, device="cpu")
    A_col = bst.BlockSparseMatrix(blocks, rows, cols, shape,
                                  schedule="colored", backend="xla")
    assert P_col.schedule == bt.COLORED
    assert P_col.colors() == A_col.colors()
    assert P_col.transposecolors() == A_col.transposecolors()
    assert bt.colors(P_col.T) == P_col.transposecolors()
    S = bt.to_scipy(P_ser)
    x = rng.standard_normal(shape[1])
    X = rng.standard_normal((shape[1], 3))
    t = torch.from_numpy
    for op, ref in ((lambda A: A @ t(x), S @ x), (lambda A: A.T @ t(x), S.T @ x),
                    (lambda A: A @ t(X), S @ X)):
        assert np.abs(op(P_col).numpy() - op(P_ser).numpy()).max() < TOL
        assert np.abs(op(P_col).numpy() - ref).max() < TOL
    for tr, colors in ((False, P_col.colors()), (True, P_col.transposecolors())):
        got = colored_product(P_col.layout, P_col._buckets, colors, shape[0],
                              t(X), transpose=tr)
        assert np.abs(got.numpy() - (S.T @ X if tr else S @ X)).max() < TOL


def test_symmetric_fused_colors_plan():
    """The one-read symmetric pass as gather rounds over fusedcolors."""
    d, di, o, ri, ci, shape = random_symmetric(3, n=256, ngroups=10,
                                               noffdiag=14, dtype=np.float64)
    P = bt.SymmetricBlockMatrix(d, di, o, ri, ci, shape, device="cpu")
    off = bt.BlockSparseMatrix(o, ri, ci, shape, device="cpu")
    S = bt.to_scipy(off)
    x = np.random.default_rng(2).standard_normal(shape[0])
    got = colored_product(P._olayout, P._obuckets, P.fusedcolors(), shape[0],
                          torch.from_numpy(x), symmetric=True)
    assert np.abs(got.numpy() - (S @ x + S.T @ x)).max() < TOL
