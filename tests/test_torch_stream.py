"""The port's stream route on the CPU: planners, route decision, kernels B5/B8.

The port carries numpy copies of the JAX package's panel and slab planners
(``core/panel.py``, ``core/strip.py``).  Here their fields are held equal to
the originals' on the fixtures of ``tests/test_panel.py`` and
``tests/test_strip.py`` (the port's map-back table ``otgt`` checked against
the JAX one-hot ``omap``), the port's ``stream_plan_choice`` is held to the
JAX decision, and the plain versions of kernels B5 and B8 are held against
the JAX Pallas kernels in interpret mode (f32, 1e-5 relative to
max(1, max|ref|)) and against float64 scipy (3e-5, as ``test_panel.py``).
Through the formats, f32 r = 1 products take the stream route exactly where
the JAX decision says, and gradients through it equal A^T w.  The CUDA
kernels themselves run only on a card (``chip_smoke.py`` phase 1).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import blocksparse_tpu as bst
from blocksparse_tpu.core import panel as jpanel
from blocksparse_tpu.core import strip as jstrip
from blocksparse_tpu.core.layout import build_layout as jax_build_layout
from blocksparse_tpu.ops.dispatch import stream_plan_choice as jax_choice
from blocksparse_tpu.ops.pallas import panel_spmv as jpanel_k
from blocksparse_tpu.ops.pallas import slab_spmv as jslab_k
from blocksparse_tpu.utils import testmatrices as jtm

import blocksparse_tpu_torch as bt
from blocksparse_tpu_torch.core import panel, strip
from blocksparse_tpu_torch.core.layout import build_layout
from blocksparse_tpu_torch.ops import panel_router
from blocksparse_tpu_torch.ops.dispatch import stream_plan_choice
from blocksparse_tpu_torch.ops.kernels import panel_spmv, slab_spmv

torch.set_num_threads(2)

TOL32, TOL_SCIPY = 1e-5, 3e-5


def relerr(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b))) / max(1.0, float(np.max(np.abs(b))))


# -- fixtures: (kind, blocks, rows, cols, shape) as numpy f32 ---------------

def _contig(seed, m=640, n=640, nblocks=25):
    """test_strip.py::_random_contig."""
    rng = np.random.default_rng(seed)
    blocks, rows, cols = [], [], []
    for _ in range(nblocks):
        h, w = int(rng.integers(1, 150)), int(rng.integers(1, 150))
        r0, c0 = int(rng.integers(0, m - h)), int(rng.integers(0, n - w))
        blocks.append(rng.standard_normal((h, w)).astype(np.float32))
        rows.append(np.arange(r0, r0 + h))
        cols.append(np.arange(c0, c0 + w))
    return blocks, rows, cols, (m, n)


def _scattered_columns():
    rng = np.random.default_rng(3)
    blocks, rows, cols = [], [], []
    for i in range(12):
        c0 = int(rng.integers(0, 800 - 64))
        blocks.append(rng.standard_normal((48, 48)).astype(np.float32))
        rows.append(np.arange(64 * i, 64 * i + 48))
        cols.append(c0 + np.sort(rng.choice(64, 48, replace=False)))
    return blocks, rows, cols, (800, 800)


def _local_rows():
    rng = np.random.default_rng(5)
    n = 2048
    blocks, rows, cols = [], [], []
    for _ in range(10):
        r0 = int(rng.integers(0, n - 90))
        rows.append(r0 + np.sort(rng.choice(90, 64, replace=False)))
        cols.append(np.sort(rng.choice(n, 64, replace=False)))
        blocks.append(rng.standard_normal((64, 64)).astype(np.float32))
    return blocks, rows, cols, (n, n)


def _pathological_rows():
    rng = np.random.default_rng(6)
    n = 4096
    rows = [np.sort(rng.choice(n, 40, replace=False))]
    cols = [np.sort(rng.choice(n, 40, replace=False))]
    return ([rng.standard_normal((40, 40)).astype(np.float32)], rows, cols,
            (n, n))


def _shifted():
    """test_panel.py::test_shift_variant_choice_and_compaction."""
    rng = np.random.default_rng(21)
    n = 1024
    blocks = [rng.standard_normal((48, 60)).astype(np.float32)
              for _ in range(10)]
    rows = [np.arange(r, r + 48) for r in rng.integers(0, n - 48, 10)]
    cols = [np.arange(c, c + 60) for c in rng.integers(0, n - 60, 10)]
    return blocks, rows, cols, (n, n)


def _wrap():
    """The last segment of a shifted grid runs past ncols = 1010: columns
    980..1009 take grid 20's segment 30, whose lanes 30 and 31 index 1010 and
    1011 (the JAX gather reads its zero padding there)."""
    rng = np.random.default_rng(23)
    blocks = [rng.standard_normal((40, 30)).astype(np.float32),
              rng.standard_normal((24, 100)).astype(np.float32)]
    return (blocks, [np.arange(0, 40), np.arange(40, 64)],
            [np.arange(980, 1010), np.arange(300, 400)], (64, 1010))


def _strided(seed=3, n=1024, nb=100):
    """Aligned 64x128 blocks plus one block with rows at stride 4: the panel
    planner refuses the strided rows, the slab plan takes them and beats
    the bucket engines (the JAX decision is "strip")."""
    rng = np.random.default_rng(seed)
    blocks, rows, cols = [], [], []
    for _ in range(nb):
        r0 = int(rng.integers(0, n // 64)) * 64
        c0 = int(rng.integers(0, n // 128)) * 128
        blocks.append(rng.standard_normal((64, 128)).astype(np.float32))
        rows.append(np.arange(r0, r0 + 64))
        cols.append(np.arange(c0, c0 + 128))
    r0, c0 = int(rng.integers(0, n - 256)), int(rng.integers(0, n // 128)) * 128
    blocks.append(rng.standard_normal((64, 128)).astype(np.float32))
    rows.append(r0 + 4 * np.arange(64))
    cols.append(np.arange(c0, c0 + 128))
    return blocks, rows, cols, (n, n)


def _vbcrs(seed):
    blocks, rs, cs, shape = jtm.random_vbcrs(seed, dtype=np.float32)
    return (blocks, [np.arange(r, r + b.shape[0]) for r, b in zip(rs, blocks)],
            [np.arange(c, c + b.shape[1]) for c, b in zip(cs, blocks)], shape)


GENERAL = {
    "contiguous": lambda: jtm.random_block_sparse(
        11, shape=(600, 600), nblocks=30, max_block=60, dtype=np.float32,
        contiguous=True),
    "strip contiguous": lambda: _contig(0),
    "rectangular": lambda: _contig(2, m=512, n=768),
    "scattered columns": _scattered_columns,
    "local rows": _local_rows,
    "pathological rows": _pathological_rows,
    "scattered strip": lambda: jtm.random_block_sparse(
        11, shape=(300, 300), nblocks=3, max_block=40, dtype=np.float32),
    "shifted": _shifted,
    "wrap": _wrap,
    "strided": _strided,
    "vbcrs 15": lambda: _vbcrs(15),
    "vbcrs 16": lambda: _vbcrs(16),
}

SYMMETRIC = {
    "fused": lambda: jtm.random_symmetric(13, n=700, ngroups=14, noffdiag=26,
                                          dtype=np.float32, contiguous=True),
    "strip unified": lambda: jtm.random_symmetric(
        5, n=900, ngroups=14, noffdiag=30, dtype=np.float32, contiguous=True),
    "diagonal only": lambda: jtm.random_symmetric(
        14, n=300, ngroups=6, noffdiag=0, dtype=np.float32, contiguous=True),
    "overlapping mirror": lambda: _overlapping_mirror(),
}


def _overlapping_mirror():
    rng = np.random.default_rng(8)
    return ([rng.standard_normal((32, 32)).astype(np.float32)],
            [np.arange(0, 32)],
            [rng.standard_normal((32, 40)).astype(np.float32),
             rng.standard_normal((32, 40)).astype(np.float32)],
            [np.arange(0, 32), np.arange(0, 32)],
            [np.arange(64, 104), np.arange(80, 120)], (256, 256))


@functools.lru_cache(maxsize=None)
def general(kind):
    """(jax layout, port layout, scipy) of a general fixture."""
    blocks, rows, cols, shape = GENERAL[kind]()
    jl = jax_build_layout(blocks, rows, cols, shape, granularity="pow2")
    J = bst.BlockSparseMatrix([b.astype(np.float64) for b in blocks], rows,
                              cols, shape, backend="xla")
    return jl, build_layout(blocks, rows, cols, shape), bst.to_scipy(J)


@functools.lru_cache(maxsize=None)
def symmetric(kind):
    d, di, o, ri, ci, shape = SYMMETRIC[kind]()
    J = bst.SymmetricBlockMatrix([b.astype(np.float64) for b in d], di,
                                 [b.astype(np.float64) for b in o], ri, ci,
                                 shape, backend="xla")
    return ((jax_build_layout(d, di, di, shape, granularity="pow2"),
             jax_build_layout(o, ri, ci, shape, granularity="pow2")),
            (build_layout(d, di, di, shape), build_layout(o, ri, ci, shape)),
            bst.to_scipy(J))


# -- planners: every field equal --------------------------------------------

def assert_same_strip(mine, ref):
    if ref is None:
        assert mine is None
        return
    for f in ("nrows", "ncols", "S", "TS", "NC", "n8p", "mirror", "nt"):
        assert getattr(mine, f) == getattr(ref, f), f
    for f in ("vals", "rs", "cs", "flag", "b8"):
        a, b = getattr(mine, f), getattr(ref, f)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    assert (mine.tile_bytes, mine.aux_bytes) == (ref.tile_bytes,
                                                 ref.aux_bytes)


def omap_of(plan):
    """The JAX package's one-hot map-back, rebuilt from ``otgt``."""
    om = np.zeros((plan.S * plan.CW * panel.NSEG,
                   len(plan.grids_used) * plan.NC32), np.float32)
    s, j = np.nonzero(plan.otgt >= 0)
    om[s * plan.CW * panel.NSEG + j, plan.otgt[s, j]] = 1.0
    return om


def assert_same_panel(mine, ref):
    if ref is None:
        assert mine is None
        return
    for f in ("nrows", "ncols", "S", "TS", "CW", "RW", "n8p", "NC32",
              "mirror", "nt", "grids_used"):
        assert getattr(mine, f) == getattr(ref, f), f
    for f in ("vals", "rid8", "cid8", "segid", "b8"):
        a, b = getattr(mine, f), getattr(ref, f)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    assert (mine.otgt is None) == (ref.omap is None)
    if ref.omap is not None:
        assert np.array_equal(omap_of(mine), ref.omap)
    assert (mine.tile_bytes, mine.aux_bytes) == (ref.tile_bytes,
                                                 ref.aux_bytes)


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("kind", list(GENERAL))
def test_general_plans_equal_jax(kind, transpose):
    jl, pl, _ = general(kind)
    assert_same_panel(panel.panel_plan_from_layout(pl, transpose=transpose),
                      jpanel.panel_plan_from_layout(jl, transpose=transpose))
    assert_same_strip(strip.plan_from_layout(pl, transpose=transpose),
                      jstrip.plan_from_layout(jl, transpose=transpose))


@pytest.mark.parametrize("transpose_diag", [False, True])
@pytest.mark.parametrize("kind", list(SYMMETRIC))
def test_symmetric_plans_equal_jax(kind, transpose_diag):
    (jd, jo), (pd, po), _ = symmetric(kind)
    assert_same_panel(
        panel.panel_plan_symmetric(pd, po, transpose_diag=transpose_diag),
        jpanel.panel_plan_symmetric(jd, jo, transpose_diag=transpose_diag))
    assert_same_strip(
        strip.plan_symmetric(pd, po, transpose_diag=transpose_diag),
        jstrip.plan_symmetric(jd, jo, transpose_diag=transpose_diag))


def fused_entries(mod, dl, ol):
    return (mod._layout_entries(dl, transpose=False)
            + [(b, r, c, True) for b, r, c, _ in
               mod._layout_entries(ol, transpose=False)])


@pytest.mark.parametrize("kind", ["fused", "overlapping mirror"])
def test_fused_mirror_plan_equals_jax(kind):
    """The fused (mirror) panel plan built directly, shifted grids and all:
    ``otgt`` is the JAX one-hot ``omap`` row for row."""
    (jd, jo), (pd, po), _ = symmetric(kind)
    shape = (pd.nrows, pd.ncols)
    mine = panel.build_panel_plan(fused_entries(panel, pd, po), shape,
                                  mirror=True)
    ref = jpanel.build_panel_plan(fused_entries(jpanel, jd, jo), shape,
                                  mirror=True)
    assert mine.mirror and ref.mirror
    assert_same_panel(mine, ref)
    if kind == "fused":
        assert len(mine.grids_used) > 1   # mirror segments on shifted grids


@pytest.mark.parametrize("allow_shift", [False, True])
def test_shift_variants_equal_jax(allow_shift):
    jl, pl, _ = general("shifted")
    shape = (pl.nrows, pl.ncols)
    mine = panel.build_panel_plan(panel._layout_entries(pl, transpose=False),
                                  shape, allow_shift=allow_shift)
    ref = jpanel.build_panel_plan(jpanel._layout_entries(jl, transpose=False),
                                  shape, allow_shift=allow_shift)
    assert_same_panel(mine, ref)
    assert (len(mine.grids_used) == 1) == (not allow_shift)


def test_small_window_strip_plan_equals_jax():
    blocks, rows, cols, shape = _contig(16, m=200, n=200, nblocks=5)
    entries = [(b, int(r[0]), int(c[0]), 0.0)
               for b, r, c in zip(blocks, rows, cols)]
    assert_same_strip(strip.build_strip_plan(entries, shape, mirror=False),
                      jstrip.build_strip_plan(entries, shape, mirror=False))


def test_ineligible_plans():
    _, pl, _ = general("pathological rows")
    assert panel.panel_plan_from_layout(pl) is None
    _, pl, _ = general("scattered strip")
    assert strip.plan_from_layout(pl) is None
    _, pl, _ = general("strided")
    assert panel.panel_plan_from_layout(pl) is None
    assert strip.plan_from_layout(pl) is not None
    blocks, rows, cols, shape = GENERAL["contiguous"]()
    f64 = build_layout([b.astype(np.float64) for b in blocks], rows, cols,
                       shape)
    assert panel.panel_plan_from_layout(f64) is None
    assert strip.plan_from_layout(f64) is None


# -- the route decision -----------------------------------------------------

@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("kind", list(GENERAL))
def test_route_decision_equals_jax_general(kind, transpose):
    jl, pl, _ = general(kind)
    jp = jpanel.panel_plan_from_layout(jl, transpose=transpose)
    js = jstrip.plan_from_layout(jl, transpose=transpose)
    want = jax_choice(None if jp is None else (jp, None),
                      None if js is None else (js, None), [(jl, 1)])
    got = stream_plan_choice(
        panel.panel_plan_from_layout(pl, transpose=transpose),
        strip.plan_from_layout(pl, transpose=transpose), [(pl, 1)])
    assert got == want
    if kind == "strided" and not transpose:
        assert got == "strip"


@pytest.mark.parametrize("kind", list(SYMMETRIC))
def test_route_decision_equals_jax_symmetric(kind):
    """The route decision on the plan the port's route builds (the H100
    rule's pick, ``ops/panel_router.py``) equals the JAX decision on the
    JAX rule's plan, the port's plan charged as the format charges it
    (``route_bytes``): on these fixtures the two plans route alike."""
    (jd, jo), (pd, po), _ = symmetric(kind)
    jp = jpanel.panel_plan_symmetric(jd, jo)
    js = jstrip.plan_symmetric(jd, jo)
    want = jax_choice(None if jp is None else (jp, None),
                      None if js is None else (js, None), [(jd, 1), (jo, 2)])
    plan = panel_router.panel_plan_sym(pd, po, transpose_diag=False)
    got = stream_plan_choice(plan, strip.plan_symmetric(pd, po),
                             [(pd, 1), (po, 2)],
                             panel_bytes=panel_router.route_bytes(plan))
    assert got == want


def flagship_bsm():
    """The flagship recipe: 4096^2, 200 contiguous 64x64 f32 blocks, seed 7."""
    rng = np.random.default_rng(7)
    pos = rng.choice(64 * 64, size=200, replace=False)
    rows = [np.arange(p // 64 * 64, p // 64 * 64 + 64) for p in pos]
    cols = [np.arange(p % 64 * 64, p % 64 * 64 + 64) for p in pos]
    blocks = [rng.standard_normal((64, 64)).astype(np.float32)
              for _ in pos]
    return blocks, rows, cols, (4096, 4096)


def config3(n=4096, seed=9):
    """bench.py::build_config3's blocks: (blocks, row starts, col starts)."""
    rng = np.random.default_rng(seed)
    vrng = np.random.default_rng(seed + 7777)
    bounds = [0]
    while bounds[-1] < n:
        bounds.append(min(n, bounds[-1] + int(rng.integers(16, 129))))
    groups = [np.arange(bounds[i], bounds[i + 1])
              for i in range(len(bounds) - 1)]
    blocks, rs, cs = [], [], []
    for gi in range(len(groups)):
        for gj in rng.choice(len(groups), size=min(6, len(groups)),
                             replace=False):
            blocks.append(vrng.standard_normal(
                (len(groups[gi]), len(groups[int(gj)]))).astype(np.float32))
            rs.append(int(groups[gi][0]))
            cs.append(int(groups[int(gj)][0]))
    return blocks, rs, cs, (n, n)


def test_recipe_decisions_equal_jax():
    """Flagship -> bucket route, config 3 (n = 4096) -> panel, config 2 ->
    the fused (mirror) panel plan, in both packages."""
    blocks, rows, cols, shape = flagship_bsm()
    J = bst.BlockSparseMatrix(blocks, rows, cols, shape, backend="xla")
    P = bt.BlockSparseMatrix(blocks, rows, cols, shape, device="cpu")
    jl = J.layout
    jp, js = jpanel.panel_plan_from_layout(jl), jstrip.plan_from_layout(jl)
    assert jax_choice((jp, None), (js, None), [(jl, 1)]) is None
    assert P._stream_entry(False)[0] is None

    blocks, rs, cs, shape = config3()
    J = bst.VariableBlockCompressedRowStorage(blocks, rs, cs, shape,
                                              granularity=(8, 128))
    V = bt.VariableBlockCompressedRowStorage(blocks, rs, cs, shape,
                                             granularity=(8, 128),
                                             device="cpu")
    jl = J.layout
    jp, js = jpanel.panel_plan_from_layout(jl), jstrip.plan_from_layout(jl)
    assert jax_choice((jp, None), (js, None), [(jl, 1)]) == "panel"
    assert V._stream_entry(False)[0] == "panel"
    assert_same_panel(V._panel_for(False), jp)

    args = jtm.random_symmetric(8, n=4096, ngroups=48, noffdiag=160,
                                dtype=np.float32, contiguous=True)
    J = bst.SymmetricBlockMatrix(*args, backend="xla")
    S = bt.SymmetricBlockMatrix(*args, device="cpu")
    jp = jpanel.panel_plan_symmetric(J._dlayout, J._olayout)
    js = jstrip.plan_symmetric(J._dlayout, J._olayout)
    assert jax_choice((jp, None), (js, None),
                      [(J._dlayout, 1), (J._olayout, 2)]) == "panel"
    choice, plan, _ = S._stream_entry(False)
    assert choice == "panel" and plan.mirror and jp.mirror
    assert_same_panel(plan, jp)


# -- plain versions vs the JAX kernels in interpret mode --------------------

def _x(n, seed):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def check_panel(plan, jplan, oracle, seed):
    x = _x(plan.ncols, seed)
    ref = np.asarray(jpanel_k.panel_apply(
        jplan, jpanel_k.panel_device_arrays(jplan), jnp.asarray(x),
        interpret=True))
    got = panel_spmv.panel_apply_plain(
        plan, panel_spmv.panel_device_arrays(plan, "cpu"), torch.from_numpy(x))
    assert got.dtype == torch.float32
    assert relerr(got, ref) <= TOL32
    assert relerr(got, oracle @ x.astype(np.float64)) <= TOL_SCIPY


def check_slab(plan, jplan, oracle, seed):
    x = _x(plan.ncols, seed)
    ref = np.asarray(jslab_k.slab_apply(
        jplan, jslab_k.plan_device_arrays(jplan), jnp.asarray(x),
        interpret=True))
    got = slab_spmv.slab_apply_plain(
        plan, slab_spmv.plan_device_arrays(plan, "cpu"), torch.from_numpy(x))
    assert relerr(got, ref) <= TOL32
    assert relerr(got, oracle @ x.astype(np.float64)) <= TOL_SCIPY


@pytest.mark.parametrize("kind,transpose", [
    ("contiguous", False), ("contiguous", True), ("scattered columns", False),
    ("local rows", False), ("vbcrs 15", False)])
def test_b5_plain_vs_jax_interpret(kind, transpose):
    jl, pl, S = general(kind)
    check_panel(panel.panel_plan_from_layout(pl, transpose=transpose),
                jpanel.panel_plan_from_layout(jl, transpose=transpose),
                S.T if transpose else S, 31)


@pytest.mark.parametrize("kind", ["shifted", "wrap"])
def test_b5_plain_shifted_grids_vs_jax_interpret(kind):
    """Shifted segment grids; "wrap": the last segment's lanes run past
    ncols, where the JAX gather reads padding and the port reads 0."""
    jl, pl, S = general(kind)
    shape = (pl.nrows, pl.ncols)
    plan = panel.build_panel_plan(panel._layout_entries(pl, transpose=False),
                                  shape)
    jplan = jpanel.build_panel_plan(
        jpanel._layout_entries(jl, transpose=False), shape)
    assert plan.grids_used != (0,)
    if kind == "wrap":
        idx = panel_spmv._lane_index(plan, torch.from_numpy(plan.segid),
                                     1 << 30)
        assert int(idx[idx < 1 << 30].max()) >= plan.ncols
    check_panel(plan, jplan, S, 32)


@pytest.mark.parametrize("kind", ["fused", "overlapping mirror"])
def test_b5_plain_mirror_vs_jax_interpret(kind):
    (jd, jo), (pd, po), S = symmetric(kind)
    shape = (pd.nrows, pd.ncols)
    plan = panel.build_panel_plan(fused_entries(panel, pd, po), shape,
                                  mirror=True)
    jplan = jpanel.build_panel_plan(fused_entries(jpanel, jd, jo), shape,
                                    mirror=True)
    check_panel(plan, jplan, S, 33)


def test_b5_plain_symmetric_transpose_vs_jax_interpret():
    (jd, jo), (pd, po), S = symmetric("fused")
    check_panel(panel.panel_plan_symmetric(pd, po, transpose_diag=True),
                jpanel.panel_plan_symmetric(jd, jo, transpose_diag=True),
                S.T, 34)


@pytest.mark.parametrize("kind,transpose", [
    ("strip contiguous", False), ("rectangular", True)])
def test_b8_plain_vs_jax_interpret(kind, transpose):
    jl, pl, S = general(kind)
    check_slab(strip.plan_from_layout(pl, transpose=transpose),
               jstrip.plan_from_layout(jl, transpose=transpose),
               S.T if transpose else S, 35)


@pytest.mark.parametrize("transpose_diag", [False, True])
def test_b8_plain_mirror_vs_jax_interpret(transpose_diag):
    (jd, jo), (pd, po), S = symmetric("strip unified")
    check_slab(strip.plan_symmetric(pd, po, transpose_diag=transpose_diag),
               jstrip.plan_symmetric(jd, jo, transpose_diag=transpose_diag),
               S.T if transpose_diag else S, 36)


def test_b8_plain_small_window_vs_jax_interpret():
    blocks, rows, cols, shape = _contig(16, m=200, n=200, nblocks=5)
    entries = [(b, int(r[0]), int(c[0]), 0.0)
               for b, r, c in zip(blocks, rows, cols)]
    S = bst.to_scipy(bst.BlockSparseMatrix(
        [b.astype(np.float64) for b in blocks], rows, cols, shape))
    check_slab(strip.build_strip_plan(entries, shape, mirror=False),
               jstrip.build_strip_plan(entries, shape, mirror=False), S, 37)


def test_b8_plain_strided_vs_scipy():
    _, pl, S = general("strided")
    plan = strip.plan_from_layout(pl)
    x = _x(plan.ncols, 38)
    got = slab_spmv.slab_apply_plain(
        plan, slab_spmv.plan_device_arrays(plan, "cpu"), torch.from_numpy(x))
    assert relerr(got, S @ x.astype(np.float64)) <= TOL_SCIPY


def test_wrappers_take_plain_on_cpu_and_count_no_launch():
    jl, pl, _ = general("contiguous")
    plan = panel.panel_plan_from_layout(pl)
    dev = panel_spmv.panel_device_arrays(plan, "cpu")
    x = torch.from_numpy(_x(plan.ncols, 39))
    before = (panel_spmv.LAUNCHES, slab_spmv.LAUNCHES)
    assert torch.equal(panel_spmv.panel_spmv(plan, dev, x),
                       panel_spmv.panel_apply_plain(plan, dev, x))
    splan = strip.plan_from_layout(pl)
    sdev = slab_spmv.plan_device_arrays(splan, "cpu")
    assert torch.equal(slab_spmv.slab_spmv(splan, sdev, x),
                       slab_spmv.slab_apply_plain(splan, sdev, x))
    assert (panel_spmv.LAUNCHES, slab_spmv.LAUNCHES) == before
    with pytest.raises(ValueError, match="shape"):
        panel_spmv.panel_spmv(plan, dev, x[:-1])
    with pytest.raises(ValueError, match="shape"):
        slab_spmv.slab_spmv(splan, sdev, x[:-1])


def test_slab_staging_ids_match_one_hots():
    (_, _), (pd, po), _ = symmetric("strip unified")
    plan = strip.plan_symmetric(pd, po)
    vals, rid8, cid, flag, b8 = slab_spmv.plan_device_arrays(plan, "cpu")
    S, TS = plan.S, plan.TS
    rid8, cid = rid8.view(S, TS).numpy(), cid.view(S, TS).numpy()
    live = rid8 < strip.RW
    assert live.sum() == plan.nt
    s, t = np.nonzero(live)
    assert (plan.rs[s, rid8[s, t], t] == 1).all()
    assert (plan.cs[s, t, cid[s, t]] == 1).all()
    assert not plan.rs[~live[:, None, :].repeat(strip.RW, 1)].any()


@pytest.mark.parametrize("which", ["panel", "slab"])
def test_autograd_matches_transpose(which):
    """dx of the stream products = A^T g, dvals from the plain autograd."""
    jl, pl, S = general("contiguous" if which == "panel" else "strided")
    if which == "panel":
        plan = panel.panel_plan_from_layout(pl)
        dev = panel_spmv.panel_device_arrays(plan, "cpu")
        apply = panel_spmv.panel_apply
    else:
        plan = strip.plan_from_layout(pl)
        dev = slab_spmv.plan_device_arrays(plan, "cpu")
        apply = slab_spmv.slab_apply
    x = torch.from_numpy(_x(plan.ncols, 40)).requires_grad_()
    w = _x(plan.nrows, 41)
    vals = dev[0].clone().requires_grad_()
    (torch.from_numpy(w) * apply(plan, (vals,) + dev[1:], x)).sum().backward()
    assert relerr(x.grad, S.T @ w.astype(np.float64)) <= TOL_SCIPY
    assert vals.grad is not None and vals.grad.shape == vals.shape


def test_panel_autograd_gradcheck_f64():
    """The Function on a tiny mirror plan, in float64 through the plain
    version (values and x both differentiated)."""
    (_, _), (pd, po), _ = symmetric("overlapping mirror")
    plan = panel.build_panel_plan(fused_entries(panel, pd, po), (256, 256),
                                  mirror=True)
    dev = panel_spmv.panel_device_arrays(plan, "cpu")
    x = torch.from_numpy(_x(256, 42).astype(np.float64)).requires_grad_()
    vals = dev[0].double().requires_grad_()
    rest = tuple(dev[1:])

    def fn(v, xx):
        return panel_spmv.panel_apply(plan, (v,) + rest, xx)
    assert torch.autograd.gradcheck(fn, (vals, x), eps=1e-6, atol=1e-7,
                                    fast_mode=True)


# -- the route through the formats -----------------------------------------

def spy(module, name, store):
    orig = getattr(module, name)

    def wrapped(*a, **k):
        store.append(name)
        return orig(*a, **k)
    setattr(module, name, wrapped)
    return orig


def routed(apply):
    """(result, names of the plain versions that ran)."""
    ran = []
    origs = {(m, n): spy(m, n, ran) for m, n in (
        (panel_spmv, "panel_apply_plain"), (slab_spmv, "slab_apply_plain"))}
    try:
        return apply(), ran
    finally:
        for (m, n), f in origs.items():
            setattr(m, n, f)


def expected(choice):
    return {"panel": ["panel_apply_plain"], "strip": ["slab_apply_plain"],
            None: []}[choice]


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("kind", ["contiguous", "strided", "vbcrs 16",
                                  "shifted"])
def test_bsm_routes_like_jax(kind, transpose):
    blocks, rows, cols, shape = GENERAL[kind]()
    P = bt.BlockSparseMatrix(blocks, rows, cols, shape, device="cpu")
    jl = jax_build_layout(blocks, rows, cols, shape, granularity="pow2")
    jp = jpanel.panel_plan_from_layout(jl, transpose=transpose)
    js = jstrip.plan_from_layout(jl, transpose=transpose)
    want = jax_choice(None if jp is None else (jp, None),
                      None if js is None else (js, None), [(jl, 1)])
    S = general(kind)[2]
    S = S.T if transpose else S
    x = _x(S.shape[1], 43)
    op = P.T if transpose else P
    y, ran = routed(lambda: op @ torch.from_numpy(x))
    assert ran == expected(want)
    assert relerr(y, S @ x.astype(np.float64)) <= TOL_SCIPY
    # r > 1 and float64 never take the stream route
    X = np.stack([x, x[::-1]], axis=1).copy()
    _, ran = routed(lambda: op @ torch.from_numpy(X))
    assert ran == []
    P64 = bt.BlockSparseMatrix(blocks, rows, cols, shape, dtype=np.float64,
                               device="cpu")
    y64, ran = routed(lambda: (P64.T if transpose else P64)
                      @ torch.from_numpy(x.astype(np.float64)))
    assert ran == [] and relerr(y64, S @ x.astype(np.float64)) <= 1e-13


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("kind", ["fused", "strip unified", "diagonal only"])
def test_symmetric_routes_like_jax(kind, transpose):
    d, di, o, ri, ci, shape = SYMMETRIC[kind]()
    P = bt.SymmetricBlockMatrix(d, di, o, ri, ci, shape, device="cpu")
    (jd, jo), _, S = symmetric(kind)
    jp = jpanel.panel_plan_symmetric(jd, jo, transpose_diag=transpose)
    js = jstrip.plan_symmetric(jd, jo, transpose_diag=transpose)
    want = jax_choice(None if jp is None else (jp, None),
                      None if js is None else (js, None), [(jd, 1), (jo, 2)])
    S = S.T if transpose else S
    x = _x(shape[0], 44)
    if want == "panel":   # the staged plan is the H100 rule's pick
        pick = panel_router.symmetric_choice(*panel.symmetric_candidates(
            P._dlayout, P._olayout, transpose_diag=transpose))
        staged = P._stream_entry(transpose)[1]
        assert (staged.mirror, staged.nt) == (pick.mirror, pick.nt)
    y, ran = routed(lambda: (P.T if transpose else P) @ torch.from_numpy(x))
    assert ran == expected(want)
    assert relerr(y, S @ x.astype(np.float64)) <= TOL_SCIPY
    y, ran = routed(lambda: (P.H if transpose else P) @ torch.from_numpy(x))
    assert ran == expected(want)
    assert relerr(y, S @ x.astype(np.float64)) <= TOL_SCIPY


def test_stream_plans_are_lazy_and_staged_once():
    blocks, rows, cols, shape = GENERAL["vbcrs 16"]()
    P = bt.BlockSparseMatrix(blocks, rows, cols, shape, device="cpu")
    assert P._stream == {}
    P @ torch.from_numpy(np.ones((shape[1], 2), np.float32))
    assert P._stream == {}          # r > 1 builds no stream plan
    x = torch.from_numpy(_x(shape[1], 45))
    P @ x
    assert set(P._stream) == {("panel", False), ("strip", False),
                              ("route", False)}
    choice, plan, dev = P._stream[("route", False)]
    P @ x
    assert P._stream[("route", False)][2] is dev


def test_gradients_through_the_stream_route():
    """VBCRS and S: d(w . A @ x)/dx through the stream route = A^T w."""
    blocks, rs, cs, shape = jtm.random_vbcrs(16, dtype=np.float32)
    V = bt.VariableBlockCompressedRowStorage(blocks, rs, cs, shape,
                                             device="cpu")
    Sv = bst.to_scipy(bst.VariableBlockCompressedRowStorage(
        [b.astype(np.float64) for b in blocks], rs, cs, shape))
    assert V._stream_entry(False)[0] is not None
    d, di, o, ri, ci, sshape = SYMMETRIC["fused"]()
    Sy = bt.SymmetricBlockMatrix(d, di, o, ri, ci, sshape, device="cpu")
    Ss = symmetric("fused")[2]
    assert Sy._stream_entry(False)[0] is not None
    for op, S in ((V, Sv), (Sy, Ss)):
        x = torch.from_numpy(_x(S.shape[1], 46)).requires_grad_()
        w = _x(S.shape[0], 47)
        y, ran = routed(lambda: op @ x)
        assert ran
        (torch.from_numpy(w) * y).sum().backward()
        assert relerr(x.grad, S.T @ w.astype(np.float64)) <= TOL_SCIPY
