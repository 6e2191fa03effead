"""The port's panel v2 route on the CPU: planner, decision, kernel B10.

The port carries a numpy copy of the JAX package's v2 planner
(``core/panel2.py``).  Here every field of its plans is held equal to the
original's on the fixtures of ``tests/test_panel2.py``, the plain version
of kernel B10 is held against the JAX Pallas kernels in interpret mode and
against ``_xla_forward`` (``test_panel2.py``'s TOL = 3e-5 relative to
max(1, max|ref|)) and its gradient against 2 D^T D x (2e-4), the route
decision with v2 plans is held to the JAX decision, and the formats built
with ``panel="v2"`` agree with the JAX operators under
``BST_PANEL_IMPL=v2`` (pallas-interpret) and with scipy.  The CUDA kernel
itself runs only on a card (``chip_smoke.py`` phases 1 and 11).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import blocksparse_tpu as bst
from blocksparse_tpu.core import panel2 as jpanel2
from blocksparse_tpu.core import strip as jstrip
from blocksparse_tpu.core.layout import build_layout as jax_build_layout
from blocksparse_tpu.ops.dispatch import stream_plan_choice as jax_choice
from blocksparse_tpu.ops.pallas import panel2_spmv as jpanel2_k
from blocksparse_tpu.utils import testmatrices as jtm

import blocksparse_tpu_torch as bt
from blocksparse_tpu_torch.core import panel2, strip
from blocksparse_tpu_torch.core.layout import build_layout
from blocksparse_tpu_torch.ops import batched
from blocksparse_tpu_torch.ops.dispatch import stream_plan_choice
from blocksparse_tpu_torch.ops.kernels import panel2_spmv

torch.set_num_threads(2)

TOL = 3e-5

FIELDS = ("nrows", "ncols", "seg", "S", "TS", "CW", "RW", "n8p", "NC", "nt",
          "mirror", "vals", "rid8", "cid8", "segid", "tgt", "b8")


def relerr(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b))) / max(1.0, float(np.max(np.abs(b))))


def assert_same_plan(mine, ref):
    assert (mine is None) == (ref is None)
    if ref is None:
        return
    assert isinstance(mine, panel2.Panel2Plan)
    for f in FIELDS:
        a, b = getattr(mine, f), getattr(ref, f)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f
            assert a.tobytes() == b.tobytes(), f
        else:
            assert a == b, f
    assert (mine.tile_bytes, mine.aux_bytes) == (ref.tile_bytes, ref.aux_bytes)


# -- fixtures (those of tests/test_panel2.py) --------------------------------

def _clustered(seed, n=600, nb=25, bs=40):
    rng = np.random.default_rng(seed)
    span = int(bs * 1.3)
    blocks, rows, cols = [], [], []
    for _ in range(nb):
        blocks.append(rng.standard_normal((bs, bs)).astype(np.float32))
        rb = int(rng.integers(0, n - span))
        cb = int(rng.integers(0, n - span))
        rows.append(rb + rng.choice(span, bs, replace=False))
        cols.append(cb + rng.choice(span, bs, replace=False))
    return blocks, rows, cols, (n, n)


def _uniform(n=1024, bs=64, nb=20, seed=9):
    rng = np.random.default_rng(seed)
    nt = n // bs
    pos = rng.choice(nt * nt, nb, replace=False)
    blocks = [rng.standard_normal((bs, bs)).astype(np.float32)
              for _ in range(nb)]
    rows = [np.arange((p // nt) * bs, (p // nt) * bs + bs) for p in pos]
    cols = [np.arange((p % nt) * bs, (p % nt) * bs + bs) for p in pos]
    return blocks, rows, cols, (n, n)


def _ties():
    n, bs = 512, 64
    rng = np.random.default_rng(2)
    blocks = [rng.standard_normal((bs, bs)).astype(np.float32)
              for _ in range(6)]
    rows = [np.arange(i * bs, (i + 1) * bs) for i in range(6)]
    cols = [np.arange(((i * 3) % 8) * bs, ((i * 3) % 8 + 1) * bs)
            for i in range(6)]
    return blocks, rows, cols, (n, n)


def _rect(seed=2, m=512, n=768):
    """A rectangular contiguous population the v2 decision sends to the
    panel plan, both ways."""
    rng = np.random.default_rng(seed)
    blocks, rows, cols = [], [], []
    for _ in range(25):
        h, w = int(rng.integers(1, 150)), int(rng.integers(1, 150))
        r0, c0 = int(rng.integers(0, m - h)), int(rng.integers(0, n - w))
        blocks.append(rng.standard_normal((h, w)).astype(np.float32))
        rows.append(np.arange(r0, r0 + h))
        cols.append(np.arange(c0, c0 + w))
    return blocks, rows, cols, (m, n)


def _vbcrs15():
    blocks, rs, cs, shape = jtm.random_vbcrs(15, dtype=np.float32)
    return (blocks, [np.arange(r, r + b.shape[0]) for r, b in zip(rs, blocks)],
            [np.arange(c, c + b.shape[1]) for c, b in zip(cs, blocks)], shape)


GENERAL = {
    "contiguous 8": lambda: jtm.random_block_sparse(
        29, shape=(600, 600), nblocks=25, max_block=60, dtype=np.float32,
        contiguous=True),
    "contiguous 16": lambda: jtm.random_block_sparse(
        37, shape=(600, 600), nblocks=25, max_block=60, dtype=np.float32,
        contiguous=True),
    "contiguous 32": lambda: jtm.random_block_sparse(
        53, shape=(600, 600), nblocks=25, max_block=60, dtype=np.float32,
        contiguous=True),
    "clustered 8": lambda: _clustered(29),
    "clustered 16": lambda: _clustered(37),
    "clustered 32": lambda: _clustered(53),
    "uniform aligned": _uniform,
    "ties": _ties,
    "rectangular": _rect,
    "vbcrs 15": _vbcrs15,
}

SYMMETRIC = {
    # test_panel2.py::test_symmetric_fused_oracle's fixture at each seg
    **{f"seg {seg}": functools.partial(
        jtm.random_symmetric, 31 + seg, n=800, ngroups=10, noffdiag=24,
        dtype=np.float32, contiguous=True) for seg in (8, 16, 32)},
    "chooser": lambda: jtm.random_symmetric(41, n=700, ngroups=9,
                                            noffdiag=18, dtype=np.float32,
                                            contiguous=True),
    "fused": lambda: jtm.random_symmetric(8, n=1024, ngroups=12, noffdiag=40,
                                          dtype=np.float32, contiguous=True),
    "expanded": lambda: jtm.random_symmetric(13, n=700, ngroups=14,
                                             noffdiag=26, dtype=np.float32,
                                             contiguous=True),
}


@functools.lru_cache(maxsize=None)
def general(kind):
    """(jax layout, port layout, blocks, rows, cols, shape)."""
    blocks, rows, cols, shape = GENERAL[kind]()
    return (jax_build_layout(blocks, rows, cols, shape, granularity="pow2"),
            build_layout(blocks, rows, cols, shape), blocks, rows, cols, shape)


@functools.lru_cache(maxsize=None)
def symmetric(kind):
    """((jax d, o layouts), (port d, o layouts), raw fixture)."""
    d, di, o, ri, ci, shape = SYMMETRIC[kind]()
    return ((jax_build_layout(d, di, di, shape, granularity="pow2"),
             jax_build_layout(o, ri, ci, shape, granularity="pow2")),
            (build_layout(d, di, di, shape), build_layout(o, ri, ci, shape)),
            (d, di, o, ri, ci, shape))


# -- plan equality ------------------------------------------------------------

def test_greedy_cover_equal_on_unsorted_lists():
    rng = np.random.default_rng(3)
    for seg in (8, 16, 32):
        for _ in range(4):
            cols = np.unique(rng.choice(500, 60))
            rng.shuffle(cols)
            w_m, l_m = panel2.greedy_cover(cols, seg)
            w_r, l_r = jpanel2.greedy_cover(cols, seg)
            assert np.array_equal(w_m, w_r) and np.array_equal(l_m, l_r)


@pytest.mark.parametrize("seg", [8, 16, 32])
@pytest.mark.parametrize("kind", ["contiguous", "clustered"])
def test_build_panel2_plan_equal(seg, kind):
    """test_panel2.py::test_block_sparse_oracle's plans, field for field."""
    jl, pl_, *_ = general(f"{kind} {seg}")
    assert_same_plan(
        panel2.build_panel2_plan(panel2._layout_entries(pl_, transpose=False),
                                 (pl_.nrows, pl_.ncols), seg=seg),
        jpanel2.build_panel2_plan(jpanel2._layout_entries(jl, transpose=False),
                                  (jl.nrows, jl.ncols), seg=seg))


@pytest.mark.parametrize("seg", [8, 16, 32])
def test_symmetric_fused_plan_equal(seg):
    """test_panel2.py::test_symmetric_fused_oracle's mirror plans."""
    (jd, jo), (pd, po), raw = symmetric(f"seg {seg}")

    def fused(mod, d, o):
        diag = mod._layout_entries(d, transpose=False)
        off = mod._layout_entries(o, transpose=False)
        return mod.build_panel2_plan(
            diag + [(b, r, c, True) for b, r, c, _ in off], raw[-1], seg=seg,
            mirror=True)

    mine = fused(panel2, pd, po)
    assert mine.mirror and mine.tgt is not None
    assert_same_plan(mine, fused(jpanel2, jd, jo))


@pytest.mark.parametrize("kind", ["seg 8", "chooser", "fused", "expanded"])
@pytest.mark.parametrize("transpose_diag", [False, True])
def test_panel2_plan_symmetric_equal(kind, transpose_diag):
    (jd, jo), (pd, po), _ = symmetric(kind)
    assert_same_plan(
        panel2.panel2_plan_symmetric(pd, po, transpose_diag=transpose_diag),
        jpanel2.panel2_plan_symmetric(jd, jo, transpose_diag=transpose_diag))


@pytest.mark.parametrize("kind", ["uniform aligned", "ties", "rectangular",
                                  "vbcrs 15", "contiguous 16"])
@pytest.mark.parametrize("transpose", [False, True])
def test_panel2_plan_from_layout_equal(kind, transpose):
    jl, pl_, *_ = general(kind)
    mine = panel2.panel2_plan_from_layout(pl_, transpose=transpose)
    assert_same_plan(mine,
                     jpanel2.panel2_plan_from_layout(jl, transpose=transpose))
    if kind == "ties":
        assert mine.seg == 32   # test_chooser_prefers_larger_seg_on_ties


# -- kernel B10's plain version -------------------------------------------------

def _jax_outputs(plan_j, x):
    dev = jpanel2_k.panel2_device_arrays(plan_j)
    xj = jnp.asarray(x)
    return (np.asarray(jpanel2_k.panel2_apply(plan_j, dev, xj,
                                              interpret=True)),
            np.asarray(jpanel2_k._xla_forward(dev, xj,
                                              jpanel2_k._meta(plan_j))))


PLAIN_CASES = {
    "contiguous seg 8": lambda: general("contiguous 8")[:2] + (8, False),
    "clustered seg 16": lambda: general("clustered 16")[:2] + (16, False),
    "clustered seg 32": lambda: general("clustered 32")[:2] + (32, False),
    "mirror seg 8": lambda: symmetric("seg 8")[:2] + (8, True),
    "mirror seg 16": lambda: symmetric("seg 16")[:2] + (16, True),
    "mirror seg 32": lambda: symmetric("seg 32")[:2] + (32, True),
}


def _plans_of(case):
    jl, pl_, seg, mirror = PLAIN_CASES[case]()
    if not mirror:
        mk = lambda mod, lay: mod.build_panel2_plan(
            mod._layout_entries(lay, transpose=False), (lay.nrows, lay.ncols),
            seg=seg)
        return mk(panel2, pl_), mk(jpanel2, jl)
    (jd, jo), (pd, po) = jl, pl_

    def mk(mod, d, o):
        diag = mod._layout_entries(d, transpose=False)
        off = mod._layout_entries(o, transpose=False)
        return mod.build_panel2_plan(
            diag + [(b, r, c, True) for b, r, c, _ in off],
            (d.nrows, d.ncols), seg=seg, mirror=True)
    return mk(panel2, pd, po), mk(jpanel2, jd, jo)


@pytest.mark.parametrize("case", list(PLAIN_CASES))
def test_plain_matches_jax_kernel(case):
    mine, ref = _plans_of(case)
    x = np.random.default_rng(7).standard_normal(mine.ncols).astype(np.float32)
    dev = panel2_spmv.panel2_device_arrays(mine, "cpu")
    got = panel2_spmv.panel2_apply(mine, dev, torch.from_numpy(x))
    kern, xla = _jax_outputs(ref, x)
    assert relerr(got, kern) <= TOL
    assert relerr(got, xla) <= TOL
    assert panel2_spmv.LAUNCHES == 0   # CPU tensors never launch


def test_plain_gradient_is_exact():
    """test_panel2.py::test_vjp_exact through the port's autograd."""
    blocks, rows, cols, shape = jtm.random_block_sparse(
        seed=55, shape=(400, 400), nblocks=12, max_block=40,
        dtype=np.float32, contiguous=True)
    plan = panel2.panel2_plan_from_layout(build_layout(blocks, rows, cols,
                                                       shape))
    dev = panel2_spmv.panel2_device_arrays(plan, "cpu")
    J = bst.BlockSparseMatrix(blocks, rows, cols, shape, backend="xla")
    D = np.asarray(bst.to_scipy(J).todense(), np.float64)
    x = np.random.default_rng(7).standard_normal(shape[1]).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    (panel2_spmv.panel2_apply(plan, dev, xt) ** 2).sum().backward()
    gref = 2 * D.T @ (D @ x.astype(np.float64))
    assert relerr(xt.grad, gref) <= 2e-4


def test_autograd_gradcheck_f64():
    """B10's Function on a small mirror plan, in float64 through the plain
    version (values and x both differentiated)."""
    plan = _plans_of("mirror seg 16")[0]
    dev = panel2_spmv.panel2_device_arrays(plan, "cpu")
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal(plan.ncols)).requires_grad_()
    vals = dev[0].double().requires_grad_()
    rest = tuple(dev[1:])

    def fn(v, xx):
        return panel2_spmv.panel2_apply(plan, (v,) + rest, xx)
    assert torch.autograd.gradcheck(fn, (vals, x), eps=1e-6, atol=1e-7,
                                    fast_mode=True)


def test_plain_rejects_bad_operands():
    plan = _plans_of("contiguous seg 8")[0]
    dev = panel2_spmv.panel2_device_arrays(plan, "cpu")
    with pytest.raises(ValueError):
        panel2_spmv.panel2_spmv(plan, dev, torch.zeros(plan.ncols + 1))
    with pytest.raises(ValueError):
        panel2_spmv.panel2_spmv(plan, dev, torch.zeros(plan.ncols, 2))


# -- the route decision ---------------------------------------------------------

def _entry(plan):
    """The JAX decision's (plan, device leaves) argument."""
    return None if plan is None else (plan, None)


@pytest.mark.parametrize("kind", ["contiguous 16", "uniform aligned",
                                  "rectangular", "vbcrs 15", "clustered 32"])
@pytest.mark.parametrize("transpose", [False, True])
def test_decision_equal_general(kind, transpose):
    jl, pl_, *_ = general(kind)
    mine = stream_plan_choice(
        panel2.panel2_plan_from_layout(pl_, transpose=transpose),
        strip.plan_from_layout(pl_, transpose=transpose), [(pl_, 1)])
    ref = jax_choice(
        _entry(jpanel2.panel2_plan_from_layout(jl, transpose=transpose)),
        _entry(jstrip.plan_from_layout(jl, transpose=transpose)), [(jl, 1)])
    assert mine == ref


@pytest.mark.parametrize("kind", ["seg 8", "chooser", "fused", "expanded"])
def test_decision_equal_symmetric(kind):
    (jd, jo), (pd, po), _ = symmetric(kind)
    mine = stream_plan_choice(panel2.panel2_plan_symmetric(pd, po),
                              strip.plan_symmetric(pd, po),
                              [(pd, 1), (po, 2)])
    ref = jax_choice(_entry(jpanel2.panel2_plan_symmetric(jd, jo)),
                     _entry(jstrip.plan_symmetric(jd, jo)), [(jd, 1), (jo, 2)])
    assert mine == ref


# -- the route through the formats ----------------------------------------------

def _require_v2_route(op, transpose=False):
    choice, plan, _ = op._stream_entry(transpose)
    assert choice == "panel" and isinstance(plan, panel2.Panel2Plan)
    return plan


def _jax_v2(monkeypatch, make):
    monkeypatch.setenv("BST_PANEL_IMPL", "v2")
    return make()


@pytest.mark.parametrize("kind", ["rectangular", "vbcrs 15"])
def test_bsm_route_matches_jax_v2(monkeypatch, kind):
    _, _, blocks, rows, cols, shape = general(kind)
    A = bt.BlockSparseMatrix(blocks, rows, cols, shape, panel="v2",
                             device="cpu")
    J = _jax_v2(monkeypatch, lambda: bst.BlockSparseMatrix(
        blocks, rows, cols, shape, backend="pallas-interpret"))
    S = bst.to_scipy(J).astype(np.float64)
    rng = np.random.default_rng(4)
    for tr in (False, True):
        x = rng.standard_normal(shape[0] if tr else shape[1]).astype(np.float32)
        got = (A.T if tr else A) @ torch.from_numpy(x)
        _require_v2_route(A, tr)
        assert relerr(got, np.asarray((J.T if tr else J) @ jnp.asarray(x))) \
            <= TOL
        assert relerr(got, (S.T if tr else S) @ x) <= TOL


def test_vbcrs_route_matches_jax_v2(monkeypatch):
    blocks, rs, cs, shape = jtm.random_vbcrs(15, dtype=np.float32)
    V = bt.VariableBlockCompressedRowStorage(blocks, rs, cs, shape,
                                             panel="v2", device="cpu")
    J = _jax_v2(monkeypatch, lambda: bst.VariableBlockCompressedRowStorage(
        blocks, rs, cs, shape, backend="pallas-interpret"))
    S = bst.to_scipy(J).astype(np.float64)
    x = np.random.default_rng(5).standard_normal(shape[1]).astype(np.float32)
    for tr in (False, True):
        got = (V.T if tr else V) @ torch.from_numpy(x)
        _require_v2_route(V, tr)
        assert relerr(got, np.asarray((J.T if tr else J) @ jnp.asarray(x))) \
            <= TOL
        assert relerr(got, (S.T if tr else S) @ x) <= TOL


@pytest.mark.parametrize("kind", ["fused", "expanded"])
def test_symmetric_route_matches_jax_v2(monkeypatch, kind):
    d, di, o, ri, ci, shape = symmetric(kind)[2]
    Sp = bt.SymmetricBlockMatrix(d, di, o, ri, ci, shape, panel="v2",
                                 device="cpu")
    J = _jax_v2(monkeypatch, lambda: bst.SymmetricBlockMatrix(
        d, di, o, ri, ci, shape, backend="pallas-interpret"))
    Ssc = bst.to_scipy(J).astype(np.float64)
    x = np.random.default_rng(6).standard_normal(shape[0]).astype(np.float32)
    for tr in (False, True):
        got = (Sp.T if tr else Sp) @ torch.from_numpy(x)
        plan = _require_v2_route(Sp, tr)
        assert plan.mirror == (kind == "fused")
        assert relerr(got, np.asarray((J.T if tr else J) @ jnp.asarray(x))) \
            <= TOL
        assert relerr(got, (Ssc.T if tr else Ssc) @ x) <= TOL


def test_from_reference_takes_panel_option(monkeypatch):
    _, _, blocks, rows, cols, shape = general("rectangular")
    J = _jax_v2(monkeypatch, lambda: bst.BlockSparseMatrix(
        blocks, rows, cols, shape, backend="pallas-interpret"))
    A = bt.from_reference(J, panel="v2", device="cpu")
    assert A.panel == "v2" and A.patch == "auto" and "panel='v2'" in repr(A)
    x = np.random.default_rng(8).standard_normal(shape[1]).astype(np.float32)
    got = A @ torch.from_numpy(x)
    _require_v2_route(A)
    assert relerr(got, np.asarray(J @ jnp.asarray(x))) <= TOL
    V = bt.VariableBlockCompressedRowStorage.from_block_sparse(A)
    assert V.panel == "v2"


def test_gradient_through_the_v2_route():
    _, _, blocks, rows, cols, shape = general("rectangular")
    A = bt.BlockSparseMatrix(blocks, rows, cols, shape, panel="v2",
                             device="cpu")
    S = bt.to_scipy(A).astype(np.float64)
    rng = np.random.default_rng(9)
    x, w = (rng.standard_normal(n).astype(np.float32) for n in shape[::-1])
    xt = torch.from_numpy(x).requires_grad_()
    (torch.from_numpy(w) * (A @ xt)).sum().backward()
    _require_v2_route(A)
    assert relerr(xt.grad, S.T @ w.astype(np.float64)) <= TOL


def test_default_stays_v1():
    _, _, blocks, rows, cols, shape = general("rectangular")
    A = bt.BlockSparseMatrix(blocks, rows, cols, shape, device="cpu")
    A @ torch.zeros(shape[1])
    choice, plan, _ = A._stream_entry(False)
    assert A.panel == "v1" and not isinstance(plan, panel2.Panel2Plan)


# -- batches ----------------------------------------------------------------------

def test_batched_mv_over_v2_operators_loops():
    """The JAX batched_mv fails on v2 plans; the port's batch loops,
    decided from the plan type."""
    blocks, rs, cs, shape = jtm.random_vbcrs(15, dtype=np.float32)
    rng = np.random.default_rng(10)
    ops = [bt.VariableBlockCompressedRowStorage(
        [rng.standard_normal(b.shape).astype(np.float32) for b in blocks]
        if p else blocks, rs, cs, shape, panel="v2", device="cpu")
        for p in range(2)]
    xs = rng.standard_normal((2, shape[1])).astype(np.float32)
    assert batched._stacked_panel_entry(ops) is None
    y = bt.batched_mv(ops, torch.from_numpy(xs))
    for p, op in enumerate(ops):
        _require_v2_route(op)
        assert relerr(y[p], bt.to_scipy(op).astype(np.float64) @ xs[p]) <= TOL
    v1 = [bt.VariableBlockCompressedRowStorage(blocks, rs, cs, shape,
                                               device="cpu")
          for _ in range(2)]
    assert batched._stacked_panel_entry(v1) is not None
