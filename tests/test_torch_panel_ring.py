"""Kernel B5's bulk-copy ring on the CPU: what its launch relies on, and the
port's H100 rule for a symmetric operand's v1 panel plan.

The CUDA kernel (``csrc/panel_spmv.cu``) runs only on a card
(``chip_smoke.py`` phase 1).  Here:

* the plan property its producer warp relies on -- in every slab the live
  tiles come first and the padding tiles (rid8 == RW, cid8 == CW) trail
  them, ``nt`` live tiles in all -- on the fixtures' general, fused and
  expanded plans;
* the H100 rule (``ops/panel_router.py``): its cost is the live tiles'
  bytes (times ``MIRROR_FACTOR`` on a fused plan) plus the tables B5
  stages; on recipes where the JAX package's v5e rule picks the expanded
  plan and the H100 rule the fused one, the port's symmetric format reads
  the fused plan, whose product equals float64 scipy (f64: 1e-13; f32:
  3e-5, as ``test_torch_stream.py``) and the JAX package's product through
  its own route, in Pallas interpret mode (f32, 1e-5 relative to
  max(1, max|ref|));
* the stream route charges the plan the rule's cost (``route_bytes``), so
  a fused plan the JAX package's bytes would send to the buckets stays on
  the panel.
"""

import numpy as np
import pytest
import torch

import blocksparse_tpu as bst
from blocksparse_tpu.core import panel as jpanel
from blocksparse_tpu.core.layout import build_layout as jax_build_layout
from blocksparse_tpu.utils import testmatrices as jtm

import blocksparse_tpu_torch as bt
from blocksparse_tpu_torch.core import panel, strip
from blocksparse_tpu_torch.core.layout import build_layout
from blocksparse_tpu_torch.ops import panel_router
from blocksparse_tpu_torch.ops.dispatch import stream_plan_choice
from blocksparse_tpu_torch.ops.kernels import panel_spmv

from test_torch_stream import GENERAL, SYMMETRIC, relerr

torch.set_num_threads(2)

TOL32, TOL_SCIPY, TOL64 = 1e-5, 3e-5, 1e-13


def _symmetric_layouts(args):
    d, di, o, ri, ci, shape = args
    return build_layout(d, di, di, shape), build_layout(o, ri, ci, shape)


def _plans():
    out = {}
    for kind, transposes in (("contiguous", (False, True)),
                             ("shifted", (False, True)),
                             ("wrap", (False, True)),
                             ("vbcrs 15", (False, True)),
                             ("local rows", (False,))):
        blocks, rows, cols, shape = GENERAL[kind]()
        lay = build_layout(blocks, rows, cols, shape)
        for tr in transposes:
            out[f"{kind} transpose={tr}"] = lambda lay=lay, tr=tr: (
                panel.panel_plan_from_layout(lay, transpose=tr))
    for kind in ("fused", "strip unified", "overlapping mirror"):
        for which in (0, 1):
            out[f"symmetric {kind} {('fused', 'expanded')[which]}"] = (
                lambda kind=kind, which=which: panel.symmetric_candidates(
                    *_symmetric_layouts(SYMMETRIC[kind]()))[which])
    return out


PLANS = _plans()


@pytest.mark.parametrize("name", list(PLANS))
def test_padding_trails_live_tiles(name):
    """B5's producer copies a stage's live tiles as one span: in every
    slab the live tiles are a prefix, and their ids are in range."""
    plan = PLANS[name]()
    rid = plan.rid8.reshape(plan.S, plan.TS)
    cid = plan.cid8.reshape(plan.S, plan.TS)
    live = rid < plan.RW
    n_live = live.sum(axis=1)
    assert np.array_equal(live, np.arange(plan.TS)[None, :] < n_live[:, None])
    assert int(n_live.sum()) == plan.nt
    assert np.all(rid[live] >= 0) and np.all(rid[~live] == plan.RW)
    assert np.all((cid[live] >= 0) & (cid[live] < plan.CW))
    assert np.all(cid[~live] == plan.CW)


@pytest.mark.parametrize("kind", ["fused", "overlapping mirror"])
def test_b5_cost(kind):
    """Live tiles x MIRROR_FACTOR (fused plans) plus rid8, cid8, segid and
    otgt, the tables B5 reads; padding tiles cost nothing."""
    fused, expanded = panel.symmetric_candidates(
        *_symmetric_layouts(SYMMETRIC[kind]()))
    for plan in (fused, expanded):
        live = plan.nt * 8 * 128 * 4
        tables = 4 * (plan.rid8.size + plan.cid8.size + plan.segid.size)
        if plan.mirror:
            tables += 4 * plan.otgt.size
            live *= panel_router.MIRROR_FACTOR
        assert panel_router.b5_cost(plan) == pytest.approx(live + tables)
    assert fused.mirror and not expanded.mirror


def _recipe(seed, n, ngroups, noffdiag):
    return lambda: jtm.random_symmetric(seed, n=n, ngroups=ngroups,
                                        noffdiag=noffdiag, dtype=np.float32,
                                        contiguous=True)


# Recipes whose fused plan the JAX rule charges out (its x1.4 per byte and
# the one-hot map-back) and the H100 rule picks.
DISAGREE = {"n=700, 26 off-diagonals": _recipe(13, 700, 14, 26),
            "n=768, 12 off-diagonals": _recipe(39, 768, 12, 12),
            "n=1536, 20 off-diagonals": _recipe(30, 1536, 16, 20)}


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("recipe", list(DISAGREE))
def test_h100_rule_where_jax_picks_expanded(recipe, transpose):
    args = DISAGREE[recipe]()
    d, di, o, ri, ci, shape = args
    dl, ol = _symmetric_layouts(args)
    fused, expanded = panel.symmetric_candidates(dl, ol,
                                                 transpose_diag=transpose)
    # the JAX rule, in both packages, picks the expanded plan ...
    jp = jpanel.panel_plan_symmetric(
        jax_build_layout(d, di, di, shape, granularity="pow2"),
        jax_build_layout(o, ri, ci, shape, granularity="pow2"),
        transpose_diag=transpose)
    assert not jp.mirror
    assert not panel.panel_plan_symmetric(dl, ol,
                                          transpose_diag=transpose).mirror
    # ... the H100 rule the fused one, and the format reads it
    assert panel_router.b5_cost(fused) < panel_router.b5_cost(expanded)
    plan = panel_router.panel_plan_sym(dl, ol, transpose_diag=transpose)
    assert plan.mirror and plan.nt == fused.nt
    S = bt.SymmetricBlockMatrix(d, di, o, ri, ci, shape, device="cpu")
    choice, staged, _ = S._stream_entry(transpose)
    assert choice == "panel" and staged.mirror and staged.nt == fused.nt

    J = bst.SymmetricBlockMatrix([b.astype(np.float64) for b in d], di,
                                 [b.astype(np.float64) for b in o], ri, ci,
                                 shape, backend="xla")
    oracle = bst.to_scipy(J)
    oracle = oracle.T if transpose else oracle
    x = np.random.default_rng(51).standard_normal(shape[1])
    ref64 = oracle @ x
    # the plan's product: f64 against scipy of the same f32 values
    dev = panel_spmv.panel_device_arrays(plan, "cpu")
    y64 = panel_spmv.panel_apply_plain(plan, dev, torch.from_numpy(x))
    assert y64.dtype == torch.float64 and relerr(y64, ref64) <= TOL64
    x32 = x.astype(np.float32)
    y32 = (S.T if transpose else S) @ torch.from_numpy(x32)
    assert relerr(y32, oracle @ x32.astype(np.float64)) <= TOL_SCIPY
    # the JAX package's product through its route (expanded plan, Pallas
    # in interpret mode)
    JI = bst.SymmetricBlockMatrix(d, di, o, ri, ci, shape,
                                  backend="pallas-interpret")
    jy = np.asarray((JI.T if transpose else JI) @ x32)
    assert relerr(y32, jy) <= TOL32


# Recipes whose fused plan, charged the JAX package's tile and aux bytes
# (padding tiles and the one-hot map-back), would lose to the bucket route,
# while charged the H100 rule's b5_cost it stays on the panel.
ONE_COST = {"n=768, seed 1": _recipe(1, 768, 16, 20),
            "n=700, seed 2": _recipe(2, 700, 16, 12)}


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("recipe", list(ONE_COST))
def test_route_charges_the_rules_cost(recipe, transpose):
    """The stream route charges a symmetric operand's v1 plan the cost by
    which the H100 rule picked it (``route_bytes`` = ``b5_cost``), not the
    JAX package's bytes: the fused plan the rule picks stays on the panel,
    and its product equals float64 scipy."""
    args = ONE_COST[recipe]()
    d, di, o, ri, ci, shape = args
    dl, ol = _symmetric_layouts(args)
    fused, expanded = panel.symmetric_candidates(dl, ol,
                                                 transpose_diag=transpose)
    assert not panel.panel_plan_symmetric(dl, ol,
                                          transpose_diag=transpose).mirror
    pick = panel_router.symmetric_choice(fused, expanded)
    assert pick is fused
    assert panel_router.route_bytes(pick) == panel_router.b5_cost(fused)
    splan = strip.plan_symmetric(dl, ol, transpose_diag=transpose)
    reads = [(dl, 1), (ol, 2)]
    assert stream_plan_choice(pick, splan, reads) is None
    assert stream_plan_choice(
        pick, splan, reads,
        panel_bytes=panel_router.route_bytes(pick)) == "panel"
    S = bt.SymmetricBlockMatrix(d, di, o, ri, ci, shape, device="cpu")
    choice, staged, _ = S._stream_entry(transpose)
    assert choice == "panel" and staged.mirror and staged.nt == fused.nt
    oracle = bst.to_scipy(bst.SymmetricBlockMatrix(
        [b.astype(np.float64) for b in d], di,
        [b.astype(np.float64) for b in o], ri, ci, shape, backend="xla"))
    oracle = oracle.T if transpose else oracle
    x = np.random.default_rng(53).standard_normal(shape[1]).astype(np.float32)
    y = (S.T if transpose else S) @ torch.from_numpy(x)
    assert relerr(y, oracle @ x.astype(np.float64)) <= TOL_SCIPY


def test_panel_spmv_on_cpu_takes_the_plain_version():
    """tiles_per_block changes nothing on the CPU: the plain version runs,
    no launch is counted."""
    plan = PLANS["symmetric fused fused"]()
    dev = panel_spmv.panel_device_arrays(plan, "cpu")
    x = torch.from_numpy(np.random.default_rng(52).standard_normal(
        plan.ncols).astype(np.float32))
    before = (panel_spmv.LAUNCHES, panel_spmv.MIRROR_LAUNCHES)
    ref = panel_spmv.panel_apply_plain(plan, dev, x)
    for tpb in (None, 1, 7):
        assert torch.equal(panel_spmv.panel_spmv(plan, dev, x,
                                                 tiles_per_block=tpb), ref)
    assert (panel_spmv.LAUNCHES, panel_spmv.MIRROR_LAUNCHES) == before
