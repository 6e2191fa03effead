"""The port's batched products on the CPU: batched_mm (kernel B4) and
batched_mv (kernel B6).

Mirrors ``tests/test_batched.py``: the same populations, built in the JAX
package with ``backend="pallas-interpret"`` from seeded numpy and carried
over with ``from_reference(..., device="cpu")``.  The port's results are held
against ``blocksparse_tpu.batched_mm`` / ``batched_mv`` and both against
scipy (``TOL``, the JAX suite's), its gradients against ``jax.grad`` of the
JAX call (1e-5) and against ``2 A^T A X`` (5e-4), and the plain versions of
B4 and B6 against the JAX kernels in interpret mode (1e-5).  The route
decision (kernel or loop) is held to the JAX package's.  On the CPU the
batched route runs the kernels' plain versions; the CUDA kernels run only
on a card (``chip_smoke.py`` phases 1 and 9).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import blocksparse_tpu as bst
from blocksparse_tpu.ops import batched as jb
from blocksparse_tpu.ops.patch_engine import R_SLICE, _rows_c, _rows_r
from blocksparse_tpu.ops.pallas import panel_spmv as jpanel_k
from blocksparse_tpu.utils.testmatrices import random_symmetric

import blocksparse_tpu_torch as bt
from blocksparse_tpu_torch.ops import batched as pb
from blocksparse_tpu_torch.ops.kernels import batched_spmm, panel_spmv

torch.set_num_threads(2)

TOL = 2e-5


def relerr(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b))) / max(1.0, float(np.max(np.abs(b))))


def port(J, **kw):
    return bt.from_reference(J, device="cpu", **kw)


# -- populations (test_batched.py's recipes) --------------------------------

def build(seed, n=512, nblocks=10, bs=32, dtype=np.float32):
    rng = np.random.default_rng(7)      # fixed structure
    vrng = np.random.default_rng(seed)  # per-op values
    ntiles = n // bs
    pos = rng.choice(ntiles * ntiles, size=nblocks, replace=False)
    rows = (pos // ntiles) * bs
    cols = (pos % ntiles) * bs
    return bst.BlockSparseMatrix(
        [vrng.standard_normal((bs, bs)).astype(dtype)
         for _ in range(nblocks)],
        [np.arange(r, r + bs) for r in rows],
        [np.arange(c, c + bs) for c in cols],
        (n, n), backend="pallas-interpret")


def build_sym(seed, structure=9, n=640, ngroups=10, noffdiag=14):
    d, di, o, ri, ci, shape = random_symmetric(
        structure, n=n, ngroups=ngroups, noffdiag=noffdiag,
        dtype=np.float32, contiguous=True)
    vr = np.random.default_rng(seed)
    d = [vr.standard_normal(b.shape).astype(np.float32) for b in d]
    o = [vr.standard_normal(b.shape).astype(np.float32) for b in o]
    return bst.SymmetricBlockMatrix(d, di, o, ri, ci, shape,
                                    backend="pallas-interpret")


def build_mirror(seed):
    """test_batched.py::test_batched_mv_fused_mirror's population."""
    return build_sym(seed, structure=8, n=1024, ngroups=12, noffdiag=40)


def build_vbcrs(seed, n=512):
    """The config-3 recipe (groups of 16-128, six blocks per block row) at
    a small n; structure seed 9, values from ``seed``."""
    rng = np.random.default_rng(9)
    vrng = np.random.default_rng(seed)
    bounds = [0]
    while bounds[-1] < n:
        bounds.append(min(n, bounds[-1] + int(rng.integers(16, 129))))
    groups = [(bounds[i], bounds[i + 1] - bounds[i])
              for i in range(len(bounds) - 1)]
    blocks, rs, cs = [], [], []
    for r0, h in groups:
        for gj in rng.choice(len(groups), size=min(6, len(groups)),
                             replace=False):
            c0, w = groups[int(gj)]
            blocks.append(vrng.standard_normal((h, w)).astype(np.float32))
            rs.append(r0)
            cs.append(c0)
    return bst.VariableBlockCompressedRowStorage(
        blocks, rs, cs, (n, n), granularity=(8, 128),
        backend="pallas-interpret")


@pytest.fixture(scope="module")
def ops():
    J = [build(seed) for seed in (1, 2, 3)]
    return J, [port(A) for A in J]


def check_mm(J, P_, Xs):
    got = bt.batched_mm(P_, torch.from_numpy(Xs))
    ref = np.asarray(bst.batched_mm(J, Xs))
    assert got.shape == ref.shape
    assert relerr(got, ref) < TOL
    for p, A in enumerate(J):
        oracle = bst.to_scipy(A) @ Xs[p].astype(np.float64)
        assert relerr(ref[p], oracle) < TOL
        assert relerr(got[p], oracle) < TOL
    return got


def check_mv(J, P_, xs):
    got = bt.batched_mv(P_, torch.from_numpy(xs))
    ref = np.asarray(bst.batched_mv(J, xs))
    assert got.shape == ref.shape == (len(J), J[0].shape[0])
    assert relerr(got, ref) < TOL
    for p, A in enumerate(J):
        oracle = bst.to_scipy(A) @ xs[p].astype(np.float64)
        assert relerr(ref[p], oracle) < TOL
        assert relerr(got[p], oracle) < TOL
    return got


# -- batched_mm ---------------------------------------------------------------

def test_batched_matches_oracles(ops, rng):
    J, P_ = ops
    assert pb._stacked_entry(P_) is not None      # the batched route
    out = check_mm(J, P_, rng.standard_normal((3, 512, 24)).astype(np.float32))
    assert out.shape == (3, 512, 24) and out.dtype == torch.float32


def test_batched_list_input(ops, rng):
    J, P_ = ops
    Xs = [rng.standard_normal((512, 8)).astype(np.float32) for _ in range(3)]
    got = bt.batched_mm(P_, [torch.from_numpy(X) for X in Xs])
    assert relerr(got, bst.batched_mm(J, Xs)) < TOL
    for p, A in enumerate(J):
        assert relerr(got[p], bst.to_scipy(A) @ Xs[p]) < TOL


def test_batched_r_slicing(ops, rng):
    """r = R_SLICE + 8: the JAX package splits into column slices, B4 takes
    any r in one launch."""
    J, P_ = ops
    check_mm(J, P_, rng.standard_normal((3, 512, R_SLICE + 8)
                                        ).astype(np.float32))


def test_batched_grad(ops, rng):
    """Cotangents in Xs through the autograd Function (dX by B2's
    transposed product with its product axis): against jax.grad of the JAX
    call and against 2 A^T A X."""
    J, P_ = ops
    Xn = rng.standard_normal((3, 512, 8)).astype(np.float32)
    Xs = torch.from_numpy(Xn).requires_grad_()
    (bt.batched_mm(P_, Xs) ** 2).sum().backward()
    gj = np.asarray(jax.grad(
        lambda X: jnp.sum(bst.batched_mm(J, X) ** 2))(jnp.asarray(Xn)))
    assert relerr(Xs.grad, gj) < 1e-5
    for p, A in enumerate(J):
        S = bst.to_scipy(A)
        assert relerr(Xs.grad[p], 2 * (S.T @ (S @ Xn[p]))) < 5e-4


def test_fallback_on_mixed_structure(rng):
    """Different block structures loop per operator (identical semantics)."""
    J = [build(1, nblocks=10), build(2, nblocks=11)]
    P_ = [port(A) for A in J]
    assert jb._stacked_entry(J) is None and pb._stacked_entry(P_) is None
    check_mm(J, P_, rng.standard_normal((2, 512, 8)).astype(np.float32))


def test_guards(ops, rng):
    _, P_ = ops
    with pytest.raises(ValueError, match="leading dim"):
        bt.batched_mm(P_, torch.randn(2, 512, 8))
    with pytest.raises(ValueError, match="P, n, r"):
        bt.batched_mm(P_, torch.randn(3, 512))
    with pytest.raises(ValueError, match="leading dim"):
        bt.batched_mv(P_, torch.randn(2, 512))
    with pytest.raises(ValueError, match="P, n"):
        bt.batched_mv(P_, torch.randn(3, 512, 2))
    with pytest.raises(ValueError, match="512 rows"):
        bt.batched_mm(P_, torch.randn(3, 500, 8))


def test_b4_plain_vs_jax_interpret(ops, rng):
    """B4's plain version against ``_batched_raw`` in interpret mode on the
    same stacked values and tables, forward."""
    J, P_ = ops
    plan_j, vals_j, cc_j, rs_j = jb._stacked_entry(J)
    plan, vals, cc, rs = pb._stacked_entry(P_)
    assert np.array_equal(np.asarray(cc_j), cc.numpy())
    assert np.array_equal(np.asarray(rs_j), rs.numpy())
    assert np.array_equal(np.asarray(vals_j), vals.numpy())
    b = plan_j.buckets[0]
    for r in (8, 40):
        Xn = rng.standard_normal((3, 512, r)).astype(np.float32)
        xrows, yrows = _rows_c(plan_j), _rows_r(plan_j)
        meta = (3, b.G, b.MP, b.KP, r, xrows, yrows, b.nb // b.G, "highest")
        Xp = jnp.pad(jnp.asarray(Xn), ((0, 0), (0, xrows - 512), (0, 0)))
        ref = np.asarray(jb._batched_raw(meta, vals_j, cc_j, rs_j, Xp,
                                         True))[:, :plan_j.nrows]
        got = batched_spmm.batched_spmm_plain(vals, cc, rs,
                                              torch.from_numpy(Xn), plan.nrows)
        assert relerr(got, ref) < 1e-5


def test_b4_transpose_and_duality_with_b2(ops, rng):
    """B4's plain version in both modes equals P products of B2's plain
    version (the duality the card checks kernel against kernel)."""
    from blocksparse_tpu_torch.ops.patch_engine import bucket_spmm_plain

    _, P_ = ops
    plan, vals, cc, rs = pb._stacked_entry(P_)
    X = torch.from_numpy(rng.standard_normal((3, 512, 16)).astype(np.float32))
    for tr in (False, True):
        got = batched_spmm.batched_spmm(vals, cc, rs, X, 512, transpose=tr)
        for p in range(3):
            ref = bucket_spmm_plain(vals[p], cc, rs, X[p], 512, transpose=tr)
            assert relerr(got[p], ref) < 1e-5


def test_b4_autograd_dvals_matches_plain_autograd(ops, rng):
    """dvals and dX of the autograd Function equal autograd of the plain
    version, in both modes."""
    _, P_ = ops
    _, vals, cc, rs = pb._stacked_entry(P_)
    X = torch.from_numpy(rng.standard_normal((3, 512, 4)).astype(np.float32))
    W = torch.from_numpy(rng.standard_normal((3, 512, 4)).astype(np.float32))
    for tr in (False, True):
        v1, x1 = vals.clone().requires_grad_(), X.clone().requires_grad_()
        (W * batched_spmm.batched_spmm_apply(v1, cc, rs, x1, 512,
                                             transpose=tr)).sum().backward()
        v2, x2 = vals.clone().requires_grad_(), X.clone().requires_grad_()
        (W * batched_spmm.batched_spmm_plain(v2, cc, rs, x2, 512,
                                             transpose=tr)).sum().backward()
        assert relerr(v1.grad, v2.grad) < 1e-5
        assert relerr(x1.grad, x2.grad) < 1e-5


# -- batched_mv ---------------------------------------------------------------

@pytest.mark.parametrize("population", ["symmetric", "general", "vbcrs"])
def test_batched_mv_populations(population, rng):
    J = {"symmetric": lambda: [build_sym(s) for s in (1, 2, 3)],
         "general": lambda: [build(s) for s in (4, 5)],
         "vbcrs": lambda: [build_vbcrs(s) for s in (300, 301, 302)],
         }[population]()
    P_ = [port(A) for A in J]
    assert pb._stacked_panel_entry(P_) is not None   # the batched route
    xs = rng.standard_normal((len(J), J[0].shape[1])).astype(np.float32)
    check_mv(J, P_, xs)


def test_batched_mv_list_input(rng):
    J = [build(s) for s in (4, 5)]
    P_ = [port(A) for A in J]
    xs = [rng.standard_normal(512).astype(np.float32) for _ in range(2)]
    got = bt.batched_mv(P_, [torch.from_numpy(x) for x in xs])
    assert relerr(got, bst.batched_mv(J, xs)) < TOL


def test_batched_mv_fused_mirror(rng):
    """The fused (one-read mirror) path: a population whose panel plan has
    mirror=True in both packages."""
    J = [build_mirror(s) for s in (1, 2)]
    P_ = [port(A) for A in J]
    entry_j, entry = jb._stacked_panel_entry(J), pb._stacked_panel_entry(P_)
    assert entry_j is not None and entry_j[0].mirror
    assert entry is not None and entry[0].mirror
    check_mv(J, P_, rng.standard_normal((2, 1024)).astype(np.float32))


@pytest.mark.parametrize("build_fn", [build_sym, build_mirror],
                         ids=["symmetric", "fused mirror"])
def test_batched_mv_grad(build_fn, rng):
    J = [build_fn(s) for s in (1, 2)]
    P_ = [port(A) for A in J]
    xn = rng.standard_normal((2, J[0].shape[1])).astype(np.float32)
    xs = torch.from_numpy(xn).requires_grad_()
    (bt.batched_mv(P_, xs) ** 2).sum().backward()
    gj = np.asarray(jax.grad(
        lambda x: jnp.sum(bst.batched_mv(J, x) ** 2))(jnp.asarray(xn)))
    assert relerr(xs.grad, gj) < 1e-5
    for p, A in enumerate(J):
        S = bst.to_scipy(A)
        assert relerr(xs.grad[p], 2 * (S.T @ (S @ xn[p]))) < 5e-4


def test_batched_mv_fallback_mixed(rng):
    """Different structures -> per-operator loop, identical results."""
    d, di, o, ri, ci, shape = random_symmetric(
        10, n=640, ngroups=11, noffdiag=12, dtype=np.float32,
        contiguous=True)
    J = [build_sym(1), bst.SymmetricBlockMatrix(
        d, di, o, ri, ci, shape, backend="pallas-interpret")]
    P_ = [port(A) for A in J]
    assert jb._stacked_panel_entry(J) is None
    assert pb._stacked_panel_entry(P_) is None
    check_mv(J, P_, rng.standard_normal((2, 640)).astype(np.float32))


def _panel_pair(kind):
    """(JAX plan, port plan) for B6's plain-version checks."""
    from blocksparse_tpu.core import panel as jpanel
    from blocksparse_tpu_torch.core import panel

    if kind == "plain":
        J = build(4)
        return (jpanel.panel_plan_from_layout(J._layout),
                panel.panel_plan_from_layout(port(J).layout))
    if kind == "transposed":
        J = build_vbcrs(300)
        return (jpanel.panel_plan_from_layout(J._layout, transpose=True),
                panel.panel_plan_from_layout(port(J).layout, transpose=True))
    J = build_mirror(1)
    P_ = port(J)
    return (jpanel.panel_plan_symmetric(J._dlayout, J._olayout),
            panel.panel_plan_symmetric(P_._dlayout, P_._olayout))


@pytest.mark.parametrize("P", [2, 3])
@pytest.mark.parametrize("kind", ["plain", "transposed", "mirror"])
def test_b6_plain_vs_jax_interpret(kind, P, rng):
    """B6's plain version against ``_launch_batched`` in interpret mode:
    P value planes over one plan's tables (the plan's own values scaled
    per entry, so padding stays zero)."""
    jplan, plan = _panel_pair(kind)
    assert plan.mirror == jplan.mirror == (kind == "mirror")
    vals_b = (plan.vals[None] * rng.standard_normal(
        (P,) + plan.vals.shape)).astype(np.float32)
    xb = rng.standard_normal((P, plan.ncols)).astype(np.float32)
    shared = jpanel_k.panel_device_arrays(jplan)[1:]
    meta = (P, jplan.S, jplan.TS, jplan.CW, jplan.RW, jplan.n8p, jplan.nrows,
            jplan.ncols, jplan.NC32, jplan.mirror, tuple(jplan.grids_used))
    ref = np.asarray(jpanel_k._launch_batched(
        shared, jnp.asarray(vals_b), jnp.asarray(xb), meta=meta,
        interpret=True))
    tables = panel_spmv.panel_id_tables(plan, "cpu")
    got = panel_spmv.panel_spmv_batched(plan, tables, torch.from_numpy(vals_b),
                                        torch.from_numpy(xb))
    assert relerr(got, ref) < 1e-5
    for p in range(P):   # B6 duality with P single products of B5
        one = panel_spmv.panel_apply_plain(
            plan, (torch.from_numpy(vals_b[p]),) + tables,
            torch.from_numpy(xb[p]))
        assert relerr(got[p], one) < 1e-5


# -- the route decision ---------------------------------------------------------

def _jax_route(J, X, kind):
    """The JAX package's decision: kernel (True) or loop (False)."""
    eligible = (len(J) >= 2 and X.dtype == np.float32
                and all(type(A) is type(J[0]) for A in J)
                and all(np.dtype(A.dtype) == np.float32 for A in J)
                and all(getattr(A, "_backend", "xla") != "xla" for A in J))
    entry = jb._stacked_entry if kind == "mm" else jb._stacked_panel_entry
    return eligible and entry(J) is not None


def _port_route(P_, X, kind):
    entry = pb._stacked_entry if kind == "mm" else pb._stacked_panel_entry
    return pb._eligible(P_, X) and entry(P_) is not None


@pytest.mark.parametrize("case", [
    "general", "symmetric", "fused mirror", "vbcrs", "mixed structure",
    "P = 1", "f64 operators", "f64 operand", "mixed types"])
def test_route_decision_equals_jax(case, rng):
    if case == "symmetric":
        J = [build_sym(s) for s in (1, 2)]
    elif case == "fused mirror":
        J = [build_mirror(s) for s in (1, 2)]
    elif case == "vbcrs":
        J = [build_vbcrs(s) for s in (300, 301)]
    elif case == "mixed structure":
        J = [build(1, nblocks=10), build(2, nblocks=11)]
    elif case == "P = 1":
        J = [build(1)]
    elif case == "f64 operators":
        J = [build(s, dtype=np.float64) for s in (1, 2)]
    elif case == "mixed types":
        J = [build(1), build_vbcrs(300)]
    else:
        J = [build(s) for s in (1, 2)]
    P_ = [port(A) for A in J]
    dt = np.float64 if case == "f64 operand" else np.float32
    n = J[0].shape[1]
    for kind, shape in (("mm", (len(J), n, 8)), ("mv", (len(J), n))):
        X = rng.standard_normal(shape).astype(dt)
        route = _port_route(P_, torch.from_numpy(X), kind)
        assert route == _jax_route(J, X, kind), (case, kind)
        want = {("mm", "general"), ("mm", "vbcrs"), ("mv", "general"),
                ("mv", "symmetric"), ("mv", "fused mirror"), ("mv", "vbcrs")}
        assert route == ((kind, case) in want), (case, kind)


def test_cap_sends_the_batch_to_the_loop(monkeypatch, rng):
    """Above ``_BATCHED_PANEL_TILE_CAP`` both packages loop (the constant
    patched at run time in both modules)."""
    monkeypatch.setattr(jb, "_BATCHED_PANEL_TILE_CAP", 1)
    monkeypatch.setattr(pb, "_BATCHED_PANEL_TILE_CAP", 1)
    J = [build_vbcrs(s) for s in (310, 311)]
    P_ = [port(A) for A in J]
    assert jb._stacked_panel_entry(J) is None
    assert pb._stacked_panel_entry(P_) is None
    before = panel_spmv.BATCHED_LAUNCHES
    check_mv(J, P_, rng.standard_normal((2, 512)).astype(np.float32))
    assert panel_spmv.BATCHED_LAUNCHES == before
    assert pb._BATCHED_PANEL_TILE_CAP == 1
    assert pb._stacked_panel_entry(P_) is None       # cached decision


# -- caching, staging, counters ------------------------------------------------

def test_stack_cache_and_staged_panel_reuse(rng):
    J = [build_vbcrs(s) for s in (320, 321)]
    P_ = [port(A) for A in J]
    x = torch.from_numpy(rng.standard_normal(512).astype(np.float32))
    P_[0] @ x                                       # stages op 0's panel plan
    staged = P_[0]._staged_panel(False)
    assert staged is not None and P_[1]._staged_panel(False) is None
    plan, tables, vals_b = pb._stacked_panel_entry(P_)
    assert all(a is b for a, b in zip(tables, staged[1:]))
    assert torch.equal(vals_b[0], staged[0])
    assert torch.equal(vals_b[1], torch.from_numpy(P_[1]._panel_for(False).vals))
    assert pb._stacked_panel_entry(P_)[2] is vals_b   # cached
    assert pb._stacked_entry(P_)[1] is pb._stacked_entry(P_)[1]
    for seed in range(pb._STACK_CACHE_MAX):
        pb._stacked_entry([port(build(seed + 40))] * 2)
    assert ("mv",) + tuple(id(op) for op in P_) not in pb._STACK_CACHE
    assert len(pb._STACK_CACHE) == pb._STACK_CACHE_MAX


def test_wrappers_take_plain_on_cpu_and_count_no_launch(ops, rng):
    J, P_ = ops
    before = (batched_spmm.LAUNCHES, panel_spmv.BATCHED_LAUNCHES,
              panel_spmv.BATCHED_MIRROR_LAUNCHES)
    Xs = torch.from_numpy(rng.standard_normal((3, 512, 4)).astype(np.float32))
    _, vals, cc, rs = pb._stacked_entry(P_)
    assert torch.equal(batched_spmm.batched_spmm(vals, cc, rs, Xs, 512),
                       batched_spmm.batched_spmm_plain(vals, cc, rs, Xs, 512))
    bt.batched_mv(P_, Xs[..., 0].contiguous())
    assert (batched_spmm.LAUNCHES, panel_spmv.BATCHED_LAUNCHES,
            panel_spmv.BATCHED_MIRROR_LAUNCHES) == before
    with pytest.raises(ValueError, match=r"\[P=3, n, r\]"):
        batched_spmm.batched_spmm(vals, cc, rs, Xs[:2], 512)
    plan, tables, vals_b = pb._stacked_panel_entry(P_)
    with pytest.raises(ValueError, match="shape"):
        panel_spmv.panel_spmv_batched(plan, tables, vals_b, Xs[:, :-1, 0])
    with pytest.raises(ValueError, match="does not stack"):
        panel_spmv.panel_spmv_batched(plan, tables, vals_b[:2], Xs[..., 0])
