"""B9's colored element route on the CPU, held to the JAX package's colored
chain.

On the card a pass whose element buckets run a colored plan makes two
launches (three on the symmetric pass): the products pass writes every
(block, row) product into a scratch in the plan's flat order
(``csrc/owner_pass.cu``), then one launch of the rounds sums, per output
row, its color rounds' scratch rows in color order
(``csrc/colored_rounds.cu``).  Their plain version
(``mask_select.colored_products_plain`` / ``colored_rounds_plain``) is
those two passes in the same layout and order, and is what a CPU tensor
runs.  The same numpy blocks from a seed go into the JAX package (its
``xla_spmv.bucket_apply`` with the plan of its ``build_colored_plan``, and
its operators with ``schedule="colored"`` and ``BST_COLORED=always``) and
into the port (the colored plan forced where ``colored_wins`` would refuse
it at these sizes).  Tolerance ``tol * max(1, max|ref|)``: 1e-13 for
float64 and complex128, 1e-5 for float32 and complex64 and for bf16
storage with a float32 operand.

- (a) the order of the scratch: bit-equal in float64 to the concatenation
  of the per-bucket products that ``bucket_apply``'s colored chain builds;
- (b) the route against the JAX chain on the general and symmetric
  formats' layouts, forward, transpose, adjoint and the symmetric pass, r
  in {1, 3}, and the port's colored operators against the JAX ones; the
  variable-block format builds no colors in either package (its ranges are
  contiguous: chunked buckets), so its products never take the route;
- (c) the gradient against ``jax.grad``, and the route the backward takes;
- (d) a broken coloring gives a wrong product;
- (e) serial against colored for every dtype;
- the rounds' arithmetic, the plan's checks and gradcheck of the autograd.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import blocksparse_tpu as bst
from blocksparse_tpu.core.layout import build_layout as jax_build_layout
from blocksparse_tpu.ops import xla_spmv
from blocksparse_tpu.ops.colored import _plan_cached as jax_plan_cache
from blocksparse_tpu.ops.colored import build_colored_plan as jax_colored_plan

import blocksparse_tpu_torch as bt
from blocksparse_tpu_torch import coloring
from blocksparse_tpu_torch.core.layout import build_layout
from blocksparse_tpu_torch.ops import dispatch
from blocksparse_tpu_torch.ops.colored import build_colored_plan
from blocksparse_tpu_torch.ops.kernels import mask_select
from blocksparse_tpu_torch.ops.kernels.fused_spmm import BucketTable
from blocksparse_tpu_torch.ops.torch_spmv import (bucket_apply, gather_rows,
                                                  widened)
from blocksparse_tpu_torch.utils.testmatrices import random_symmetric

torch.set_num_threads(2)

TOL = {"float64": 1e-13, "complex128": 1e-13, "float32": 1e-5,
       "complex64": 1e-5, "bfloat16": 1e-5}
NP = {"float64": np.float64, "complex128": np.complex128,
      "float32": np.float32, "complex64": np.complex64,
      "bfloat16": np.float32}
# pass -> (transpose, symmetric, conj)
PASSES = {"forward": (False, False, False), "transpose": (True, False, False),
          "adjoint": (True, False, True), "symmetric": (False, True, False),
          "symmetric conj": (False, True, True)}


def relerr(a, b):
    a = np.asarray(a.detach().numpy() if isinstance(a, torch.Tensor) else a,
                   np.complex128)
    b = np.asarray(b, np.complex128)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(1.0, float(np.max(np.abs(b))) if b.size else 1.0)
    return float(np.max(np.abs(a - b))) / scale if a.size else 0.0


def values(rng, shape, dtype):
    v = rng.standard_normal(shape)
    if np.issubdtype(NP[dtype], np.complexfloating):
        v = v + 1j * rng.standard_normal(shape)
    v = v.astype(NP[dtype])
    if dtype == "bfloat16":  # values a bf16 holds exactly
        v = torch.from_numpy(v).bfloat16().float().numpy()
    return v


def lists(kind, seed=0, small=False):
    """(rows, cols, n): scattered index lists ("bsm"), or a symmetric
    format's off-diagonal ("symmetric") or diagonal ("diagonal") blocks;
    ``small``: fewer, smaller blocks (the gradchecks)."""
    rng = np.random.default_rng(seed)
    if kind in ("symmetric", "diagonal"):
        _, di, _, ri, ci, shape = random_symmetric(
            seed + 3, n=60 if small else 120, ngroups=3 if small else 6,
            noffdiag=4 if small else 10, dtype=np.float64)
        rows, cols = (di, di) if kind == "diagonal" else (ri, ci)
        return rows, cols, shape[0]
    n, rows, cols = (40, [], []) if small else (120, [], [])
    for _ in range(5 if small else 14):
        m, k = int(rng.integers(3, 7 if small else 12)), int(
            rng.integers(3, 7 if small else 12))
        rows.append(np.sort(rng.choice(n, m, replace=False)))
        cols.append(np.sort(rng.choice(n, k, replace=False)))
    return rows, cols, n


def layouts(kind, dtype, seed=0, small=False):
    """The port's and the JAX package's layouts of one fixture, from the
    same numpy blocks."""
    rows, cols, n = lists(kind, seed, small)
    rng = np.random.default_rng(seed + 1)
    blocks = [values(rng, (len(r), len(c)), dtype) for r, c in zip(rows, cols)]
    return (build_layout(blocks, rows, cols, (n, n)),
            jax_build_layout(blocks, rows, cols, (n, n), granularity="pow2"),
            n)


def element_ids(layout):
    return tuple(i for i, b in enumerate(layout.buckets) if b.chunk == 1)


def element_table(layout, dtype):
    t = torch.from_numpy
    stored = torch.bfloat16 if dtype == "bfloat16" else None
    return BucketTable([
        (t(np.ascontiguousarray(hb.values)).to(stored or
                                               t(hb.values).dtype),
         t(hb.row_idx), t(hb.col_idx), 1)
        for hb in (layout.buckets[i] for i in element_ids(layout))])


def colors_of(layout, transpose, symmetric):
    """DSATUR colors of the pass: row conflicts, column conflicts
    transposed, their union on the symmetric pass."""
    if symmetric:
        lists_ = [np.concatenate([r, c]) for r, c in
                  zip(layout.rowindices, layout.colindices)]
    else:
        lists_ = layout.colindices if transpose else layout.rowindices
    return tuple(tuple(int(b) for b in g)
                 for g in coloring.color_blocks(lists_))


def operand(rng, n, r, dtype):
    x = values(rng, (n, r), "complex128" if "complex" in dtype
               else "float64").astype(np.complex128 if "complex" in dtype
                                      else np.float64)
    x = x.astype(NP[dtype])
    return x[:, 0] if r == 1 else x


# -- (a) the order of the scratch ----------------------------------------------


@pytest.mark.parametrize("pass_", ["forward", "transpose", "symmetric"])
@pytest.mark.parametrize("kind", ["bsm", "symmetric"])
def test_scratch_order_is_the_chain_concatenation(kind, pass_):
    """The products pass's scratch is, bit for bit in float64, the
    concatenation of the per-bucket einsums of ``bucket_apply``'s colored
    chain (forward parts, then on the symmetric pass the mirror parts), and
    the rounds over it give the chain's product."""
    transpose, symmetric, _ = PASSES[pass_]
    lay, _, n = layouts(kind, "float64")
    table = element_table(lay, "float64")
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((n, 2)))
    P = mask_select.colored_products_plain(table, x, transpose=transpose,
                                           symmetric=symmetric)
    fwd, mirror = [], []
    for vals, ridx, cidx, _ in table.buckets:
        if transpose:
            fwd.append(torch.einsum("bmk,bmr->bkr", vals,
                                    gather_rows(x, ridx)))
        else:
            fwd.append(torch.einsum("bmk,bkr->bmr", vals,
                                    gather_rows(x, cidx)))
        if symmetric:
            mirror.append(torch.einsum("bmk,bmr->bkr", vals,
                                       gather_rows(x, ridx)))
    want = torch.cat([p.reshape(-1, 2) for p in fwd + mirror])
    assert torch.equal(P, want)
    plan = build_colored_plan(lay, colors_of(lay, transpose, symmetric), n,
                              transpose, element_ids(lay),
                              symmetric=symmetric, device="cpu")
    assert plan[1] == P.shape[0]
    got = mask_select.colored_apply(table, plan, x, out=x.new_zeros(n, 2),
                                    transpose=transpose, symmetric=symmetric)
    chain = bucket_apply([b[:3] for b in table.buckets], n, x,
                         transpose=transpose, symmetric=symmetric,
                         colored_plan=plan)
    assert relerr(got, chain) <= 1e-15


# -- (b) the route against the JAX chain ---------------------------------------


def jax_chain(jlay, colors, n, x, dtype, transpose, symmetric, conj):
    """The JAX element engine's colored chain on its own layout and plan."""
    sel = element_ids(jlay)
    jax_plan_cache.cache_clear()
    plan = jax_colored_plan(jlay, colors, n, transpose, sel,
                            symmetric=symmetric)
    assert plan is not None
    buckets = [(jnp.asarray(np.asarray(hb.values, NP[dtype])),
                jnp.asarray(hb.row_idx), jnp.asarray(hb.col_idx))
               for hb in (jlay.buckets[i] for i in sel)]
    return np.asarray(xla_spmv.bucket_apply(
        buckets, n, jnp.asarray(x), transpose=transpose, conj=conj,
        symmetric=symmetric, colored_plan=plan, precision="highest"))


@pytest.mark.parametrize("r", [1, 3])
@pytest.mark.parametrize("dtype", ["float64", "complex128", "float32",
                                   "bfloat16"])
@pytest.mark.parametrize("kind,pass_", [
    ("bsm", "forward"), ("bsm", "transpose"), ("bsm", "adjoint"),
    ("diagonal", "forward"), ("diagonal", "transpose"),
    ("diagonal", "adjoint"),
    ("symmetric", "symmetric"), ("symmetric", "symmetric conj")])
def test_route_matches_jax_chain(kind, pass_, dtype, r):
    """The port's colored route (plain versions, adding into an output that
    holds a partial sum) against the JAX package's colored chain, on the
    general format's element buckets and on the symmetric format's
    diagonal and off-diagonal (symmetric pass) ones."""
    transpose, symmetric, conj = PASSES[pass_]
    if conj and "complex" not in dtype:
        conj = False  # the adjoint of a real pass is its transpose
    lay, jlay, n = layouts(kind, dtype, seed=7)
    assert element_ids(lay) == element_ids(jlay) and element_ids(lay)
    table = element_table(lay, dtype)
    colors = colors_of(lay, transpose, symmetric)
    plan = build_colored_plan(lay, colors, n, transpose, element_ids(lay),
                              symmetric=symmetric, device="cpu")
    rng = np.random.default_rng(11)
    xdt = "float32" if dtype == "bfloat16" else dtype
    x, prior = operand(rng, n, r, xdt), operand(rng, n, r, xdt)
    got = mask_select.colored_apply(table, plan, torch.from_numpy(x),
                                    out=torch.from_numpy(prior.copy()),
                                    transpose=transpose, symmetric=symmetric,
                                    conj=conj)
    want = prior + jax_chain(jlay, colors, n, x, dtype, transpose, symmetric,
                             conj)
    assert relerr(got, want) <= TOL[dtype]


@pytest.fixture
def forced_colored(monkeypatch):
    """The colored plan wherever colors are given, in both packages: the
    JAX ``BST_COLORED=always``, the port's ``colored_wins`` made to hold."""
    monkeypatch.setenv("BST_COLORED", "always")
    monkeypatch.setattr(dispatch, "colored_wins", lambda *a: True)
    jax_plan_cache.cache_clear()
    yield
    jax_plan_cache.cache_clear()


def spy(monkeypatch, name):
    calls = []
    orig = getattr(mask_select, name)

    def wrapped(*a, **k):
        calls.append(k)
        return orig(*a, **k)
    monkeypatch.setattr(mask_select, name, wrapped)
    return calls


def scattered_operators(kind, dtype, schedule="colored", seed=21):
    """(port operator, JAX operator, dense float64 / complex128 matrix) from
    one seed: scattered lists, every bucket an element bucket; "bfloat16"
    stores the port's values in bf16 (the JAX operator keeps them in
    float32, exactly)."""
    rng = np.random.default_rng(seed)
    np_dt = NP[dtype]
    stored = {"dtype": torch.bfloat16} if dtype == "bfloat16" else {}
    if kind == "symmetric":
        d, di, o, ri, ci, shape = random_symmetric(
            seed, n=120, ngroups=6, noffdiag=10, dtype=np_dt)
        d = [b.astype(np_dt) for b in d]
        o = [b.astype(np_dt) for b in o]
        if dtype == "bfloat16":
            d, o = ([values(rng, b.shape, dtype) for b in bl] for bl in (d, o))
        P = bt.SymmetricBlockMatrix(d, di, o, ri, ci, shape, device="cpu",
                                    schedule=schedule, **stored)
        J = bst.SymmetricBlockMatrix(d, di, o, ri, ci, shape,
                                     schedule=schedule, backend="xla")
    else:
        rows, cols, n = lists("bsm", seed)
        blocks = [values(rng, (len(r), len(c)), dtype)
                  for r, c in zip(rows, cols)]
        P = bt.BlockSparseMatrix(blocks, rows, cols, (n, n), device="cpu",
                                 schedule=schedule, **stored)
        J = bst.BlockSparseMatrix(blocks, rows, cols, (n, n),
                                  schedule=schedule, backend="xla")
    return P, J, bt.to_scipy(P).toarray()


VIEWS = {"A @": lambda A: A, "A.T @": lambda A: A.T, "A.H @": lambda A: A.H}


@pytest.mark.parametrize("r", [1, 3])
@pytest.mark.parametrize("view", list(VIEWS))
@pytest.mark.parametrize("dtype", ["float64", "complex128", "float32"])
@pytest.mark.parametrize("kind", ["bsm", "symmetric"])
def test_colored_operators_match_jax(monkeypatch, forced_colored, kind, dtype,
                                     view, r):
    """The port's colored operators against the JAX package's with the
    colored plan forced; every pass with element buckets runs the colored
    route (one ``colored_apply`` per such pass) and no element pass."""
    P, J, dense = scattered_operators(kind, dtype)
    routed = spy(monkeypatch, "colored_apply_plain")
    elem = spy(monkeypatch, "element_apply_plain")
    x = operand(np.random.default_rng(4), P.shape[1], r, dtype)
    got = VIEWS[view](P) @ torch.from_numpy(x)
    want = np.asarray(VIEWS[view](J) @ jnp.asarray(x))
    assert relerr(got, want) <= TOL[dtype]
    mat = {"A @": dense, "A.T @": dense.T, "A.H @": dense.conj().T}[view]
    assert relerr(got, mat @ x) <= TOL[dtype]
    passes = 2 if kind == "symmetric" else 1
    assert len(routed) == passes and not elem
    if kind == "symmetric":
        assert [c["symmetric"] for c in routed] == [False, True]


def test_vbcrs_takes_no_colored_route(monkeypatch, forced_colored):
    """A variable-block operator under schedule="colored" builds no colors,
    as in the JAX package: no pass runs the colored route."""
    rng = np.random.default_rng(30)
    starts = np.arange(0, 160, 20)
    blocks = [rng.standard_normal((20, 20)) for _ in starts]
    V = bt.VariableBlockCompressedRowStorage(blocks, starts, starts[::-1],
                                             (160, 160), device="cpu",
                                             schedule="colored")
    routed = spy(monkeypatch, "colored_apply_plain")
    x = torch.from_numpy(rng.standard_normal(160))
    assert relerr(V @ x, bt.to_scipy(V) @ x.numpy()) <= TOL["float64"]
    assert not routed


# -- (c) the gradient ------------------------------------------------------------


@pytest.mark.parametrize("view", ["A @", "A.T @"])
@pytest.mark.parametrize("kind", ["bsm", "symmetric"])
def test_gradient_matches_jax_grad(monkeypatch, forced_colored, kind, view):
    """d(w . op(A) x)/dx through the colored route against ``jax.grad`` of
    the JAX operator's product; the backward runs the colored route of the
    other direction (the symmetric pass: its own plan)."""
    P, J, _ = scattered_operators(kind, "float64")
    rng = np.random.default_rng(8)
    x, w = (rng.standard_normal(P.shape[0]) for _ in range(2))
    xt = torch.from_numpy(x).requires_grad_()
    (torch.from_numpy(w) * (VIEWS[view](P) @ xt)).sum().backward()
    want = jax.grad(lambda v: jnp.sum(jnp.asarray(w)
                                      * (VIEWS[view](J) @ v)))(jnp.asarray(x))
    assert relerr(xt.grad, np.asarray(want)) <= TOL["float64"]
    routed = spy(monkeypatch, "colored_apply_plain")
    xt = torch.from_numpy(x).requires_grad_()
    y = VIEWS[view](P) @ xt
    forward = [(c["transpose"], c["symmetric"]) for c in routed]
    y.backward(torch.from_numpy(w))
    backward = [(c["transpose"], c["symmetric"])
                for c in routed[len(forward):]]
    # the diagonal (or general) pass transposed, the symmetric pass as it was
    assert sorted(backward) == sorted((not tr and not sym, sym)
                                      for tr, sym in forward)


def test_backward_without_a_plan_takes_the_element_pass(monkeypatch):
    """Where the transposed pass has no colored plan, x's cotangent runs the
    element pass in the transposed mode."""
    P, _, dense = scattered_operators("bsm", "float64")
    monkeypatch.setattr(dispatch, "colored_wins",
                        lambda ncolors, out_len, n: True)
    monkeypatch.setattr(dispatch, "element_plan", _plan_forward_only(
        dispatch.element_plan))
    elem = spy(monkeypatch, "element_apply_plain")
    x = torch.randn(P.shape[1], dtype=torch.float64, requires_grad=True)
    w = torch.randn(P.shape[0], dtype=torch.float64)
    (w * (P @ x)).sum().backward()
    assert [c["transpose"] for c in elem] == [True]
    assert relerr(x.grad, dense.T @ w.numpy()) <= TOL["float64"]


def _plan_forward_only(element_plan):
    def plan(*a, transpose, **k):
        return None if transpose else element_plan(*a, transpose=transpose,
                                                   **k)
    return plan


# -- (d) a broken coloring ---------------------------------------------------------


def test_broken_coloring_gives_a_wrong_product():
    """Two blocks sharing output rows forced into one color: one of them
    loses its table slots, and the colored route's product goes wrong."""
    rng = np.random.default_rng(3)
    n = 120
    blocks = [rng.standard_normal((8, 8)), rng.standard_normal((8, 8))]
    rows = [np.array([10, 12, 14, 16, 18, 20, 22, 24]),
            np.array([14, 16, 21, 30, 41, 52, 63, 74])]
    cols = [np.array([0, 3, 5, 7, 9, 11, 13, 15]),
            np.array([30, 33, 35, 37, 39, 41, 43, 45])]
    lay = build_layout(blocks, rows, cols, (n, n))
    table = element_table(lay, "float64")
    x = torch.from_numpy(rng.standard_normal(n))
    dense = np.zeros((n, n))
    for b, r, c in zip(blocks, rows, cols):
        dense[np.ix_(r, c)] += b
    for colors, ok in ((colors_of(lay, False, False), True), (((0, 1),), False)):
        plan = build_colored_plan(lay, colors, n, False, element_ids(lay),
                                  device="cpu")
        got = mask_select.colored_apply(table, plan, x, out=x.new_zeros(n))
        assert (relerr(got, dense @ x.numpy()) <= TOL["float64"]) == ok


# -- (e) serial against colored ------------------------------------------------


@pytest.mark.parametrize("dtype,operand_dtype", [
    ("float64", None), ("complex128", None), ("float32", None),
    ("complex64", None), ("bfloat16", None), ("float32", torch.float64),
    ("complex64", torch.complex128)])
@pytest.mark.parametrize("kind", ["bsm", "symmetric"])
def test_serial_vs_colored(monkeypatch, forced_colored, kind, dtype,
                           operand_dtype):
    """The serial schedule (element pass) and the colored one (colored
    route) give the same product, r = 3 and the transpose, in every stored
    dtype and with a wider operand."""
    Pc = scattered_operators(kind, dtype)[0]
    Ps = scattered_operators(kind, dtype, schedule="serial")[0]
    routed = spy(monkeypatch, "colored_apply_plain")
    compute = operand_dtype or (torch.float32 if dtype == "bfloat16"
                                else getattr(torch, dtype))
    X = torch.from_numpy(operand(np.random.default_rng(2), Pc.shape[1], 3,
                                 "complex128" if compute.is_complex
                                 else "float64")).to(compute)
    for view in (VIEWS["A @"], VIEWS["A.T @"]):
        got, ref = view(Pc) @ X, view(Ps) @ X
        assert got.dtype == ref.dtype == compute
        tol = TOL[str(compute).split(".")[1]]
        assert relerr(got, ref.numpy()) <= tol
    assert routed


# -- the rounds, the plan's checks, the autograd -----------------------------


def test_rounds_sum_in_color_order():
    """Each row's colors summed from zero in color order, the sentinel
    ``total`` (and rows that no color reaches) reading zero, then added
    into the output once: bit-equal to that loop."""
    rng = np.random.default_rng(6)
    total, out_len, ncolors = 50, 37, 64
    tables = rng.integers(0, total + 1, (ncolors, out_len)).astype(np.int32)
    tables[:, 5] = total                 # a row that no color reaches
    tables[rng.random(tables.shape) < 0.3] = total
    P = torch.from_numpy(rng.standard_normal((total, 3)).astype(np.float32))
    prior = torch.from_numpy(rng.standard_normal((out_len, 3)).astype(
        np.float32))
    got = mask_select.colored_rounds_plain((torch.from_numpy(tables), total),
                                           P, out=prior.clone())
    want = prior.clone()
    for i in range(out_len):
        acc = torch.zeros(3, dtype=torch.float32)
        for k in range(ncolors):
            if tables[k, i] < total:
                acc = acc + P[tables[k, i]]
            else:
                acc = acc + torch.zeros(3)
        want[i] += acc
    assert torch.equal(got, want)
    assert torch.equal(got[5], prior[5])


def test_one_color_and_vector_output():
    lay, _, n = layouts("bsm", "float64")
    table = element_table(lay, "float64")
    hb_rows = torch.cat([b[1].reshape(-1) for b in table.buckets])
    total = sum(v.shape[0] * v.shape[1] for v in table.values)
    # one color reaching each output row from its first contribution
    tab = np.full((1, n), total, np.int32)
    for f, row in enumerate(hb_rows.tolist()):
        if row < n and tab[0, row] == total:
            tab[0, row] = f
    x = torch.randn(n, dtype=torch.float64)
    P = mask_select.colored_products_plain(table, x)
    got = mask_select.colored_apply(table, (torch.from_numpy(tab), total), x,
                                    out=x.new_zeros(n))
    want = torch.where(torch.from_numpy(tab[0]) < total,
                       torch.cat([P[:, 0], P.new_zeros(1)])[
                           torch.from_numpy(tab[0]).long()], 0.0)
    assert got.shape == (n,) and torch.equal(got, want)


def test_plan_and_call_checks():
    lay, _, n = layouts("bsm", "float64")
    table = element_table(lay, "float64")
    colors = colors_of(lay, False, False)
    plan = build_colored_plan(lay, colors, n, False, element_ids(lay),
                              device="cpu")
    assert plan[0].dtype == torch.int32 and plan[0].shape == (len(colors), n)
    x = torch.zeros(n, dtype=torch.float64)
    with pytest.raises(ValueError, match="contribution rows"):
        mask_select.colored_apply(table, plan, x, out=x.new_zeros(n),
                                  transpose=True)
    with pytest.raises(ValueError, match="out_len"):
        mask_select.colored_apply(table, (plan[0][:, :-1], plan[1]), x,
                                  out=x.new_zeros(n))
    with pytest.raises(TypeError, match="int32"):
        mask_select.colored_apply(table, (plan[0].long(), plan[1]), x,
                                  out=x.new_zeros(n))
    with pytest.raises(ValueError, match="transpose-invariant"):
        mask_select.colored_apply(table, plan, x, out=x.new_zeros(n),
                                  transpose=True, symmetric=True)
    meta = BucketTable([(b[0].to("meta"), b[1].to("meta"), b[2].to("meta"),
                         1) for b in table.buckets])
    with pytest.raises(ValueError, match="no kernel for device"):
        mask_select.colored_apply(meta, (plan[0].to("meta"), plan[1]),
                                  x.to("meta"), out=x.new_zeros(n).to("meta"))


def test_scratch_offsets():
    lay, _, _ = layouts("symmetric", "float64")
    table = element_table(lay, "float64")
    fwd = [v.shape[0] * v.shape[1] for v in table.values]
    tr = [v.shape[0] * v.shape[2] for v in table.values]
    assert mask_select.scratch_offsets(table, False).tolist() == \
        np.cumsum([0] + fwd[:-1]).tolist()
    assert mask_select.scratch_offsets(table, True, sum(fwd)).tolist() == \
        np.cumsum([sum(fwd)] + tr[:-1]).tolist()
    assert mask_select.scratch_offsets(table, False) is \
        mask_select.scratch_offsets(table, False)


@pytest.mark.parametrize("pass_", ["forward", "transpose", "symmetric"])
def test_colored_fused_apply_gradcheck(pass_):
    transpose, symmetric, _ = PASSES[pass_]
    lay, _, n = layouts("symmetric" if symmetric else "bsm", "float64",
                        small=True)
    sel = element_ids(lay)
    plans = {tr: build_colored_plan(lay, colors_of(lay, tr, symmetric), n, tr,
                                    sel, symmetric=symmetric, device="cpu")
             for tr in (False, True)}
    t = torch.from_numpy
    vals = [t(np.ascontiguousarray(lay.buckets[i].values)).requires_grad_()
            for i in sel]
    x = torch.randn(n, 2, dtype=torch.float64, requires_grad=True)

    def fn(x_, *v):
        table = BucketTable([(vv, t(lay.buckets[i].row_idx),
                              t(lay.buckets[i].col_idx), 1)
                             for vv, i in zip(v, sel)])
        return mask_select.colored_fused_apply(
            table, plans[transpose], x_,
            out=torch.zeros(n, 2, dtype=torch.float64), transpose=transpose,
            symmetric=symmetric, adjoint_plan=lambda: plans[not transpose])
    assert torch.autograd.gradcheck(fn, (x, *vals))


def test_widened_values_in_the_scratch():
    """bf16 values with a float32 operand: the scratch is float32, the
    values widened exactly."""
    lay, _, n = layouts("bsm", "bfloat16")
    table = element_table(lay, "bfloat16")
    assert table.dtype == torch.bfloat16
    x = torch.randn(n, 2)
    P = mask_select.colored_products_plain(table, x)
    ref = mask_select.colored_products_plain(
        BucketTable([(widened(v, torch.float32).contiguous(), ri, ci, 1)
                     for v, ri, ci, _ in table.buckets]), x)
    assert P.dtype == torch.float32 and torch.equal(P, ref)


def test_one_read_workspace_tables():
    """The one-read products kernel's tables: each work item's bucket (an
    item: a stored block's 64-row tile, buckets in order), each bucket's
    first item and first stored block, and the workspace of tile partials,
    which only blocks of more than one tile use."""
    lay, _, _ = layouts("symmetric", "float64")
    table = element_table(lay, "float64")
    owner, ifirst, bstart, woff, w_elems = mask_select._r1_workspace(table)
    nbs = [v.shape[0] for v in table.values]
    tiles = [nb * -(-v.shape[1] // 64) for nb, v in zip(nbs, table.values)]
    assert owner.dtype == torch.int32 and owner.numel() == sum(tiles)
    assert ifirst.tolist() == np.cumsum([0] + tiles[:-1]).tolist()
    for q, first in enumerate(ifirst.tolist()):
        assert (owner[first:first + tiles[q]] == q).all()
    assert bstart.tolist() == np.cumsum([0] + nbs[:-1]).tolist()
    sizes = [t * v.shape[2] if v.shape[1] > 64 else 0
             for t, v in zip(tiles, table.values)]
    assert woff.tolist() == np.cumsum([0] + sizes[:-1]).tolist()
    assert w_elems == sum(sizes)
    assert mask_select._r1_workspace(table)[0] is owner
