"""The port's r = 1 patch route on the CPU: kernel B7's plain versions.

Kernel B7 (``ops/kernels/patch_spmv1.py``) replaces the JAX package's r = 1
patch kernels ``_kern1_f`` / ``_kern1_t`` / ``_kern1_m`` and the one-hot
gathers and scatters around them.  Here its per-slot contraction
``spmv1_plain`` is held against ``_spmv_kernel_raw`` in interpret mode,
the port's r = 1 ``patch_apply`` against ``patch_spmv_kernel`` (interpret
mode) where the JAX guard ``patch_kernel_ok`` holds and against the JAX
one-hot engine ``patch_spmv`` where it does not, and against scipy (1e-5
relative to max(1, max|ref|)); gradients in x against ``jax.grad`` of the
JAX call; the formats built with ``patch="always"`` against the JAX
operators under ``BST_PATCH=always`` (pallas-interpret); and ``patch_wins``
against the JAX decision under all three modes.  The CUDA kernel itself
runs only on a card (``chip_smoke.py`` phases 1 and 10).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import blocksparse_tpu as bst
from blocksparse_tpu.core.layout import build_layout as jax_build_layout
from blocksparse_tpu.core.patch import build_patch_plan as jax_build_patch_plan
from blocksparse_tpu.ops import dispatch as jdispatch
from blocksparse_tpu.ops import patch_engine as jpe
from blocksparse_tpu.utils import testmatrices as jtm

import blocksparse_tpu_torch as bt
from blocksparse_tpu_torch.core.layout import build_layout
from blocksparse_tpu_torch.core.patch import build_patch_plan
from blocksparse_tpu_torch.ops import dispatch, patch_engine
from blocksparse_tpu_torch.ops.kernels import patch_spmv1

torch.set_num_threads(2)

TOL = 1e-5


def relerr(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b))) / max(1.0, float(np.max(np.abs(b))))


def _wide(n=2048, seed=3):
    """Aligned 128 x 1024 blocks: canvases of 512 KB, so the plan's grid
    group is G = 1 (G % 8 != 0: the JAX package falls back to its one-hot
    engine, the port runs B7 all the same)."""
    rng = np.random.default_rng(seed)
    pos = rng.choice((n // 128) * (n // 1024), 6, replace=False)
    blocks = [rng.standard_normal((128, 1024)).astype(np.float32)
              for _ in pos]
    rows = [np.arange((p // 2) * 128, (p // 2) * 128 + 128) for p in pos]
    cols = [np.arange((p % 2) * 1024, (p % 2) * 1024 + 1024) for p in pos]
    return blocks, rows, cols, (n, n)


def _rect(seed=2, m=256, n=384):
    rng = np.random.default_rng(seed)
    blocks, rows, cols = [], [], []
    for _ in range(12):
        h, w = int(rng.integers(1, 80)), int(rng.integers(1, 80))
        r0, c0 = int(rng.integers(0, m - h)), int(rng.integers(0, n - w))
        blocks.append(rng.standard_normal((h, w)).astype(np.float32))
        rows.append(np.arange(r0, r0 + h))
        cols.append(np.arange(c0, c0 + w))
    return blocks, rows, cols, (m, n)


GENERAL = {
    "contiguous": lambda: jtm.random_block_sparse(
        11, shape=(300, 300), nblocks=12, max_block=48, dtype=np.float32,
        contiguous=True),
    "rectangular": _rect,
    "wide blocks, G = 1": _wide,
}


@functools.lru_cache(maxsize=None)
def general_plans(kind):
    """(port plan, jax plan, blocks, rows, cols, shape)."""
    blocks, rows, cols, shape = GENERAL[kind]()
    mine = build_patch_plan(build_layout(blocks, rows, cols, shape))
    ref = jax_build_patch_plan(jax_build_layout(blocks, rows, cols, shape,
                                                granularity="pow2"))
    return mine, ref, blocks, rows, cols, shape


@functools.lru_cache(maxsize=None)
def symmetric_fixture():
    return jtm.random_symmetric(3, n=256, ngroups=6, noffdiag=8,
                                dtype=np.float32, contiguous=True)


def _vbcrs():
    return jtm.random_vbcrs(15, shape=(320, 320), nrowgroups=8,
                            ncolgroups=8, fill=0.3, dtype=np.float32)


@functools.lru_cache(maxsize=None)
def symmetric_plans(transpose_main):
    d, di, o, ri, ci, shape = symmetric_fixture()
    mine = build_patch_plan(build_layout(d, di, di, shape),
                            extra_layout=build_layout(o, ri, ci, shape),
                            transpose_main=transpose_main)
    ref = jax_build_patch_plan(
        jax_build_layout(d, di, di, shape, granularity="pow2"),
        extra_layout=jax_build_layout(o, ri, ci, shape, granularity="pow2"),
        transpose_main=transpose_main)
    return mine, ref, shape


# -- the per-slot contractions ----------------------------------------------------

@pytest.mark.parametrize("mode", ["f", "t", "m"])
def test_spmv1_plain_matches_kernel_raw(mode):
    mine, ref, *_ = general_plans("contiguous")
    b = ref.buckets[0]
    rng = np.random.default_rng(21)
    xg = rng.standard_normal((b.nb, b.KP)).astype(np.float32)
    xr = rng.standard_normal((b.nb, b.MP)).astype(np.float32)
    want = jpe._spmv_kernel_raw((mode, b.G, b.MP, b.KP), jnp.asarray(b.vals),
                                jnp.asarray(xg), jnp.asarray(xr), True)
    got = patch_spmv1.spmv1_plain(torch.from_numpy(mine.buckets[0].vals),
                                  torch.from_numpy(xg), torch.from_numpy(xr),
                                  mode)
    if mode != "m":
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        assert relerr(g, w) <= TOL


# -- the product ----------------------------------------------------------------------

def _jax_spmv(ref, x, transpose):
    """The JAX r = 1 product as its ``patch_apply`` routes it on a kernel
    path: the Pallas kernel where ``patch_kernel_ok``, else the one-hot
    engine."""
    dev = jpe.patch_device_arrays(ref)
    if jpe.patch_kernel_ok(ref):
        return jpe.patch_spmv_kernel(ref, dev, x, transpose=transpose,
                                     interpret=True)
    return jpe.patch_spmv(ref, dev, x, transpose=transpose)


CASES = [("contiguous", False), ("contiguous", True), ("rectangular", False),
         ("rectangular", True), ("wide blocks, G = 1", False),
         ("wide blocks, G = 1", True)]


@pytest.mark.parametrize("kind,transpose", CASES)
def test_patch_apply_vector_matches_jax(kind, transpose):
    mine, ref, blocks, rows, cols, shape = general_plans(kind)
    assert jpe.patch_kernel_ok(ref) == (kind != "wide blocks, G = 1")
    n_in = shape[0] if transpose else shape[1]
    x = np.random.default_rng(22).standard_normal(n_in).astype(np.float32)
    dev = patch_engine.patch_device_arrays(mine, "cpu")
    got = patch_engine.patch_apply(mine, dev, torch.from_numpy(x),
                                   transpose=transpose)
    assert relerr(got, _jax_spmv(ref, jnp.asarray(x), transpose)) <= TOL
    S = bst.to_scipy(bst.BlockSparseMatrix(
        [b.astype(np.float64) for b in blocks], rows, cols, shape,
        backend="xla"))
    assert relerr(got, (S.T if transpose else S) @ x.astype(np.float64)) <= TOL
    assert torch.equal(got, patch_engine.patch_spmv_plain(
        mine, dev, torch.from_numpy(x), transpose=transpose))
    assert patch_spmv1.LAUNCHES == 0   # CPU tensors never launch


@pytest.mark.parametrize("transpose_main", [False, True])
def test_patch_apply_symmetric_matches_jax(transpose_main):
    mine, ref, shape = symmetric_plans(transpose_main)
    assert mine.symmetric and ref.buckets[0].G % 8 == 0
    x = np.random.default_rng(23).standard_normal(shape[0]).astype(np.float32)
    dev = patch_engine.patch_device_arrays(mine, "cpu")
    got = patch_engine.patch_apply(mine, dev, torch.from_numpy(x))
    assert relerr(got, _jax_spmv(ref, jnp.asarray(x), False)) <= TOL
    assert relerr(got, jpe.patch_spmv(ref, jpe.patch_device_arrays(ref),
                                      jnp.asarray(x))) <= TOL
    d, di, o, ri, ci, _ = symmetric_fixture()
    S = bst.to_scipy(bst.SymmetricBlockMatrix(d, di, o, ri, ci, shape,
                                              backend="xla"))
    S = (S.T if transpose_main else S).astype(np.float64)
    assert relerr(got, S @ x.astype(np.float64)) <= TOL
    with pytest.raises(ValueError, match="transpose_main"):
        patch_engine.patch_apply(mine, dev, torch.from_numpy(x),
                                 transpose=True)


def test_adjoint_mode_is_the_transposed_plan():
    """Mode a on the plan for S equals the plan for S^T (mode m), the
    identity B7's backward relies on."""
    plan_n, _, shape = symmetric_plans(False)
    plan_t, _, _ = symmetric_plans(True)
    x = torch.from_numpy(np.random.default_rng(24).standard_normal(shape[0]))
    vals, cc, rs, mk = patch_engine.patch_device_arrays(plan_n, "cpu")[0]
    adj = patch_spmv1.patch_spmv1(vals.double(), cc, rs, mk, x, shape[0], "a")
    dev_t = [(v.double(), c, r, m) for v, c, r, m in
             patch_engine.patch_device_arrays(plan_t, "cpu")]
    assert relerr(adj, patch_engine.patch_spmv_plain(plan_t, dev_t, x)) <= 1e-13


# -- gradients -------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["contiguous", "contiguous T", "rectangular T",
                                  "symmetric", "symmetric T"])
def test_gradient_in_x_matches_jax(case):
    transpose = case.endswith(" T")
    if case.startswith("symmetric"):
        mine, ref, shape = symmetric_plans(transpose)
        transpose, n_in, n_out = False, shape[0], shape[0]
    else:
        mine, ref, *_, shape = general_plans(case.split()[0])
        n_out, n_in = shape[::-1] if transpose else shape
    rng = np.random.default_rng(25)
    x = rng.standard_normal(n_in).astype(np.float32)
    w = rng.standard_normal(n_out).astype(np.float32)
    want = jax.grad(lambda v: jnp.sum(jnp.asarray(w) * _jax_spmv(
        ref, v, transpose)))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    dev = patch_engine.patch_device_arrays(mine, "cpu")
    (torch.from_numpy(w) * patch_engine.patch_apply(
        mine, dev, xt, transpose=transpose)).sum().backward()
    assert relerr(xt.grad, want) <= TOL


@pytest.mark.parametrize("mode", ["f", "t", "m", "a"])
def test_gradient_in_vals_is_exact(mode):
    """d<w, B7(V, x)>/dV from the autograd Function against the plain
    version's own autograd, in float64."""
    plan, *_ = symmetric_plans(False)
    vals, cc, rs, mk = patch_engine.patch_device_arrays(plan, "cpu")[0]
    n = plan.nrows
    rng = np.random.default_rng(26)
    x = torch.from_numpy(rng.standard_normal(n))
    w = torch.from_numpy(rng.standard_normal(n))
    v1 = vals.double().requires_grad_()
    (w * patch_spmv1.patch_spmv1_apply(v1, cc, rs, mk, x, n, mode)).sum() \
        .backward()
    v2 = vals.double().requires_grad_()
    (w * patch_spmv1.patch_spmv1_plain(v2, cc, rs, mk, x, n, mode)).sum() \
        .backward()
    assert relerr(v1.grad, v2.grad) <= 1e-13


# -- the route through the formats -----------------------------------------------------

def _jax_always(monkeypatch, make):
    monkeypatch.setenv("BST_PATCH", "always")
    return make()


@pytest.mark.parametrize("kind", ["contiguous", "rectangular"])
def test_bsm_patch_always_matches_jax(monkeypatch, kind):
    *_, blocks, rows, cols, shape = general_plans(kind)
    A = bt.BlockSparseMatrix(blocks, rows, cols, shape, patch="always",
                             device="cpu")
    J = _jax_always(monkeypatch, lambda: bst.BlockSparseMatrix(
        blocks, rows, cols, shape, backend="pallas-interpret"))
    calls = _count_patch_apply(monkeypatch)
    rng = np.random.default_rng(27)
    for tr in (False, True):
        x = rng.standard_normal(shape[0] if tr else shape[1]).astype(
            np.float32)
        got = (A.T if tr else A) @ torch.from_numpy(x)
        assert relerr(got, np.asarray((J.T if tr else J) @ jnp.asarray(x))) \
            <= TOL
    assert calls == [1, 1]   # both r = 1 products took the patch route
    assert A.patch == "always" and "patch='always'" in repr(A)


def test_vbcrs_patch_always_matches_jax(monkeypatch):
    blocks, rs, cs, shape = _vbcrs()
    V = bt.VariableBlockCompressedRowStorage(blocks, rs, cs, shape,
                                             patch="always", device="cpu")
    J = _jax_always(monkeypatch, lambda: bst.VariableBlockCompressedRowStorage(
        blocks, rs, cs, shape, backend="pallas-interpret"))
    calls = _count_patch_apply(monkeypatch)
    rng = np.random.default_rng(28)
    for tr in (False, True):
        x = rng.standard_normal(shape[0] if tr else shape[1]).astype(
            np.float32)
        got = (V.T if tr else V) @ torch.from_numpy(x)
        want = (J.T if tr else J) @ jnp.asarray(x)
        assert relerr(got, np.asarray(want)) <= TOL
    assert calls == [1, 1]


def test_symmetric_patch_always_matches_jax(monkeypatch):
    d, di, o, ri, ci, shape = symmetric_fixture()
    Sp = bt.SymmetricBlockMatrix(d, di, o, ri, ci, shape, patch="always",
                                 device="cpu")
    J = _jax_always(monkeypatch, lambda: bst.SymmetricBlockMatrix(
        d, di, o, ri, ci, shape, backend="pallas-interpret"))
    Ssc = bst.to_scipy(J).astype(np.float64)
    calls = _count_patch_apply(monkeypatch)
    x = np.random.default_rng(29).standard_normal(shape[0]).astype(np.float32)
    for tr in (False, True):
        got = (Sp.T if tr else Sp) @ torch.from_numpy(x)
        assert relerr(got, np.asarray((J.T if tr else J) @ jnp.asarray(x))) \
            <= TOL
        assert relerr(got, (Ssc.T if tr else Ssc) @ x) <= TOL
    assert calls == [1, 1]


def test_from_reference_takes_patch_option(monkeypatch):
    *_, blocks, rows, cols, shape = general_plans("contiguous")
    J = _jax_always(monkeypatch, lambda: bst.BlockSparseMatrix(
        blocks, rows, cols, shape, backend="pallas-interpret"))
    A = bt.from_reference(J, patch="always", device="cpu")
    calls = _count_patch_apply(monkeypatch)
    x = np.random.default_rng(30).standard_normal(shape[1]).astype(np.float32)
    assert relerr(A @ torch.from_numpy(x), np.asarray(J @ jnp.asarray(x))) \
        <= TOL
    assert calls == [1] and A.patch == "always"


def _count_patch_apply(monkeypatch):
    """Record, per product, how often the formats reached the port's
    ``patch_apply`` (the formats import it at each product)."""
    calls = []
    real = patch_engine.patch_apply

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(patch_engine, "patch_apply", counted)
    return calls


@pytest.mark.parametrize("mode", ["auto", "never"])
def test_patch_modes_route_r64_as_jax(monkeypatch, mode):
    """r = 64 takes the patch route (B2) exactly where the JAX package's
    mode does; "never" keeps it off."""
    *_, blocks, rows, cols, shape = general_plans("contiguous")
    A = bt.BlockSparseMatrix(blocks, rows, cols, shape, patch=mode,
                             device="cpu")
    monkeypatch.setenv("BST_PATCH", mode)
    J = bst.BlockSparseMatrix(blocks, rows, cols, shape,
                              backend="pallas-interpret")
    X = np.random.default_rng(31).standard_normal((shape[1], 64)).astype(
        np.float32)
    jcalls = []
    jreal = jpe.patch_apply
    monkeypatch.setattr(jpe, "patch_apply",
                        lambda *a, **k: jcalls.append(1) or jreal(*a, **k))
    calls = _count_patch_apply(monkeypatch)
    got = A @ torch.from_numpy(X)
    want = J @ jnp.asarray(X)
    assert relerr(got, np.asarray(want)) <= TOL
    assert len(calls) == len(jcalls) == (mode == "auto")


# -- the decision -------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["auto", "always", "never"])
@pytest.mark.parametrize("r", [1, 64, 300])
def test_patch_wins_matches_jax(monkeypatch, mode, r):
    monkeypatch.setenv("BST_PATCH", mode)
    *_, blocks, rows, cols, shape = general_plans("contiguous")
    pl_ = build_layout(blocks, rows, cols, shape)
    jl = jax_build_layout(blocks, rows, cols, shape, granularity="pow2")
    mine, ref = general_plans("contiguous")[:2]
    assert dispatch.patch_wins(mine, [(pl_, 1)], r, mode) == \
        jdispatch.patch_wins(ref, [(jl, 1)], r)
    (pd, po), (jd, jo) = _symmetric_layouts()
    smine, sref, _ = symmetric_plans(False)
    assert dispatch.patch_wins(smine, [(pd, 1), (po, 2)], r, mode) == \
        jdispatch.patch_wins(sref, [(jd, 1), (jo, 2)], r)


def _symmetric_layouts():
    d, di, o, ri, ci, shape = symmetric_fixture()
    return ((build_layout(d, di, di, shape), build_layout(o, ri, ci, shape)),
            (jax_build_layout(d, di, di, shape, granularity="pow2"),
             jax_build_layout(o, ri, ci, shape, granularity="pow2")))


@pytest.mark.parametrize("mode", ["auto", "always", "never"])
def test_patch_eligible(mode):
    v, m = torch.zeros(4), torch.zeros(4, 2)
    assert dispatch.patch_eligible(m, torch.float32, mode) == (mode != "never")
    assert dispatch.patch_eligible(v, torch.float32, mode) == (mode == "always")
    assert not dispatch.patch_eligible(m, torch.float64, mode)


# -- bad values ----------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [{"patch": "sometimes"}, {"patch": None},
                                {"panel": "v3"}, {"panel": 2}])
def test_unknown_route_options_raise(kw):
    *_, blocks, rows, cols, shape = general_plans("contiguous")
    key = next(iter(kw))
    with pytest.raises(ValueError, match=key):
        bt.BlockSparseMatrix(blocks, rows, cols, shape, device="cpu", **kw)
    d, di, o, ri, ci, sshape = symmetric_fixture()
    with pytest.raises(ValueError, match=key):
        bt.SymmetricBlockMatrix(d, di, o, ri, ci, sshape, device="cpu", **kw)
    vb, vr, vc, vshape = _vbcrs()
    with pytest.raises(ValueError, match=key):
        bt.VariableBlockCompressedRowStorage(vb, vr, vc, vshape,
                                             device="cpu", **kw)


def test_unknown_kernel_mode_raises():
    plan, *_ = general_plans("contiguous")
    vals, cc, rs, mk = patch_engine.patch_device_arrays(plan, "cpu")[0]
    with pytest.raises(ValueError, match="mode"):
        patch_spmv1.patch_spmv1(vals, cc, rs, mk, torch.zeros(300), 300, "x")
    with pytest.raises(ValueError, match="mk"):
        patch_spmv1.patch_spmv1(vals, cc, rs, None, torch.zeros(300), 300,
                                "m")
