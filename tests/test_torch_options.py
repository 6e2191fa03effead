"""Constructor options and dtype rules of the port on the CPU, held to the
JAX package.

The same numpy blocks from a seed go into the JAX package's operators
(``backend="xla"``, x64) and the port's (``device="cpu"``: the plain
versions of B1 and B9's element pass and owner mode, which on the card run
their mixed instances).  Tolerances are the JAX tests': 1e-13 relative to
max(1, max|ref|) for results in f64 / c128 (mixed pairs included), 1e-6
for results in f32 / c64, 2e-2 for
bf16 against the JAX package (whose Pallas path rounds x to bf16) and
1e-6 against the port's own f32 operator over the bf16-rounded values.

- mixed and integer operands: the JAX package's promotion table over the
  three formats x {@, .T, .H} x r in {1, 5}, result dtypes and values
  (``tests/test_dtypes.py::test_mixed_dtype_promotion``), and x's gradient
  against dense autograd;
- bf16 storage (``test_dtypes.py::test_bf16_storage``), its layout byte-equal
  to the JAX layout, and bf16 blocks given as torch tensors or ml_dtypes
  arrays;
- ``scatter="sorted"`` (``tests/test_scatter_modes.py``): equal to the
  atomic pass, the owner tables against the JAX ``_sorted_scatter_info``,
  and the same bits from two calls;
- ``schedule="auto"``: the colored product, and the JAX "auto" product;
- ``backend=`` / ``optimize=``: every JAX value is taken and stored, and the
  route does not change;
- ``__all__`` covers the JAX package's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import blocksparse_tpu as bst
import blocksparse_tpu_torch as bt
from blocksparse_tpu.ops.dispatch import _sorted_scatter_info
from blocksparse_tpu_torch.formats import stream as stream_format
from blocksparse_tpu_torch.ops import dispatch, patch_engine
from blocksparse_tpu_torch.ops.kernels import fused_spmm, mask_select
from blocksparse_tpu_torch.utils.testmatrices import (random_block_sparse,
                                                      random_symmetric,
                                                      random_vbcrs)

torch.set_num_threads(2)

TOL64, TOL32, TOL16 = 1e-13, 1e-6, 2e-2
FORMATS = ("general", "general-contiguous", "symmetric", "vbcrs")
# (operator dtype, operand dtype): the JAX package's promotion table
PAIRS = [("float32", "float64"), ("float32", "int64"), ("float32", "int32"),
         ("float32", "float16"), ("float32", "complex128"),
         ("complex64", "float32"), ("complex64", "float64"),
         ("bfloat16", "float32")]
# results computed in these from exact values agree with the JAX package
# to float64 rounding
WIDE = (torch.float64, torch.complex128)
MODES = {"@": {}, ".T": {"transpose": True},
         ".H": {"transpose": True, "conj": True}}


def relerr(a, b):
    a = np.asarray(a, dtype=np.complex128)
    b = np.asarray(b, dtype=np.complex128)
    assert a.shape == b.shape, (a.shape, b.shape)
    if not b.size:
        return 0.0
    return float(np.max(np.abs(a - b))) / max(1.0, float(np.max(np.abs(b))))


def population(fmt, np_dtype, seed=5):
    """Construction arguments of a small operator of ``fmt``."""
    if fmt.startswith("general"):
        return random_block_sparse(seed, shape=(150, 130), nblocks=16,
                                   max_block=24, dtype=np_dtype,
                                   contiguous=fmt.endswith("contiguous"))
    if fmt == "symmetric":
        return random_symmetric(seed, n=140, ngroups=8, noffdiag=10,
                                dtype=np_dtype)
    return random_vbcrs(seed, shape=(150, 130), nrowgroups=6, ncolgroups=5,
                        dtype=np_dtype)


def build(lib, fmt, args, **kw):
    cls = {"symmetric": "SymmetricBlockMatrix",
           "vbcrs": "VariableBlockCompressedRowStorage"}.get(
               fmt, "BlockSparseMatrix")
    if lib is bt:
        kw.setdefault("device", "cpu")
    else:
        kw.setdefault("backend", "xla")
    return getattr(lib, cls)(*args, **kw)


def operand(rng, np_dtype, *shape):
    dt = np.dtype(np_dtype)
    if dt.kind in "iu":
        return rng.integers(-5, 6, size=shape).astype(dt)
    if dt.kind == "c":
        return (rng.standard_normal(shape)
                + 1j * rng.standard_normal(shape)).astype(dt)
    return rng.standard_normal(shape).astype(dt)


def rounded_bf16(blocks):
    """The blocks rounded to bf16, as exact float32 numpy."""
    return [torch.from_numpy(np.asarray(b, np.float32)).to(torch.bfloat16)
            .float().numpy() for b in blocks]


def rounded_args(fmt, args):
    if fmt == "symmetric":
        d, di, o, ri, ci, shape = args
        return (rounded_bf16(d), di, rounded_bf16(o), ri, ci, shape)
    blocks, *rest = args
    return (rounded_bf16(blocks), *rest)


def mixed_operators(fmt, op_dtype):
    """(port operator, JAX operator or None, port float32 operator over
    the same values or None): bf16 operators of the symmetric format have
    no JAX counterpart here (the JAX table covers BSM and VBCRS)."""
    if op_dtype == "bfloat16":
        args = population(fmt, np.float32)
        port = build(bt, fmt, args, dtype=torch.bfloat16)
        ref32 = build(bt, fmt, rounded_args(fmt, args))
        jax_op = (None if fmt == "symmetric"
                  else build(bst, fmt, args, dtype=jnp.bfloat16))
        return port, jax_op, ref32
    args = population(fmt, np.dtype(op_dtype))
    return build(bt, fmt, args), build(bst, fmt, args), None


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("op_dtype,x_dtype", PAIRS)
def test_mixed_dtype_promotion(fmt, op_dtype, x_dtype):
    """Every product of an operator of ``op_dtype`` with an operand of
    ``x_dtype`` comes out in ``torch.promote_types`` of the two, the JAX
    package's result dtype, with the JAX package's values."""
    port, jax_op, ref32 = mixed_operators(fmt, op_dtype)
    rng = np.random.default_rng(11)
    want_dtype = torch.promote_types(port.dtype,
                                     torch.from_numpy(np.zeros(1, x_dtype)).dtype)
    assert port.dtype == (torch.bfloat16 if op_dtype == "bfloat16"
                          else getattr(torch, op_dtype))
    for label, kw in MODES.items():
        n_in = port.shape[0] if kw else port.shape[1]
        for r in (1, 5):
            x = operand(rng, x_dtype, *((n_in,) if r == 1 else (n_in, r)))
            got = port.apply(torch.from_numpy(x), **kw)
            assert got.dtype == want_dtype, (label, r, got.dtype)
            assert got.shape == ((port.shape[1] if kw else port.shape[0]),
                                 *x.shape[1:])
            if jax_op is not None:
                jop = {"@": jax_op, ".T": jax_op.T, ".H": jax_op.H}[label]
                want = np.asarray(jop @ jnp.asarray(x))
                assert str(want.dtype) == str(got.dtype).split(".")[1]
                tol = (TOL16 if op_dtype == "bfloat16" else TOL64
                       if want_dtype in WIDE else TOL32)
                assert relerr(got.numpy(), want) < tol, (label, r)
            if ref32 is not None:
                want = ref32.apply(torch.from_numpy(x.astype(np.float32)),
                                   **kw)
                assert relerr(got.numpy(), want.numpy()) < TOL32, (label, r)


GRAD_PAIRS = [p for p in PAIRS if np.dtype(p[1]).kind in "fc"]


def dense(op) -> np.ndarray:
    """``op`` as a dense complex128 array, duplicates summed in complex128
    (overlapping f32 blocks summed in f32 would round)."""
    r, c, v = bt.rowcolvals(op)
    d = np.zeros(op.shape, np.complex128)
    np.add.at(d, (r, c), np.asarray(v, np.complex128))
    return d


@pytest.mark.parametrize("fmt", ("general", "symmetric", "vbcrs"))
@pytest.mark.parametrize("op_dtype,x_dtype", GRAD_PAIRS)
def test_operand_gradient_matches_dense_autograd(fmt, op_dtype, x_dtype):
    """x's cotangent of a mixed product comes back in x's dtype and equals
    the cotangent through the dense operator in the result dtype."""
    port, _, ref32 = mixed_operators(fmt, op_dtype)
    D = dense(ref32 if ref32 is not None else port)
    D = D if port.dtype.is_complex else D.real.copy()
    rng = np.random.default_rng(12)
    for label, kw in MODES.items():
        n_in = port.shape[0] if kw else port.shape[1]
        x0 = torch.from_numpy(operand(rng, x_dtype, n_in, 3))
        y0 = port.apply(x0, **kw)
        w = torch.from_numpy(operand(rng, "complex128" if y0.is_complex()
                                     else "float64", *y0.shape)).to(y0.dtype)
        x1 = x0.clone().requires_grad_()
        (port.apply(x1, **kw) * w).sum().real.backward()
        M = torch.from_numpy(D).to(y0.dtype)
        if kw.get("transpose"):
            M = M.T
        if kw.get("conj"):
            M = M.conj()
        x2 = x0.clone().requires_grad_()
        (M @ x2.to(y0.dtype) * w).sum().real.backward()
        assert x1.grad.dtype == x0.dtype
        tol = (2e-3 if x_dtype == "float16" else TOL64
               if y0.dtype in WIDE else TOL32)
        assert relerr(x1.grad.numpy(), x2.grad.numpy()) < tol, label


def test_composites_and_axpby_promote():
    """``axpby``, scaled, summed and composed operators and the batched
    products come out in the promoted dtype."""
    args = population("general", np.float32)
    A = build(bt, "general", args)
    S = bt.to_scipy(A).astype(np.float64)
    rng = np.random.default_rng(14)
    x = operand(rng, "float64", A.shape[1])
    y = operand(rng, "float64", A.shape[0])
    t = torch.from_numpy
    got = A.axpby(t(x), t(y), 2.0, 3.0)
    assert got.dtype == torch.float64
    assert relerr(got.numpy(), 2 * (S @ x) + 3 * y) < TOL32
    for op, ref in ((2.5 * A, 2.5 * S), (A + A, 2 * S),
                    (A.T @ A, S.T @ S)):
        got = op @ t(x)
        assert got.dtype == torch.float64
        assert relerr(got.numpy(), ref @ x) < TOL32
    xi = operand(rng, "int64", A.shape[1], 2)
    got = bt.batched_mm([A, A], t(np.stack([xi, 2 * xi])))
    assert got.dtype == torch.float32
    assert relerr(got[1].numpy(), S @ (2 * xi)) < TOL32


def test_bf16_storage():
    """``tests/test_dtypes.py::test_bf16_storage``: bf16 blocks (torch bf16
    tensors) and ``dtype=torch.bfloat16``; an f32 operand gives f32 within
    2e-2 of the f64 operator."""
    blocks, rstarts, cstarts, shape = random_vbcrs(
        102, shape=(256, 256), nrowgroups=4, ncolgroups=4, dtype=np.float64)
    b16 = [torch.from_numpy(b).to(torch.bfloat16) for b in blocks]
    V = bt.VariableBlockCompressedRowStorage(b16, rstarts, cstarts, shape,
                                             dtype=torch.bfloat16,
                                             device="cpu")
    assert V.dtype == torch.bfloat16
    Vref = bt.VariableBlockCompressedRowStorage(blocks, rstarts, cstarts,
                                                shape, device="cpu")
    x = np.random.default_rng(15).standard_normal(256).astype(np.float32)
    got = V @ torch.from_numpy(x)
    assert got.dtype == torch.float32
    assert relerr(got.numpy(), (Vref @ torch.from_numpy(x)).numpy()) < TOL16
    Vj = bst.VariableBlockCompressedRowStorage(
        [jnp.asarray(b, dtype=jnp.bfloat16) for b in blocks], rstarts,
        cstarts, shape, dtype=jnp.bfloat16)
    assert relerr(got.numpy(), np.asarray(Vj @ jnp.asarray(x))) < TOL16


@pytest.mark.parametrize("fmt", ("general", "general-contiguous", "vbcrs"))
@pytest.mark.parametrize("given", ["dtype", "torch", "ml_dtypes", "string"])
def test_bf16_layout_matches_the_jax_layout(fmt, given):
    """The staged bf16 values equal the JAX layout's bits and every index
    table is byte-equal, however the bf16 is given."""
    args = population(fmt, np.float64)
    blocks, *rest = args
    jax_op = build(bst, fmt, args, dtype=jnp.bfloat16)
    if given == "dtype":
        port = build(bt, fmt, args, dtype=torch.bfloat16)
    elif given == "string":
        port = build(bt, fmt, args, dtype="bfloat16")
    elif given == "torch":
        port = build(bt, fmt, ([torch.from_numpy(b).to(torch.bfloat16)
                                for b in blocks], *rest))
    else:
        port = build(bt, fmt, ([np.asarray(jnp.asarray(b, jnp.bfloat16))
                                for b in blocks], *rest))
    assert port.dtype == torch.bfloat16
    jl, pl = jax_op.layout, port.layout
    assert len(jl.buckets) == len(pl.buckets)
    for jb, pb, staged in zip(jl.buckets, pl.buckets, port._buckets):
        for name in ("row_idx", "col_idx", "row_chunk_idx", "col_chunk_idx"):
            a, b = getattr(jb, name), getattr(pb, name)
            assert (a is None) == (b is None)
            if a is not None:
                assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        assert staged[0].dtype == torch.bfloat16
        bits = np.asarray(jb.values).view(np.int16)
        assert np.array_equal(staged[0].view(torch.int16).numpy(), bits)
        assert np.array_equal(pb.values, staged[0].float().numpy())


def test_bf16_symmetric_and_operator_algebra():
    """A bf16 symmetric operator against the f32 operator over its rounded
    values, and bf16 operands (computed in f32, returned in bf16)."""
    args = population("symmetric", np.float32)
    S = build(bt, "symmetric", args, dtype=torch.bfloat16)
    R = build(bt, "symmetric", rounded_args("symmetric", args))
    x = torch.from_numpy(operand(np.random.default_rng(16), "float32",
                                 S.shape[0], 4))
    assert relerr((S @ x).numpy(), (R @ x).numpy()) < TOL32
    got = S @ x.to(torch.bfloat16)
    assert got.dtype == torch.bfloat16
    want = (R @ x.to(torch.bfloat16).float()).to(torch.bfloat16)
    assert relerr(got.float().numpy(), want.float().numpy()) < TOL16
    assert S.todense().dtype == torch.bfloat16
    assert repr(S).count("bfloat16") == 1


def test_no_mixed_product_reaches_patch_or_stream(monkeypatch):
    """bf16 operators and f64 operands of f32 operators run the bucket
    route's mixed instances under ``patch="always"``, never the f32
    routes."""
    def refuse(*a, **k):
        raise AssertionError("a mixed product reached an f32-only route")

    monkeypatch.setattr(patch_engine, "patch_apply", refuse)
    monkeypatch.setattr(stream_format.StreamRouted, "_stream_apply", refuse)
    seen = []
    orig = fused_spmm.multi_block_apply

    def spy(table, x, **kw):
        seen.append((table.dtype, x.dtype))
        return orig(table, x, **kw)
    monkeypatch.setattr(fused_spmm, "multi_block_apply", spy)
    args = population("general-contiguous", np.float32)
    rng = np.random.default_rng(17)
    for dtype, x_dtype in ((torch.bfloat16, "float32"),
                           (torch.float32, "float64")):
        A = build(bt, "general-contiguous", args, dtype=dtype,
                  patch="always")
        for r in (1, 64):
            seen.clear()
            x = torch.from_numpy(operand(rng, x_dtype, *((A.shape[1],) if r == 1
                                                         else (A.shape[1], r))))
            A @ x
            assert seen and all(s == (dtype, x.dtype) for s in seen), seen


# -- scatter="sorted": B9's owner mode --------------------------------------


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_sorted_matches_atomic(dtype):
    """``tests/test_scatter_modes.py::test_sorted_matches_atomic``, and the
    port's sorted products against the JAX package's."""
    rng = np.random.default_rng(1234)
    args = random_block_sparse(91, shape=(400, 400), nblocks=30,
                               max_block=40, dtype=dtype)
    a = bt.BlockSparseMatrix(*args, scatter="atomic", device="cpu")
    s = bt.BlockSparseMatrix(*args, scatter="sorted", device="cpu")
    j = bst.BlockSparseMatrix(*args, scatter="sorted", backend="xla")
    S = bt.to_scipy(a)
    x = rng.standard_normal(400)
    if np.issubdtype(np.dtype(dtype), np.complexfloating):
        x = x + 1j * rng.standard_normal(400)
    t = torch.from_numpy
    assert relerr(s @ t(x), S @ x) < TOL64
    assert relerr(s.T @ t(x), S.T @ x) < TOL64
    assert relerr(s.H @ t(x), S.conj().T @ x) < TOL64
    assert relerr(s @ t(x), a @ t(x)) < TOL64
    X = np.stack([x, 2 * x], axis=1)
    assert relerr(s @ t(X), a @ t(X)) < TOL64
    assert relerr(s @ t(X), np.asarray(j @ jnp.asarray(X))) < TOL64
    assert relerr(s.H @ t(x), np.asarray(j.H @ jnp.asarray(x))) < TOL64


def test_sorted_with_overlapping_blocks():
    rng = np.random.default_rng(1234)
    b1 = rng.standard_normal((3, 3))
    b2 = rng.standard_normal((3, 3))
    rows = [np.array([0, 2, 4]), np.array([2, 3, 4])]
    cols = [np.array([1, 2, 3]), np.array([1, 3, 5])]
    A = bt.BlockSparseMatrix([b1, b2], rows, cols, (6, 6), scatter="sorted",
                             device="cpu")
    S = bt.to_scipy(A)
    x = rng.standard_normal(6)
    assert relerr(A @ torch.from_numpy(x), S @ x) < TOL64


@pytest.mark.parametrize("transpose", [False, True])
def test_owner_tables_match_the_jax_permutations(transpose):
    """The owner tables hold, bucket by bucket, exactly the JAX
    ``_sorted_scatter_info`` permutations and targets (sentinels dropped),
    and each owned row's contributions in that order."""
    args = random_block_sparse(93, shape=(300, 260), nblocks=24,
                               max_block=30, dtype=np.float64)
    jl = bst.BlockSparseMatrix(*args, backend="xla").layout
    port = bt.BlockSparseMatrix(*args, scatter="sorted", device="cpu")
    elem = [hb for hb in jl.buckets if hb.chunk == 1]
    assert elem
    want = _sorted_scatter_info(elem, transpose)
    got = mask_select.sorted_scatter_info(
        [hb.col_idx if transpose else hb.row_idx for hb in elem])
    for (jp, jt), (pp, pt) in zip(want, got):
        assert np.asarray(jp).tobytes() == pp.tobytes()
        assert np.asarray(jt).tobytes() == pt.tobytes()
    table = dispatch.bucket_tables(port._buckets, port.layout)["element"]
    out_len = port.shape[1] if transpose else port.shape[0]
    own = mask_select.owner_table(table, transpose, out_len)
    ent, rows, ptr = own.ent.numpy(), own.rows.numpy(), own.ptr.numpy()
    for q, (jp, jt) in enumerate(want):
        keep = np.asarray(jt) < out_len
        mine = ent[ent[:, 0] == q, 1]
        assert mine.tobytes() == np.asarray(jp)[keep].tobytes()
    assert np.all(np.diff(rows) > 0) and ptr[-1] == len(ent)
    targets = np.repeat(rows, np.diff(ptr))
    for q, hb in enumerate(elem):
        sel = ent[:, 0] == q
        flat = (hb.col_idx if transpose else hb.row_idx).reshape(-1)
        assert np.array_equal(flat[ent[sel, 1]], targets[sel])


def test_sorted_is_bit_reproducible():
    """Two sorted products on the CPU are ``torch.equal``; so are their
    gradients."""
    args = random_block_sparse(94, shape=(300, 300), nblocks=40,
                               max_block=30, dtype=np.float32)
    s = bt.BlockSparseMatrix(*args, scatter="sorted", device="cpu")
    rng = np.random.default_rng(18)
    for shape in ((300,), (300, 7)):
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        assert torch.equal(s @ x, s @ x)
        assert torch.equal(s.T @ x, s.T @ x)
        g = []
        for _ in range(2):
            xg = x.clone().requires_grad_()
            (s @ xg).square().sum().backward()
            g.append(xg.grad)
        assert torch.equal(*g)


@pytest.mark.parametrize("op_dtype,x_dtype", [("float32", "float64"),
                                              ("complex64", "complex128"),
                                              ("bfloat16", "float32")])
def test_sorted_mixed_and_colored(op_dtype, x_dtype):
    """The owner mode on mixed pairs equals the atomic pass; under
    ``schedule="colored"`` it replaces the colored plan, as in the JAX
    package."""
    args = random_block_sparse(95, shape=(200, 180), nblocks=20,
                               max_block=24, dtype=np.float32 if op_dtype ==
                               "bfloat16" else np.dtype(op_dtype))
    dt = torch.bfloat16 if op_dtype == "bfloat16" else None
    a = bt.BlockSparseMatrix(*args, dtype=dt, device="cpu")
    s = bt.BlockSparseMatrix(*args, dtype=dt, scatter="sorted",
                             schedule="colored", device="cpu")
    x = torch.from_numpy(operand(np.random.default_rng(19), x_dtype, 180, 3))
    got = s @ x
    assert got.dtype == torch.promote_types(a.dtype, x.dtype)
    assert relerr(got.numpy(), (a @ x).numpy()) < TOL32
    calls = []
    orig = mask_select.owner_apply_plain

    def spy(*a_, **k):
        calls.append(k.get("transpose"))
        return orig(*a_, **k)
    mask_select.owner_apply_plain = spy
    try:
        s.T @ torch.from_numpy(operand(np.random.default_rng(20), x_dtype,
                                       200))
    finally:
        mask_select.owner_apply_plain = orig
    assert calls == [True]


# -- schedule="auto", backend=, optimize= ------------------------------------


@pytest.mark.parametrize("fmt", ("general", "symmetric", "vbcrs"))
def test_schedule_auto(fmt):
    """An "auto" operator builds the colored operator's colors and gives
    its products bit for bit, and the JAX "auto" operator's."""
    args = population(fmt, np.float64, seed=21)
    auto = build(bt, fmt, args, schedule="auto")
    col = build(bt, fmt, args, schedule="colored")
    jax_auto = build(bst, fmt, args, schedule="auto")
    assert auto.schedule == bt.AUTO == "auto" and not bt.isserial("auto")
    if fmt == "general":
        assert auto.colors() == col.colors()
        assert auto.transposecolors() == col.transposecolors()
    rng = np.random.default_rng(22)
    for kw in MODES.values():
        n_in = auto.shape[0] if kw else auto.shape[1]
        x = rng.standard_normal((n_in, 3))
        got = auto.apply(torch.from_numpy(x), **kw)
        assert torch.equal(got, col.apply(torch.from_numpy(x), **kw))
        jop = jax_auto.T if kw else jax_auto
        assert relerr(got.numpy(), np.asarray(jop @ jnp.asarray(x))) < TOL64


@pytest.mark.parametrize("fmt", ("general", "symmetric", "vbcrs"))
def test_backend_and_optimize_are_stored_and_route_nothing(fmt, monkeypatch):
    """Every JAX ``backend`` / ``optimize`` value is taken and stored, the
    route taken (the launches made) is the default operator's, the products
    are equal, and an unknown value raises."""
    args = population(fmt, np.float32, seed=23)
    base = build(bt, fmt, args)
    calls = []
    for mod, name in ((fused_spmm, "multi_block_apply"),
                      (mask_select, "element_apply")):
        orig = getattr(mod, name)

        def spy(table, x, *, _orig=orig, _name=name, **kw):
            calls.append((_name, len(table),
                          tuple((k, v) for k, v in sorted(kw.items())
                                if k != "out")))
            return _orig(table, x, **kw)
        monkeypatch.setattr(mod, name, spy)
    x = torch.from_numpy(operand(np.random.default_rng(24), "float32",
                                 base.shape[1], 2))

    def route(op):
        calls.clear()
        y = op @ x
        return y, list(calls)

    y0, r0 = route(base)
    for key, values in (("backend", dispatch.BACKENDS),
                        ("optimize", dispatch.OPTIMIZE_MODES)):
        for value in values:
            op = build(bt, fmt, args, **{key: value})
            assert getattr(op, f"_{key}") == value
            y, r = route(op)
            assert r == r0 and torch.equal(y, y0), (key, value)
        with pytest.raises(ValueError, match=key):
            build(bt, fmt, args, **{key: "fastest"})
    if fmt != "symmetric":
        with pytest.raises(ValueError, match="scatter"):
            build(bt, fmt, args, scatter="segment")
    else:
        with pytest.raises(TypeError):
            build(bt, fmt, args, scatter="sorted")


def test_defaults_are_the_jax_defaults():
    args = population("general", np.float32)
    A = build(bt, "general", args)
    J = build(bst, "general", args, backend="auto")
    for key in ("_backend", "_scatter", "_optimize", "_granularity",
                "_precision", "_schedule"):
        assert getattr(A, key) == getattr(J, key), key
    S = build(bt, "symmetric", population("symmetric", np.float32))
    assert (S._backend, S._optimize, S.schedule) == ("auto", None, "colored")


def test_all_covers_the_jax_names():
    assert set(bst.__all__) <= set(bt.__all__)
    assert bt.schedule.AUTO == bt.AUTO
    for name in bst.__all__:
        assert getattr(bt, name) is not None


def test_from_reference_carries_options_and_bf16():
    args = population("general", np.float64, seed=25)
    J = bst.BlockSparseMatrix(*args, schedule="auto", scatter="sorted",
                              backend="pallas", optimize="latency",
                              dtype=jnp.bfloat16)
    P = bt.from_reference(J, device="cpu")
    assert (P.schedule, P._scatter, P._backend, P._optimize) == (
        "auto", "sorted", "pallas", "latency")
    assert P.dtype == torch.bfloat16
    x = np.random.default_rng(26).standard_normal(args[3][1]).astype(
        np.float32)
    assert relerr((P @ torch.from_numpy(x)).numpy(),
                  np.asarray(J @ jnp.asarray(x))) < TOL16
    V = bst.VariableBlockCompressedRowStorage(
        *population("vbcrs", np.float32), optimize="throughput")
    assert bt.from_reference(V, device="cpu")._optimize == "throughput"
