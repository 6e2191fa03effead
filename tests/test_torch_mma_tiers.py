"""Kernels B3 and B4 on the tensor cores: owner tables and precision tiers.

On the CPU the wrappers run the kernels' plain versions, which are exact in
the operands' dtype at every tier; these tests hold what the card's kernels
are handed:

  - B3's owner tables (``ops/patch_engine.owner_tables``) list every
    mirrored (slot, chunk) pair once in the symmetric mode and every live
    pair once in the adjoint mode, grouped by the chunk they land on;
  - B3's plain version, which runs the same two passes from those tables,
    equals the JAX package's ``_kern_mir`` in interpret mode and its VJP
    (f32, 1e-5), and the JAX package's f64 product and VJP (1e-13: the
    Pallas kernel computes in f32 only);
  - the formats hand their ``precision`` to B3, and ``batched_mm`` hands
    ``ops[0].precision`` to B4 when called with ``precision=None``, as the
    JAX package does.

Tolerances relative to max(1, max|ref|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import blocksparse_tpu as bst
from blocksparse_tpu.core.layout import build_layout as jax_build_layout
from blocksparse_tpu.core.patch import build_patch_plan as jax_build_patch_plan
from blocksparse_tpu.ops import patch_engine as jax_patch

import blocksparse_tpu_torch as bt
from blocksparse_tpu_torch.core.layout import build_layout
from blocksparse_tpu_torch.core.patch import CC, build_patch_plan
from blocksparse_tpu_torch.ops import patch_engine
from blocksparse_tpu_torch.ops.kernels import batched_spmm
from blocksparse_tpu_torch.ops.torch_spmv import (chunk_rows, gather_rows,
                                                  scatter_rows)
from blocksparse_tpu_torch.utils.testmatrices import random_symmetric

torch.set_num_threads(2)

TOL64, TOL32 = 1e-13, 1e-5


def relerr(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b))) / max(1.0, float(np.max(np.abs(b))))


SIZES = {3: dict(n=1024, ngroups=12, noffdiag=20),
         8: dict(n=4096, ngroups=48, noffdiag=160),
         51: dict(n=160, ngroups=5, noffdiag=6)}


def sym_blocks(seed):
    return random_symmetric(seed, dtype=np.float32, contiguous=True,
                            **SIZES[seed])


def port_plan(seed, transpose_main):
    d, di, o, ri, ci, shape = sym_blocks(seed)
    plan = build_patch_plan(build_layout(d, di, di, shape),
                            extra_layout=build_layout(o, ri, ci, shape),
                            transpose_main=transpose_main)
    return plan, shape


# -- (a) the owner tables ---------------------------------------------------------

@pytest.mark.parametrize("adjoint", [False, True])
@pytest.mark.parametrize("transpose_main", [False, True])
@pytest.mark.parametrize("seed", [3, 8])
def test_owner_tables_list_every_pair_once(seed, transpose_main, adjoint):
    plan, shape = port_plan(seed, transpose_main)
    b = plan.buckets[0]
    nchunks = -(-shape[0] // CC)
    chunk, ptr, pair = patch_engine.owner_tables(b.col_chunk, b.mirror_kc,
                                                 nchunks, adjoint)
    KC = b.KP // CC
    want = {(s, j) for s in range(b.nb) for j in range(KC)
            if b.col_chunk[s, j] < nchunks
            and (adjoint or j < b.mirror_kc[s])}
    got = [(int(p) // KC, int(p) % KC) for p in pair]
    assert len(got) == len(set(got)) == len(want) and set(got) == want
    assert len(want) > 0
    # grouped by the chunk each pair lands on, one owner per chunk
    fan = np.diff(ptr)
    assert ptr[0] == 0 and ptr[-1] == len(pair) and (fan > 0).all()
    assert len(set(chunk.tolist())) == len(chunk)
    for o, c in enumerate(chunk):
        members = pair[ptr[o]:ptr[o + 1]]
        assert (b.col_chunk.reshape(-1)[members] == c).all()
        assert (np.diff(members) > 0).all()      # the fixed summation order
    # descending fan-in, ties by chunk id
    keys = list(zip(-fan, chunk))
    assert keys == sorted(keys)
    # the device arrays carry both modes' tables
    dev = patch_engine.patch_device_arrays(plan, "cpu")[0]
    assert len(tuple(dev)) == 4
    for t, ref in zip(dev.owners[adjoint], (chunk, ptr, pair)):
        assert t.dtype == torch.int32 and np.array_equal(t.numpy(), ref)


def test_owner_tables_absent_on_plain_plans():
    rng = np.random.default_rng(61)
    blocks = [rng.standard_normal((40, 40)).astype(np.float32)
              for _ in range(4)]
    idx = [np.arange(s, s + 40) for s in (0, 50, 100, 150)]
    plan = build_patch_plan(build_layout(blocks, idx, idx[::-1], (200, 200)))
    dev = patch_engine.patch_device_arrays(plan, "cpu")
    assert not plan.symmetric and dev[0].owners is None
    chunk, ptr, pair = patch_engine.owner_tables(
        plan.buckets[0].col_chunk, np.zeros(plan.buckets[0].nb, np.int32),
        -(-200 // CC), adjoint=False)
    assert chunk.size == pair.size == 0 and ptr.tolist() == [0]


def _two_pass_reference(vals, cc, rs, mk, X, adjoint):
    """B3's map written without owner tables: forward into the windows,
    the transposed product of every chunk (adjoint) or of the chunks
    j < mk (symmetric) into the chunk rows."""
    n, (nb, MP, KP) = X.shape[0], vals.shape
    KC = KP // CC
    win = rs.long()[:, None] + torch.arange(MP)
    cols = chunk_rows(cc, CC)
    lead = (torch.arange(KC)[None, :] < mk.long()[:, None]).repeat_interleave(
        CC, dim=1)
    far = torch.full_like(cols, 1 << 40)
    mir = torch.where(lead, cols, far)
    fwd_cols, tr_cols = (mir, cols) if adjoint else (cols, mir)
    yp = torch.einsum("bmk,bkr->bmr", vals, gather_rows(X, fwd_cols))
    yt = torch.einsum("bmk,bmr->bkr", vals, gather_rows(X, win))
    return scatter_rows(n, win, yp) + scatter_rows(n, tr_cols, yt)


@pytest.mark.parametrize("adjoint", [False, True])
def test_b3_plain_on_random_tables_f64(adjoint):
    """Duplicate chunk ids within a slot, sentinel chunks, mirrored prefixes
    of every length and windows past n: the owner-table passes equal the
    direct two-pass formula at 1e-13."""
    rng = np.random.default_rng(62)
    n, nb, MP, KC, r = 300, 23, 24, 8, 5
    nchunks = -(-n // CC)
    cc = rng.integers(0, nchunks + 1, (nb, KC)).astype(np.int32)
    cc[:, 1] = cc[:, 0]                        # a duplicate in every slot
    mk = rng.integers(0, KC + 1, nb).astype(np.int32)
    rs = rng.integers(0, n - 8, nb).astype(np.int32)
    vals = torch.from_numpy(rng.standard_normal((nb, MP, KC * CC)))
    X = torch.from_numpy(rng.standard_normal((n, r)))
    t = torch.from_numpy
    got = patch_engine.bucket_spmm_sym(vals, t(cc), t(rs), t(mk), X,
                                       adjoint=adjoint)
    want = _two_pass_reference(vals, t(cc), t(rs), t(mk), X, adjoint)
    assert relerr(got, want) <= TOL64
    tabs = tuple(map(t, patch_engine.owner_tables(cc, mk, nchunks, adjoint)))
    again = patch_engine.bucket_spmm_sym_plain(vals, t(cc), t(rs), t(mk), X,
                                               adjoint=adjoint, owners=tabs)
    assert torch.equal(again, got)


# -- (b) the plain version against the JAX package ---------------------------------

def jax_pair(transpose_main):
    """The port's and the JAX package's symmetric plans of one fixture."""
    d, di, o, ri, ci, shape = sym_blocks(51)
    mine, _ = port_plan(51, transpose_main)
    ref = jax_build_patch_plan(
        jax_build_layout(d, di, di, shape, granularity="pow2"),
        extra_layout=jax_build_layout(o, ri, ci, shape, granularity="pow2"),
        transpose_main=transpose_main)
    return mine, ref, shape


@pytest.mark.parametrize("transpose_main", [False, True])
def test_b3_plain_equals_kern_mir_and_its_vjp_f32(transpose_main, r=3):
    mine, ref, shape = jax_pair(transpose_main)
    rng = np.random.default_rng(63)
    X = rng.standard_normal((shape[0], r)).astype(np.float32)
    G = rng.standard_normal((shape[0], r)).astype(np.float32)
    jdev = jax_patch.patch_device_arrays(ref)
    want, vjp = jax.vjp(
        lambda X_: jax_patch.patch_spmm(ref, jdev, X_, interpret=True),
        jnp.asarray(X))
    (want_dx,) = vjp(jnp.asarray(G))
    vals, cc, rs, mk = dev = patch_engine.patch_device_arrays(mine, "cpu")[0]
    got = patch_engine.bucket_spmm_sym_plain(vals, cc, rs, mk,
                                             torch.from_numpy(X),
                                             owners=dev.owners[False])
    assert relerr(got, want) <= TOL32
    got_dx = patch_engine.bucket_spmm_sym_plain(vals, cc, rs, mk,
                                                torch.from_numpy(G),
                                                adjoint=True,
                                                owners=dev.owners[True])
    assert relerr(got_dx, want_dx) <= TOL32


@pytest.mark.parametrize("transpose_main", [False, True])
def test_b3_plain_equals_jax_product_and_vjp_f64(transpose_main, r=3):
    """The plan's f32 values carried exactly into f64, against the JAX
    package's f64 symmetric operator on the same values and jax.vjp of its
    product."""
    d, di, o, ri, ci, shape = sym_blocks(51)
    J = bst.SymmetricBlockMatrix(
        [b.astype(np.float64) for b in d], di,
        [b.astype(np.float64) for b in o], ri, ci, shape, backend="xla")
    op = (lambda A: A.T) if transpose_main else (lambda A: A)
    mine, _ = port_plan(51, transpose_main)
    rng = np.random.default_rng(64)
    X = rng.standard_normal((shape[0], r))
    G = rng.standard_normal((shape[0], r))
    want, vjp = jax.vjp(lambda X_: op(J) @ X_, jnp.asarray(X))
    (want_dx,) = vjp(jnp.asarray(G))
    dev = patch_engine.patch_device_arrays(mine, "cpu")[0]
    vals, cc, rs, mk = dev
    vals = vals.double()
    got = patch_engine.bucket_spmm_sym(vals, cc, rs, mk, torch.from_numpy(X),
                                       owners=dev.owners[False])
    got_dx = patch_engine.bucket_spmm_sym(vals, cc, rs, mk,
                                          torch.from_numpy(G), adjoint=True,
                                          owners=dev.owners[True])
    assert got.dtype == torch.float64
    assert relerr(got, want) <= TOL64
    assert relerr(got_dx, want_dx) <= TOL64


# -- (c) the formats hand their tier to B3 ---------------------------------------

def recorder(monkeypatch, module, name):
    seen = []
    orig = getattr(module, name)

    def wrapped(*a, **k):
        seen.append(k)
        return orig(*a, **k)
    monkeypatch.setattr(module, name, wrapped)
    return seen


@pytest.mark.parametrize("precision", ["highest", "high", None])
def test_symmetric_format_hands_its_tier_to_b3(monkeypatch, precision):
    d, di, o, ri, ci, shape = sym_blocks(51)
    S = bt.SymmetricBlockMatrix(d, di, o, ri, ci, shape, device="cpu",
                                precision=precision)
    assert S.precision == precision
    seen = recorder(monkeypatch, patch_engine, "bucket_spmm_sym")
    X = torch.from_numpy(np.random.default_rng(65).standard_normal(
        (shape[0], 4)).astype(np.float32)).requires_grad_()
    Y = S @ X
    assert [(k["precision"], k["adjoint"]) for k in seen] == [
        (precision, False)]
    assert seen[0]["owners"] is not None      # the bucket's own tables
    Y.sum().backward()                        # dX: the adjoint mode
    assert [(k["precision"], k["adjoint"]) for k in seen[1:]] == [
        (precision, True)]
    Sc = bst.to_scipy(bst.SymmetricBlockMatrix(d, di, o, ri, ci, shape,
                                               backend="xla"))
    Xn = X.detach().double().numpy()
    assert relerr(Y.detach(), Sc @ Xn) <= TOL32   # exact on the CPU
    assert relerr(X.grad, Sc.T @ np.ones_like(Xn)) <= TOL32


def test_tiers_and_refusals():
    assert patch_engine.TIERS == {"highest": 1, "high": 1, None: 0}
    assert [patch_engine.precision_tier(p) for p in ("highest", "high", None)
            ] == [1, 1, 0]
    with pytest.raises(ValueError, match="precision"):
        patch_engine.precision_tier("fast")
    plan, shape = port_plan(51, False)
    vals, cc, rs, mk = patch_engine.patch_device_arrays(plan, "cpu")[0]
    X = torch.zeros((shape[0], 2))
    with pytest.raises(ValueError, match="precision"):
        patch_engine.bucket_spmm_sym(vals, cc, rs, mk, X, precision="fast")
    with pytest.raises(ValueError, match="owners"):
        patch_engine.bucket_spmm_sym(vals, cc, rs, mk, X, owners=(cc, rs))
    with pytest.raises(ValueError, match="precision"):
        batched_spmm.batched_spmm(vals[None], cc, rs, X[None], shape[0],
                                  precision="fast")


# -- (d) batched_mm takes ops[0].precision -----------------------------------------

def batch(precisions, seed0=70, n=384, nblocks=9, bs=32):
    """Same-structure operators (structure seed 7, values seed0 + p), in
    the JAX package (pallas-interpret) and in the port."""
    ntiles = n // bs
    pos = np.random.default_rng(7).choice(ntiles * ntiles, size=nblocks,
                                          replace=False)
    rows = [np.arange(r, r + bs) for r in (pos // ntiles) * bs]
    cols = [np.arange(c, c + bs) for c in (pos % ntiles) * bs]
    J, P = [], []
    for p, prec in enumerate(precisions):
        vr = np.random.default_rng(seed0 + p)
        blocks = [vr.standard_normal((bs, bs)).astype(np.float32)
                  for _ in range(nblocks)]
        J.append(bst.BlockSparseMatrix(blocks, rows, cols, (n, n),
                                       backend="pallas-interpret",
                                       precision=prec))
        P.append(bt.BlockSparseMatrix(blocks, rows, cols, (n, n),
                                      device="cpu", precision=prec))
    return J, P


@pytest.mark.parametrize("first", ["highest", "high", None])
def test_batched_mm_takes_the_first_operators_tier(monkeypatch, first):
    J, P = batch([first, "highest", None])
    seen = recorder(monkeypatch, batched_spmm, "batched_spmm")
    X = np.random.default_rng(66).standard_normal((3, 384, 6)).astype(
        np.float32)
    got = bt.batched_mm(P, torch.from_numpy(X))
    assert [k["precision"] for k in seen] == [first]
    assert relerr(got, np.asarray(bst.batched_mm(J, X))) <= TOL32
    bt.batched_mm(P, torch.from_numpy(X), precision="high")
    assert seen[-1]["precision"] == "high"


def test_batched_gradient_keeps_the_tier(monkeypatch):
    _, P = batch([None, None])
    seen = recorder(monkeypatch, batched_spmm, "batched_spmm")
    X = torch.from_numpy(np.random.default_rng(67).standard_normal(
        (2, 384, 4)).astype(np.float32)).requires_grad_()
    bt.batched_mm(P, X).sum().backward()
    assert [(k["precision"], k["transpose"]) for k in seen] == [
        (None, False), (None, True)]
    for p, op in enumerate(P):
        S = bt.to_scipy(op)
        assert relerr(X.grad[p], S.T @ np.ones((384, 4))) <= TOL32


def test_b4_wrapper_defaults_to_highest():
    import inspect

    for fn in (batched_spmm.batched_spmm, batched_spmm.batched_spmm_apply,
               patch_engine.bucket_spmm_sym):
        assert inspect.signature(fn).parameters["precision"].default == \
            "highest"
