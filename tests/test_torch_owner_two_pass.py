"""B9's owner mode in its two-pass layout (``scatter="sorted"``) on the CPU,
held to the JAX package's sorted scatter.

On the card an owner-mode product runs two launches: the products
of every (block, row) of the element buckets into a scratch of one row per
(block, row), then each owned output row's sum of its scratch rows in the
owner table's list order (``csrc/owner_pass.cu``).  Its plain version
(``mask_select.owner_products_plain`` / ``owner_sum_plain``) is those two
passes in the same layout and the same order, and is what a CPU tensor
runs.  The same numpy blocks from a seed go into the JAX package's
``scatter="sorted"`` operator (``backend="xla"``, x64) and into the port;
operators renumbered through a permutation, so every bucket is an element
bucket.  Tolerance: 1e-13 relative to max(1, max|ref|) in float64 and
complex128.

- the owner table's flat rows: each contribution's row of the scratch is
  its bucket's offset plus its entry, and that row holds exactly the
  contribution's product (numpy, per entry);
- the two passes against the JAX sorted product and scipy: forward,
  transpose, and the conjugate modes (``A.H``, ``A.conj()``), r in
  {1, 3, 8};
- the sum pass adds each row's contributions in list order from zero:
  bit-equal to a loop that does exactly that;
- an owner table with no rows (every target a sentinel) leaves the output
  as it was; sentinel targets inside a bucket are dropped;
- two runs are bit-equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import blocksparse_tpu as bst
import blocksparse_tpu_torch as bt
from blocksparse_tpu_torch.ops import dispatch
from blocksparse_tpu_torch.ops.kernels import mask_select
from blocksparse_tpu_torch.ops.kernels.fused_spmm import BucketTable
from blocksparse_tpu_torch.utils.testmatrices import random_block_sparse

torch.set_num_threads(2)

TOL = 1e-13
DTYPES = [np.float64, np.complex128]
# mode -> (port operator view, JAX operator view, scipy view)
MODES = {
    "A @": (lambda A: A, lambda J: J, lambda S: S),
    "A.T @": (lambda A: A.T, lambda J: J.T, lambda S: S.T),
    "A.H @": (lambda A: A.H, lambda J: J.H, lambda S: S.conj().T),
    "A.conj() @": (lambda A: A.conj(), lambda J: J.conj(),
                   lambda S: S.conj()),
}


def relerr(a, b):
    a = np.asarray(a.numpy() if isinstance(a, torch.Tensor) else a,
                   np.complex128)
    b = np.asarray(b, np.complex128)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(1.0, float(np.max(np.abs(b))) if b.size else 1.0)
    return float(np.max(np.abs(a - b))) / scale if a.size else 0.0


def operand(rng, dtype, *shape):
    x = rng.standard_normal(shape)
    if np.issubdtype(np.dtype(dtype), np.complexfloating):
        x = x + 1j * rng.standard_normal(shape)
    return x.astype(dtype)


def scattered_args(seed, dtype, n=360, nblocks=28, max_block=36):
    """Blocks of ``random_block_sparse`` with every index renumbered
    through a permutation (no chunked buckets)."""
    blocks, rows, cols, shape = random_block_sparse(
        seed, shape=(n, n), nblocks=nblocks, max_block=max_block, dtype=dtype)
    perm = np.random.default_rng(seed + 1).permutation(n)
    return blocks, [perm[r] for r in rows], [perm[c] for c in cols], shape


def element_table(A) -> BucketTable:
    tables = dispatch.bucket_tables(A._buckets, A.layout)
    assert tables["chunked"] is None and tables["element"] is not None
    return tables["element"]


@pytest.fixture(scope="module", params=DTYPES, ids=["f64", "c128"])
def case(request):
    dtype = request.param
    args = scattered_args(41, dtype)
    A = bt.BlockSparseMatrix(*args, scatter="sorted", device="cpu")
    J = bst.BlockSparseMatrix(*args, scatter="sorted", backend="xla")
    return dtype, A, J, bt.to_scipy(A)


@pytest.mark.parametrize("transpose", [False, True])
def test_flat_rows_hold_each_contribution(case, transpose):
    """``flat[e] = offsets[bucket] + entry``, and the products pass puts
    at that row exactly the contribution's product, formed per entry in
    numpy."""
    dtype, A, _J, _S = case
    table = element_table(A)
    out_len = A.shape[1] if transpose else A.shape[0]
    own = mask_select.owner_table(table, transpose, out_len)
    ent, flat = own.ent.numpy(), own.flat.numpy()
    offsets = own.offsets.numpy()
    assert flat.dtype == np.int64 and own.p_rows == sum(
        v.shape[0] * v.shape[2 if transpose else 1] for v in table.values)
    assert np.array_equal(flat, offsets[ent[:, 0]] + ent[:, 1])
    x = operand(np.random.default_rng(3), dtype, A.shape[0], 3)
    P = mask_select.owner_products_plain(table, torch.from_numpy(x),
                                         transpose=transpose).numpy()
    assert P.shape == (own.p_rows, 3)
    xe = np.concatenate([x, np.zeros((1, 3), x.dtype)])  # sentinel row
    for e in range(0, len(ent), 7):
        q, entry = ent[e]
        vals, ridx, cidx, _ = table.buckets[q]
        v, ri, ci = vals.numpy(), ridx.numpy(), cidx.numpy()
        n = x.shape[0]
        if transpose:
            b, k = divmod(entry, v.shape[2])
            want = v[b, :, k] @ xe[np.minimum(ri[b], n)]
        else:
            b, i = divmod(entry, v.shape[1])
            want = v[b, i, :] @ xe[np.minimum(ci[b], n)]
        assert relerr(P[flat[e]], want) < TOL


@pytest.mark.parametrize("r", [1, 3, 8])
@pytest.mark.parametrize("mode", list(MODES))
def test_two_passes_match_the_jax_sorted_product(case, mode, r):
    """The plain two passes (what the port runs on the CPU, and what the
    card's two launches compute) against the JAX package's sorted product
    and scipy."""
    dtype, A, J, S = case
    port_view, jax_view, sp_view = MODES[mode]
    shape = (A.shape[1],) if r == 1 else (A.shape[1], r)
    x = operand(np.random.default_rng(r), dtype, *shape)
    got = port_view(A) @ torch.from_numpy(x)
    assert relerr(got, np.asarray(jax_view(J) @ jnp.asarray(x))) < TOL
    assert relerr(got, sp_view(S) @ x) < TOL


@pytest.mark.parametrize("transpose", [False, True])
def test_sum_pass_adds_in_list_order(case, transpose):
    """Each owned row is its contributions' scratch rows added one after
    another from zero, in list order, then added into the output once:
    bit for bit."""
    dtype, A, _J, _S = case
    table = element_table(A)
    out_len = A.shape[1] if transpose else A.shape[0]
    own = mask_select.owner_table(table, transpose, out_len)
    x = torch.from_numpy(operand(np.random.default_rng(5), dtype,
                                 A.shape[0], 4))
    prior = torch.from_numpy(operand(np.random.default_rng(6), dtype,
                                     out_len, 4))
    P = mask_select.owner_products_plain(table, x, transpose=transpose)
    got = mask_select.owner_sum_plain(own, P, out=prior.clone())
    want = prior.clone()
    rows, ptr, flat = own.rows.numpy(), own.ptr.numpy(), own.flat.numpy()
    for w, row in enumerate(rows):
        acc = torch.zeros(4, dtype=P.dtype)
        for e in range(ptr[w], ptr[w + 1]):
            acc = acc + P[flat[e]]
        want[row] = want[row] + acc
    assert torch.equal(got, want)


def test_two_runs_are_bit_equal(case):
    dtype, A, _J, _S = case
    rng = np.random.default_rng(8)
    for shape in ((A.shape[1],), (A.shape[1], 5)):
        x = torch.from_numpy(operand(rng, dtype, *shape))
        assert torch.equal(A @ x, A @ x)
        assert torch.equal(A.H @ x, A.H @ x)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "c128"])
def test_empty_table_and_sentinel_targets(dtype):
    """A bucket whose every target is a sentinel gives an owner table with
    no rows and leaves the output as it was; inside a bucket, sentinel
    targets (row index = out_len) are dropped and the rest summed."""
    rng = np.random.default_rng(9)
    n = 40
    vals = torch.from_numpy(operand(rng, dtype, 3, 4, 5))
    cidx = torch.from_numpy(rng.integers(0, n, (3, 5)).astype(np.int32))
    dead = BucketTable([(vals, torch.full((3, 4), n, dtype=torch.int32),
                         cidx, 1)])
    x = torch.from_numpy(operand(rng, dtype, n, 2))
    prior = torch.from_numpy(operand(rng, dtype, n, 2))
    own = mask_select.owner_table(dead, False, n)
    assert own.n_rows == 0 and own.flat.numel() == 0
    out = mask_select.owner_apply_plain(dead, x, out=prior.clone())
    assert torch.equal(out, prior)
    ridx = rng.integers(0, n, (3, 4)).astype(np.int32)
    ridx[0, 1] = ridx[2, 3] = n  # sentinel targets
    live = BucketTable([(vals, torch.from_numpy(ridx), cidx, 1)])
    own = mask_select.owner_table(live, False, n)
    assert int(own.ptr[-1]) == 3 * 4 - 2
    out = mask_select.owner_apply_plain(live, x, out=prior.clone())
    want = prior.numpy().copy()
    v, xn, ci = vals.numpy(), x.numpy(), cidx.numpy()
    for b in range(3):
        for i in range(4):
            if ridx[b, i] < n:
                want[ridx[b, i]] += v[b, i] @ xn[ci[b]]
    assert relerr(out, want) < TOL
    # transposed: every column target is live
    own_t = mask_select.owner_table(live, True, n)
    assert int(own_t.ptr[-1]) == 3 * 5
    out_t = mask_select.owner_apply_plain(live, x, out=torch.zeros_like(x),
                                          transpose=True)
    want_t = np.zeros_like(xn)
    xe = np.concatenate([xn, np.zeros((1, 2), xn.dtype)])
    for b in range(3):
        np.add.at(want_t, ci[b], v[b].T @ xe[np.minimum(ridx[b], n)])
    assert relerr(out_t, want_t) < TOL
