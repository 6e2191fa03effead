"""The row-stream body of B1 and of B9's element pass (r = 1) on the CPU.

On the card, an r = 1 product over a table of chunked buckets (B1) or of
element buckets (B9's element pass) runs ``csrc/row_stream.cuh`` where
``fused_spmm.R1_RULES`` picks it for the (stored, compute) pair, else the
FMA tile core.  Both compute the same function, so a CPU tensor runs the
same plain versions (``fused_spmm.multi_block_apply_plain``,
``mask_select.element_apply_plain``) whichever body the rule picks.  Here:

- the rule's choice for every pair and mode: the entry point a launch
  takes and the work items it is given (the row-stream body numbers the
  forward items, 64 stored rows of a block, in every mode);
- the body's work decomposition, mirrored in Python: for every row length
  the lanes of an item's eight warps read each (row, 16-byte load slot)
  exactly once, at most eight rows a lane;
- the plain versions at r = 1 against the JAX package
  (``xla_spmv.chunked_bucket_apply`` per chunked bucket, ``bucket_apply``
  over element buckets, both as XLA ops) for every pair x mode x conj, on
  the shapes the body must handle: 8-row chunked tiles, a 64 x 512 block
  (a bucket of one block), a 64 x 1536 block (two staged column chunks),
  an empty bucket, rows of 27 values (bf16 rows of odd length, rows whose
  byte length is not a multiple of 16), a 96-row tile, columns and rows of
  one value.  Values and operands come from numpy with a seed; the JAX
  package gets the values widened to the compute dtype (exact).
  Tolerance ``tol * max(1, max|ref|)``: 1e-5 for a float32 / complex64
  compute type, 1e-13 for float64 / complex128.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blocksparse_tpu.ops import xla_spmv

from blocksparse_tpu_torch.ops.kernels import fused_spmm, mask_select
from blocksparse_tpu_torch.ops.kernels.fused_spmm import BucketTable

torch.set_num_threads(2)

TOL = {torch.float32: 1e-5, torch.complex64: 1e-5, torch.float64: 1e-13,
       torch.complex128: 1e-13}
PAIRS = [(stored, compute)
         for stored, computes in fused_spmm.COMPUTE_TYPES.items()
         for compute in computes]
MODES = {"forward": {}, "transpose": {"transpose": True},
         "symmetric": {"symmetric": True}}
# the rule measured on the H100 (PERF.md section 6): (B1, B9)
WANT_BODY = {pair: ("rows", "rows") for pair in PAIRS}
WANT_BODY[(torch.bfloat16, torch.float32)] = ("rows", "tile")
# (nb, mp, kp, chunk): see the module docstring
SHAPES = ((3, 8, 16, 8), (1, 64, 512, 64), (1, 64, 1536, 64), (0, 8, 8, 8),
          (2, 9, 27, 3), (2, 96, 48, 16), (4, 64, 64, 32))
ELEM_SHAPES = ((4, 16, 1), (3, 1, 20))
N = 1600


def pair_id(pair):
    stored, compute = pair
    name = lambda d: str(d).replace("torch.", "")
    return name(stored) if stored == compute else \
        f"{name(stored)}->{name(compute)}"


def cases():
    for pair in PAIRS:
        for mode in MODES:
            for conj in ((False, True) if pair[0].is_complex else (False,)):
                yield pytest.param(pair, mode, conj,
                                   id=f"{pair_id(pair)}-{mode}"
                                      f"{'-conj' if conj else ''}")


def values(rng, shape, stored):
    """Normal values of ``shape`` in ``stored`` (bf16: rounded from
    float32; complex: a normal imaginary part too), as a torch tensor."""
    v = rng.standard_normal(shape)
    if stored.is_complex:
        v = v + 1j * rng.standard_normal(shape)
        return torch.from_numpy(v).to(stored)
    return torch.from_numpy(v.astype(np.float32)).to(stored)


def operand(rng, compute):
    x = rng.standard_normal(N)
    if compute.is_complex:
        x = x + 1j * rng.standard_normal(N)
    return torch.from_numpy(x).to(compute)


def relerr(got, want):
    got = got.detach().numpy().astype(np.complex128)
    want = np.asarray(want).astype(np.complex128)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want))) / max(1.0, float(
        np.max(np.abs(want))))


def chunked_table(rng, stored):
    """Chunked buckets of ``SHAPES`` whose chunk ids repeat and reach one
    chunk past N (they read zero and scatter nowhere)."""
    return BucketTable([
        (values(rng, (nb, mp, kp), stored),
         torch.from_numpy(rng.integers(0, N // C + 1, (nb, mp // C))
                          .astype(np.int32)),
         torch.from_numpy(rng.integers(0, N // C + 1, (nb, kp // C))
                          .astype(np.int32)), C)
        for nb, mp, kp, C in SHAPES])


def element_table(rng, stored):
    """Element buckets of the same shapes and ``ELEM_SHAPES``: rows with
    repeats, sentinel lanes (index N) in both tables."""
    out = []
    for nb, mp, kp in [s[:3] for s in SHAPES] + list(ELEM_SHAPES):
        ridx = rng.integers(0, N, (nb, mp)).astype(np.int32)
        cidx = rng.integers(0, N, (nb, kp)).astype(np.int32)
        ridx[::2, -1] = N
        cidx[1::3, 0] = N
        out.append((values(rng, (nb, mp, kp), stored),
                    torch.from_numpy(ridx), torch.from_numpy(cidx), 1))
    return BucketTable(out)


def jax_vals(v, compute):
    """A bucket's values for the JAX package: widened to the compute dtype
    (exact for every pair)."""
    return jnp.asarray(v.to(compute).numpy())


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("pair", PAIRS, ids=pair_id)
def test_rule_picks_the_body_of_each_pair_and_mode(pair, mode):
    stored, compute = pair
    table = chunked_table(np.random.default_rng(1), stored)
    m = fused_spmm.launch_mode(mode == "transpose", mode == "symmetric")
    for kind, want in zip(("B1", "B9"), WANT_BODY[pair]):
        assert fused_spmm.r1_body(kind, stored, compute) == want
        rows = want == "rows"
        entry, got_rows = fused_spmm.fma_launch(kind, stored, compute, 1)
        assert got_rows == rows
        assert entry == fused_spmm.entry_point(
            fused_spmm.FMA_PREFIXES[kind][rows], stored, compute)
        # r > 1 stays on the tile core (or the tensor cores)
        assert fused_spmm.fma_launch(kind, stored, compute, 2)[1] is False
        assert fused_spmm.launch_items(table, m, rows) == (
            table.items[0] if rows else table.items[mode == "transpose"])
    # the row-stream body's items: 64 stored rows of a block
    assert table.items[0] == sum(nb * -(-mp // 64)
                                 for nb, mp, _kp, _c in SHAPES)


def lanes_cover(kp: int, N_: int) -> None:
    """row_stream.cuh::row_kernel's decomposition of a 64-row item of rows
    of ``kp`` values in load slots of ``N_`` elements: the set of (row,
    slot) every lane of the 8 warps reads, each exactly once, at most 8
    rows a lane."""
    W = -(-kp // N_)
    G = 1
    while G < W and G < 32:
        G *= 2
    NG = 32 // G
    seen = []
    for w in range(8):
        for lane in range(32):
            slot, c = lane // G, lane % G
            rows = [w + 8 * (slot + NG * s) for s in range(8)]
            rows = [i for i in rows if i < 64]
            assert len(rows) <= 8
            for u0 in range(0, W, G):
                if u0 + c < W:
                    seen += [(i, u0 + c) for i in rows]
    assert sorted(seen) == [(i, v) for i in range(64) for v in range(W)]


@pytest.mark.parametrize("kp", [1, 3, 8, 27, 64, 96, 128, 512, 1536])
def test_lanes_read_each_load_of_an_item_once(kp):
    for N_ in (1, 2, 4, 8):
        lanes_cover(kp, N_)


@pytest.mark.parametrize("pair,mode,conj", list(cases()))
def test_b1_plain_vs_jax_chunked_bucket_apply(pair, mode, conj):
    stored, compute = pair
    rng = np.random.default_rng(191)
    table = chunked_table(rng, stored)
    x, prior = operand(rng, compute), operand(rng, compute)
    want = prior.numpy().astype(np.complex128)
    for v, rt, ct, C in table.buckets:
        if v.shape[0]:
            want = want + np.asarray(xla_spmv.chunked_bucket_apply(
                jax_vals(v, compute), jnp.asarray(rt.numpy()),
                jnp.asarray(ct.numpy()), C, N, jnp.asarray(x.numpy()),
                conj=conj, precision="highest", **MODES[mode]))
    got = fused_spmm.multi_block_apply(table, x, out=prior.clone(),
                                       conj=conj, **MODES[mode])
    assert got.dtype == compute
    assert relerr(got, want) <= TOL[compute]


@pytest.mark.parametrize("pair,mode,conj", list(cases()))
def test_b9_plain_vs_jax_bucket_apply(pair, mode, conj):
    stored, compute = pair
    rng = np.random.default_rng(192)
    table = element_table(rng, stored)
    x, prior = operand(rng, compute), operand(rng, compute)
    want = xla_spmv.bucket_apply(
        [(jax_vals(v, compute), jnp.asarray(ri.numpy()),
          jnp.asarray(ci.numpy())) for v, ri, ci, _c in table.buckets
         if v.shape[0]], N, jnp.asarray(x.numpy()), conj=conj,
        precision="highest", **MODES[mode])
    got = mask_select.element_apply(table, x, out=prior.clone(), conj=conj,
                                    **MODES[mode])
    assert got.dtype == compute
    assert relerr(got, prior.numpy() + np.asarray(want)) <= TOL[compute]
