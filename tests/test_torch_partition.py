"""The port's partition and halo planner, byte-equal to the JAX package's.

``blocksparse_tpu_torch/parallel/partition.py`` is a numpy copy of
``blocksparse_tpu/parallel/partition.py`` (its ``stack_operand`` computes
the tables with array operations where the JAX one fills them entry by
entry).  On the same numpy blocks, built into each package's format, every
output of ``partition_rows``, ``collect_reads``, ``plan_halo`` and
``stack_operand`` must equal the JAX function's, dtype and bytes, for
general, symmetric (the merged plan), VBCRS, uneven and rectangular
operators at S in {2, 4, 8}; and a JAX ``DistributedBlockOperator`` carried
across by ``from_reference`` must hold exactly the arrays the port's own
``distribute`` stacks.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

import blocksparse_tpu as bst
import blocksparse_tpu_torch as bt
from blocksparse_tpu.parallel import partition as jpart
from blocksparse_tpu.parallel.distributed import distribute as jdistribute
from blocksparse_tpu_torch.parallel import partition as tpart
from blocksparse_tpu_torch.parallel.distributed import distribute
from blocksparse_tpu_torch.parallel.mesh import Mesh
from blocksparse_tpu_torch.utils.testmatrices import (random_block_sparse,
                                                      random_symmetric,
                                                      random_vbcrs)

torch.set_num_threads(2)

KINDS = ["general", "symmetric", "vbcrs", "uneven", "rectangular",
         "contiguous"]


def operands(kind):
    """(JAX operator, port operator) on one set of numpy blocks."""
    if kind == "symmetric":
        args = random_symmetric(42, n=640, ngroups=16, noffdiag=40,
                                dtype=np.float64)
        return (bst.SymmetricBlockMatrix(*args),
                bt.SymmetricBlockMatrix(*args, device="cpu"))
    if kind == "vbcrs":
        args = random_vbcrs(43, shape=(800, 800), nrowgroups=16,
                            ncolgroups=16, dtype=np.float64)
        return (bst.VariableBlockCompressedRowStorage(*args),
                bt.VariableBlockCompressedRowStorage(*args, device="cpu"))
    kw = {"general": dict(seed=41, shape=(519, 519), nblocks=40, max_block=50),
          "uneven": dict(seed=45, shape=(501, 503), nblocks=25, max_block=30),
          "rectangular": dict(seed=47, shape=(700, 350), nblocks=30,
                              max_block=40),
          "contiguous": dict(seed=17, shape=(512, 512), nblocks=24,
                             contiguous=True)}[kind]
    seed = kw.pop("seed")
    args = random_block_sparse(seed, dtype=np.float64, **kw)
    return (bst.BlockSparseMatrix(*args),
            bt.BlockSparseMatrix(*args, device="cpu"))


def layouts(op):
    if hasattr(op, "_dlayout"):
        return [op._dlayout, op._olayout]
    return [op._layout]


def assert_same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, f"{what}: dtype {a.dtype} != {b.dtype}"
    assert a.shape == b.shape, f"{what}: shape {a.shape} != {b.shape}"
    assert a.tobytes() == b.tobytes(), f"{what}: bytes differ"


def assert_same_plan(p, q, what):
    assert (p.S, p.per, p.dists, p.halo_chunks) == \
        (q.S, q.per, q.dists, q.halo_chunks), what
    assert len(p.send_idx) == len(q.send_idx), what
    for d, (a, b) in enumerate(zip(p.send_idx, q.send_idx)):
        assert_same(a, b, f"{what} send_idx[{d}]")
    assert [dict(c) for c in p.chunk_pos] == [dict(c) for c in q.chunk_pos]
    assert p.exchanged_bytes_per_call == q.exchanged_bytes_per_call


def plans(mod, lays, sym, m, n, S):
    """The halo plans as ``distribute`` makes them, in ``mod``."""
    part = mod.partition_rows(m, S)
    rp, cp = part.shard_rows, mod.partition_rows(n, S).shard_rows
    if sym:
        needed = [set() for _ in range(S)]
        for lay in lays:
            for side in ("rows", "cols"):
                for s, got in enumerate(mod.collect_reads(lay, part, rp, cp,
                                                          side)):
                    needed[s] |= got
        row = col = mod.plan_halo(needed, S, rp)
    else:
        row = mod.plan_halo(mod.collect_reads(lays[0], part, rp, cp, "rows"),
                            S, rp)
        col = mod.plan_halo(mod.collect_reads(lays[0], part, rp, cp, "cols"),
                            S, cp)
    return part, cp, row, col


@pytest.mark.parametrize("nrows", [1, 127, 128, 501, 8192])
@pytest.mark.parametrize("S", [1, 2, 4, 8])
def test_partition_rows(nrows, S):
    p, q = jpart.partition_rows(nrows, S), tpart.partition_rows(nrows, S)
    assert (p.nshards, p.nrows, p.offsets) == (q.nshards, q.nrows, q.offsets)
    assert p.shard_rows == q.shard_rows
    for r in (0, nrows // 2, nrows - 1):
        assert p.owner_of_row(r) == q.owner_of_row(r)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("S", [2, 4, 8])
def test_plans_and_stacks_byte_equal(kind, S):
    Aj, At = operands(kind)
    m, n = At.shape
    sym = kind == "symmetric"
    lj, lt = layouts(Aj), layouts(At)
    pj, cpj, rowj, colj = plans(jpart, lj, sym, m, n, S)
    pt, cpt, rowt, colt = plans(tpart, lt, sym, m, n, S)
    assert cpj == cpt
    for la, lb in zip(lj, lt):
        for side in ("rows", "cols"):
            assert jpart.collect_reads(la, pj, pj.shard_rows, cpj, side) == \
                tpart.collect_reads(lb, pt, pt.shard_rows, cpt, side)
    assert_same_plan(rowj, rowt, "row plan")
    assert_same_plan(colj, colt, "col plan")
    for la, lb in zip(lj, lt):
        sj = jpart.stack_operand(la, pj, cpj, rowj, colj)
        st = tpart.stack_operand(lb, pt, cpt, rowt, colt)
        assert len(sj) == len(st)
        for b, (gj, gt) in enumerate(zip(sj, st)):
            for key in ("loc", "rem"):
                assert gj[key]["chunk"] == gt[key]["chunk"]
                for f in ("values", "rowtab", "coltab"):
                    assert_same(gj[key][f], gt[key][f], f"bucket {b} {key} {f}")


@pytest.mark.parametrize("kind", ["general", "symmetric", "rectangular"])
def test_vectorised_positions_match_scalar_lookups(kind):
    """The array forms of ``elem_pos`` / ``chunk_pos_c`` equal the scalar
    ones (ported verbatim) on every local and halo element."""
    _, At = operands(kind)
    m, n = At.shape
    _, _, row, col = plans(tpart, layouts(At), kind == "symmetric", m, n, 4)
    for plan in (row, col):
        for s in range(plan.S):
            lo = s * plan.per
            halo = [g * tpart.G + o for g in plan.chunk_pos[s]
                    for o in (0, 5, tpart.G - 1)]
            elems = np.array(list(range(lo, lo + plan.per, 7)) + halo)
            assert plan.elem_pos_array(s, elems).tolist() == \
                [plan.elem_pos(s, e) for e in elems]
            for C in (4, 32, 128):
                cc = elems // C
                assert plan.chunk_pos_c_array(s, cc, C).tolist() == \
                    [plan.chunk_pos_c(s, c, C) for c in cc]


@pytest.mark.parametrize("kind", KINDS)
def test_from_reference_carries_the_stacked_arrays(kind):
    """A JAX ``DistributedBlockOperator`` carried across holds the port's own
    stacking of the same base operator, byte for byte, and computes the
    same products."""
    Aj, At = operands(kind)
    S = 4
    Dj = jdistribute(Aj, JaxMesh(np.array(jax.devices()[:S]), ("rows",)))
    mesh = Mesh(["cpu"] * S)
    Dc = bt.from_reference(Dj, mesh=mesh)
    Dt = distribute(At, mesh)
    assert Dc._meta == Dt._meta
    for which in range(2):
        for a, b in zip(Dc._arrays[which], Dt._arrays[which]):
            assert_same(a, b, "send table")
    for pc, pt in zip(Dc._arrays[2], Dt._arrays[2]):
        for rc, rt in zip(pc, pt):
            for gc, gt in zip(rc, rt):
                assert (gc is None) == (gt is None)
                for a, b in zip(gc or (), gt or ()):
                    assert_same(a, b, "stacked group")
    assert Dc.exchanged_bytes_per_call == Dj.exchanged_bytes_per_call
    x = np.random.default_rng(3).standard_normal(At.shape[1])
    got = Dc @ torch.from_numpy(x)
    assert np.abs(got.numpy() - np.asarray(Dj @ x)).max() < 1e-12 * max(
        1.0, float(np.abs(got.numpy()).max()))
