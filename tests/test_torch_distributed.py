"""The port's distributed layer on in-process CPU meshes.

Every case of ``tests/test_distributed.py`` runs here on the same numpy
inputs from a seed: through the JAX ``distribute`` on ``conftest.py``'s 8
virtual CPU devices and through the port's over a :class:`Mesh` of
``"cpu"`` shards (the kernels' plain versions), each held to scipy and the
port to the JAX operator, in float64 (complex128 where the JAX case uses
it) at 1e-12 relative to max(1, max|ref|).  Beside them: the gradient in
``x`` through the distributed operator against the single operator's, the
routing of each shard's groups to B1's and B9's wrappers (counted on the
plain path), sharded operands (``apply_local``), the mesh's checks, and the
utilities the distributed runs use.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

import blocksparse_tpu as bst
import blocksparse_tpu_torch as bt
from blocksparse_tpu.parallel.distributed import distribute as jdistribute
from blocksparse_tpu_torch.ops.kernels import fused_spmm, mask_select
from blocksparse_tpu_torch.parallel.distributed import (
    DistributedBlockOperator, distribute)
from blocksparse_tpu_torch.parallel.mesh import Mesh
from blocksparse_tpu_torch.utils.testmatrices import (random_block_sparse,
                                                      random_symmetric,
                                                      random_vbcrs)

torch.set_num_threads(2)

TOL = 1e-12


def relerr(a, b):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(1.0, float(np.max(np.abs(b))) if b.size else 1.0)
    return float(np.max(np.abs(a - b))) / scale


def jmesh(n):
    return JaxMesh(np.array(jax.devices()[:n]), ("rows",))


def tmesh(n):
    return Mesh(["cpu"] * n)


def both(fmt, *args):
    """(JAX operator, port operator, scipy matrix) on one set of blocks."""
    Aj = getattr(bst, fmt)(*args)
    return Aj, getattr(bt, fmt)(*args, device="cpu"), bst.to_scipy(Aj)


def held(got, jax_out, ref):
    """The port against the JAX operator and both against scipy."""
    assert relerr(got, jax_out) < TOL
    assert relerr(jax_out, ref) < TOL
    assert relerr(got, ref) < TOL


def t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("nshards", [2, 8])
def test_block_sparse_spmv(nshards, rng):
    Aj, At, S = both("BlockSparseMatrix", *random_block_sparse(
        41, shape=(519, 519), nblocks=40, max_block=50, dtype=np.float64))
    x = rng.standard_normal(519)
    D = distribute(At, tmesh(nshards))
    held(D.mv(t(x)), jdistribute(Aj, jmesh(nshards)).mv(x), S @ x)


def test_symmetric_spmv_single_stored(rng):
    """Half-stored off-diagonals distribute without host-side expansion:
    one copy of each block, the mirror fused into the same pass, remote
    rows reached through the reverse halo."""
    args = random_symmetric(42, n=640, ngroups=16, noffdiag=40,
                            dtype=np.float64)
    Aj, At, S = both("SymmetricBlockMatrix", *args)
    D = distribute(At, tmesh(8))
    stored_nnz = sum(
        int(np.count_nonzero(grp[0]))
        for part in D._arrays[2] for row in part for grp in row
        if grp is not None)
    logical = sum(np.count_nonzero(b) for b in args[0]) + sum(
        np.count_nonzero(b) for b in args[2])
    assert stored_nnz == logical
    staged_nnz = sum(int(torch.count_nonzero(v))
                     for shard in D._shards.values()
                     for *_, ch, el in shard.groups
                     for table in (ch, el) if table is not None
                     for v in table.values)
    assert staged_nnz == logical  # the padding slots are not staged
    assert D.row_halo.dists
    Dj = jdistribute(Aj, jmesh(8))
    x = rng.standard_normal(640)
    held(D.mv(t(x)), Dj.mv(x), S @ x)
    held(D.T @ t(x), Dj.T @ x, S.T @ x)


def test_halo_traffic_beats_all_gather(rng):
    """Exchanged bytes << full-x bytes on a BEM-like nearest-neighbour
    coupling; the port's plan moves exactly the JAX plan's bytes."""
    n, ngroups = 8192, 64
    gsz = n // ngroups
    rg = np.random.default_rng(46)
    d = [rg.standard_normal((gsz, gsz)) for _ in range(ngroups)]
    di = [np.arange(i * gsz, (i + 1) * gsz) for i in range(ngroups)]
    o, ri, ci = [], [], []
    for i in range(ngroups - 1):
        o.append(rg.standard_normal((gsz, gsz)))
        ri.append(np.arange(i * gsz, (i + 1) * gsz))
        ci.append(np.arange((i + 1) * gsz, (i + 2) * gsz))
    Aj, At, S = both("SymmetricBlockMatrix", d, di, o, ri, ci, (n, n))
    D = distribute(At, tmesh(8))
    Dj = jdistribute(Aj, jmesh(8))
    all_gather_bytes = (8 - 1) * 8 * D._meta.cols_per * 4 * 8
    assert D.exchanged_bytes_per_call < all_gather_bytes / 10
    assert D.exchanged_bytes_per_call == Dj.exchanged_bytes_per_call
    x = rng.standard_normal(n)
    held(D.mv(t(x)), Dj.mv(x), S @ x)


def test_vbcrs_spmm(rng):
    Aj, At, S = both("VariableBlockCompressedRowStorage", *random_vbcrs(
        43, shape=(800, 800), nrowgroups=16, ncolgroups=16, dtype=np.float64))
    X = rng.standard_normal((800, 6))
    held(distribute(At, tmesh(4)).mm(t(X)), jdistribute(Aj, jmesh(4)).mm(X),
         S @ X)


def test_transpose_and_adjoint_distribution(rng):
    """distribute(A.T) and distribute(A).T share one copy; complex128
    through the kernels' conjugate mode."""
    Aj, At, S = both("BlockSparseMatrix", *random_block_sparse(
        44, shape=(512, 512), nblocks=30, max_block=40,
        dtype=np.complex128))
    x = rng.standard_normal(512) + 1j * rng.standard_normal(512)
    held(distribute(At.T, tmesh(4)).mv(t(x)),
         jdistribute(Aj.T, jmesh(4)).mv(x), S.T @ x)
    held(distribute(At.H, tmesh(4)).mv(t(x)),
         jdistribute(Aj.H, jmesh(4)).mv(x), S.conj().T @ x)
    D, Dj = distribute(At, tmesh(4)), jdistribute(Aj, jmesh(4))
    held(D.T @ t(x), Dj.T @ x, S.T @ x)
    held(D.H @ t(x), Dj.H @ x, S.conj().T @ x)
    held(D.conj() @ t(x), Dj.conj() @ x, S.conj() @ x)


def test_rectangular_transpose(rng):
    """Non-square: the transpose crosses between the row and col
    partitions (a halo plan per side)."""
    Aj, At, S = both("BlockSparseMatrix", *random_block_sparse(
        47, shape=(700, 350), nblocks=30, max_block=40, dtype=np.float64))
    D, Dj = distribute(At, tmesh(4)), jdistribute(Aj, jmesh(4))
    x = rng.standard_normal(350)
    xt = rng.standard_normal(700)
    held(D @ t(x), Dj @ x, S @ x)
    held(D.T @ t(xt), Dj.T @ xt, S.T @ xt)


def test_operator_algebra(rng):
    """axpby, scaling, sum and composition under distribution."""
    Aj, At, S = both("BlockSparseMatrix", *random_block_sparse(
        48, shape=(512, 512), nblocks=25, max_block=40, dtype=np.float64))
    D, Dj = distribute(At, tmesh(4)), jdistribute(Aj, jmesh(4))
    x = rng.standard_normal(512)
    y = rng.standard_normal(512)
    held(D.axpby(t(x), t(y), 2.5, 0.5), Dj.axpby(x, y, 2.5, 0.5),
         2.5 * (S @ x) + 0.5 * y)
    held((3.0 * D) @ t(x), (3.0 * Dj) @ x, 3.0 * (S @ x))
    held((D + D) @ t(x), (Dj + Dj) @ x, 2.0 * (S @ x))
    held((D.T @ D) @ t(x), (Dj.T @ Dj) @ x, S.T @ (S @ x))


def test_distributed_cg(rng):
    """CG solves an SPD block system through the 8-shard operator: the
    port's ``cg`` on the operator, the JAX CG on its closure."""
    d, di, o, ri, ci, shape = random_symmetric(
        49, n=512, ngroups=16, noffdiag=24, dtype=np.float64)
    d = [b + b.T + 50.0 * np.eye(b.shape[0]) for b in d]
    Aj, At, S = both("SymmetricBlockMatrix", d, di, o, ri, ci, shape)
    D = distribute(At, tmesh(8))
    b = rng.standard_normal(512)
    x, info = bt.cg(D, t(b), tol=1e-10, maxiter=500)
    assert bool(info.converged)
    xj, _ = jax.scipy.sparse.linalg.cg(
        jdistribute(Aj, jmesh(8)).matvec_closure(), jnp.asarray(b),
        tol=1e-10, maxiter=500)
    xs, _ = bt.cg(At, t(b), tol=1e-10, maxiter=500)
    assert relerr(x, xs) < 1e-10
    assert relerr(x, xj) < 1e-8
    res = S @ x.numpy() - b
    assert float(np.linalg.norm(res) / np.linalg.norm(b)) < 1e-8


def test_uneven_rows(rng):
    """nrows not divisible by nshards -> padded partition; the buffers end
    exactly at the sentinels."""
    Aj, At, S = both("BlockSparseMatrix", *random_block_sparse(
        45, shape=(501, 503), nblocks=25, max_block=30, dtype=np.float64))
    x = rng.standard_normal(503)
    held(distribute(At, tmesh(8)).mv(t(x)), jdistribute(Aj, jmesh(8)).mv(x),
         S @ x)


def test_spmm_wide_rhs(rng):
    Aj, At, S = both("SymmetricBlockMatrix", *random_symmetric(
        50, n=512, ngroups=16, noffdiag=24, dtype=np.float64))
    X = rng.standard_normal((512, 64))
    held(distribute(At, tmesh(8)).mm(t(X)), jdistribute(Aj, jmesh(8)).mm(X),
         S @ X)


def test_2d_mesh_spmm(rng):
    """2-D block-rows x RHS-columns mesh: one ring per RHS column group
    (r = 6 pads to 8: 2 groups of 4)."""
    args = random_block_sparse(17, shape=(512, 512), nblocks=24,
                               dtype=np.float64, contiguous=True)
    Aj = bst.BlockSparseMatrix(*args, backend="xla")
    At = bt.BlockSparseMatrix(*args, device="cpu")
    S = bst.to_scipy(Aj)
    Dj = jdistribute(Aj, JaxMesh(np.array(jax.devices()[:8]).reshape(4, 2),
                                 ("rows", "rhs")), rhs_axis="rhs")
    mesh2 = Mesh(np.array(["cpu"] * 8).reshape(4, 2), ("rows", "rhs"))
    D = distribute(At, mesh2, rhs_axis="rhs")
    X = rng.standard_normal((512, 6))
    Y = D @ t(X)
    assert Y.shape == (512, 6)
    held(Y, Dj @ jnp.asarray(X), S @ X)
    held(D.T @ t(X), Dj.T @ jnp.asarray(X), S.T @ X)
    x = rng.standard_normal(512)
    held(D @ t(x), Dj @ jnp.asarray(x), S @ x)
    # rows along the mesh's second axis: the same operator
    mesh_t = Mesh(np.array(["cpu"] * 8).reshape(2, 4), ("rhs", "rows"))
    held(distribute(At, mesh_t, rhs_axis="rhs") @ t(X), Dj @ jnp.asarray(X),
         S @ X)


@pytest.mark.parametrize("fmt", ["BlockSparseMatrix", "SymmetricBlockMatrix"])
def test_gradient_matches_the_single_operator(fmt, rng):
    """x's gradient through D (forward and transpose) against the single
    operator's, through the autograd forms of B1 and B9's element pass."""
    args = (random_symmetric(42, n=640, ngroups=16, noffdiag=40,
                             dtype=np.float64)
            if fmt == "SymmetricBlockMatrix" else
            random_block_sparse(17, shape=(512, 512), nblocks=24,
                                dtype=np.float64, contiguous=True))
    A = getattr(bt, fmt)(*args, device="cpu")
    D = distribute(A, tmesh(4))
    n = A.shape[1]
    w = t(rng.standard_normal(n))
    for op, ref in ((D, A), (D.T, A.T)):
        x0 = t(rng.standard_normal(n))
        grads = []
        for M in (op, ref):
            x = x0.clone().requires_grad_()
            (w @ (M @ x)).backward()
            grads.append(x.grad)
        assert relerr(grads[0], grads[1].numpy()) < TOL


EMPTY_SHARD_ARGS = {
    "BlockSparseMatrix": lambda: random_block_sparse(
        15, shape=(519, 519), nblocks=40, max_block=50, dtype=np.float64),
    "SymmetricBlockMatrix": lambda: random_symmetric(
        15, n=500, ngroups=12, noffdiag=20, dtype=np.float64),
    "VariableBlockCompressedRowStorage": lambda: random_vbcrs(
        10, shape=(500, 500), nrowgroups=10, ncolgroups=10),
}


@pytest.mark.parametrize("fmt", sorted(EMPTY_SHARD_ARGS))
@pytest.mark.parametrize("rhs", [None, 2], ids=["1d", "2d"])
def test_gradient_with_an_empty_shard(fmt, rhs, rng):
    """x's gradient through D and D.T when the last of 3 shards holds no
    blocks (its rows all padding, or none of the blocks'), against
    ``jax.grad`` through the JAX ``distribute`` on a mesh of the same
    shape and against scipy: on a 1-D mesh with x [n], and on a 3 x 2 mesh
    with the RHS axis and x [n, 4]."""
    Aj, At, _ = both(fmt, *EMPTY_SHARD_ARGS[fmt]())
    n = At.shape[1]
    if rhs is None:
        mesh, jm, kw, cols = tmesh(3), jmesh(3), {}, ()
    else:
        mesh = Mesh(np.array(["cpu"] * 3 * rhs).reshape(3, rhs),
                    ("rows", "rhs"))
        jm = JaxMesh(np.array(jax.devices()[:3 * rhs]).reshape(3, rhs),
                     ("rows", "rhs"))
        kw, cols = {"rhs_axis": "rhs"}, (2 * rhs,)
    D = distribute(At, mesh, **kw)
    assert any(not shard.groups for shard in D._shards.values())
    Dj = jdistribute(Aj, jm, **kw)
    S = bst.to_scipy(Aj)
    for op, jop, ref in ((D, Dj, S.T), (D.T, Dj.T, S)):
        w = rng.standard_normal((n,) + cols)
        x0 = rng.standard_normal((n,) + cols)
        x = t(x0).requires_grad_()
        (t(w) * (op @ x)).sum().backward()
        want = jax.grad(lambda v: jnp.sum(jnp.asarray(w) * (jop @ v)))(
            jnp.asarray(x0))
        assert relerr(x.grad, want) < TOL
        assert relerr(x.grad, ref @ w) < TOL


def test_shard_groups_route_to_b1_and_b9(monkeypatch, rng):
    """Per shard, a chunked group goes to B1's multi-bucket wrapper and an
    element group to B9's element pass: counted on the plain path, one
    call per non-empty table."""
    calls = {"B1": 0, "B9 element": 0}

    def counting(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(fused_spmm, "multi_block_apply",
                        counting("B1", fused_spmm.multi_block_apply))
    monkeypatch.setattr(mask_select, "element_apply",
                        counting("B9 element", mask_select.element_apply))
    args = random_symmetric(42, n=640, ngroups=16, noffdiag=40,
                            dtype=np.float64)
    scattered = bt.SymmetricBlockMatrix(*args, device="cpu")
    contiguous = bt.BlockSparseMatrix(*random_block_sparse(
        17, shape=(512, 512), nblocks=24, dtype=np.float64, contiguous=True),
        device="cpu")
    for A in (scattered, contiguous):
        D = distribute(A, tmesh(4))
        want = D.tables()
        kinds = {"B1": set(), "B9 element": set()}
        for shard in D._shards.values():
            for kind, key, ch, el in shard.groups:
                assert ch is None or all(c > 1 for *_, c in ch.buckets)
                assert el is None or all(c == 1 for *_, c in el.buckets)
                kinds["B1"] |= {kind} if ch is not None else set()
                kinds["B9 element"] |= {kind} if el is not None else set()
        want = {k: want[k] for k in calls}
        for product in (lambda v: D @ v, lambda v: D.T @ v):
            calls.update({"B1": 0, "B9 element": 0})
            product(t(rng.standard_normal(A.shape[0])))
            assert calls == want
        assert want["B1"] + want["B9 element"] > 0
    assert want["B1"] > 0  # the contiguous operand has chunked groups


def test_apply_local_on_sharded_vectors(rng):
    Aj, At, S = both("BlockSparseMatrix", *random_block_sparse(
        47, shape=(700, 350), nblocks=30, max_block=40, dtype=np.float64))
    D = distribute(At, tmesh(4))
    rp, cp = D._meta.rows_per, D._meta.cols_per
    x = np.zeros(4 * cp)
    x[:350] = rng.standard_normal(350)
    ys = D.apply_local({s: t(x[s * cp:(s + 1) * cp]) for s in range(4)})
    y = torch.cat([ys[s] for s in range(4)])[:700]
    assert relerr(y, S @ x[:350]) < TOL
    xt = np.zeros(4 * rp)
    xt[:700] = rng.standard_normal(700)
    yt = D.apply_local({s: t(xt[s * rp:(s + 1) * rp]) for s in range(4)},
                       transpose=True)
    assert relerr(torch.cat([yt[s] for s in range(4)])[:350],
                  S.T @ xt[:700]) < TOL


def test_mixed_operand_dtypes(rng):
    """Operands of another dtype promote as the single operator's do."""
    args = random_block_sparse(17, shape=(512, 512), nblocks=24,
                               dtype=np.float32, contiguous=True)
    A = bt.BlockSparseMatrix(*args, device="cpu")
    D = distribute(A, tmesh(4))
    x = rng.standard_normal(512) + 1j * rng.standard_normal(512)
    for v in (t(x), t(x.real), t(x.real.astype(np.float32)),
              t(np.arange(512))):
        got, want = D @ v, A @ v
        assert got.dtype == want.dtype
        assert relerr(got, want.numpy()) < 1e-6


def test_mesh_checks():
    with pytest.raises(ValueError, match="axis names"):
        Mesh(["cpu"] * 4, ("rows", "rhs"))
    with pytest.raises(ValueError, match="'cpu' or 'cuda'"):
        Mesh(["meta"] * 2)
    with pytest.raises(ValueError, match="ranks of shape"):
        Mesh(["cpu"] * 4, ranks=[0, 0])
    mesh = Mesh(np.array(["cpu"] * 8).reshape(4, 2), ("rows", "rhs"))
    assert mesh.shape == {"rows": 4, "rhs": 2} and not mesh.multiprocess
    assert mesh.local_devices == [torch.device("cpu")]
    A = bt.BlockSparseMatrix(*random_block_sparse(
        17, shape=(256, 256), nblocks=8, dtype=np.float64), device="cpu")
    with pytest.raises(ValueError, match="rhs_axis"):
        distribute(A, mesh, rhs_axis="cols")
    with pytest.raises(ValueError, match="distribute\\(A\\).T"):
        DistributedBlockOperator(A.T, mesh)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            Mesh(["cuda:0"] * 2)
