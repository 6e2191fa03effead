"""The port's kernel modules on the CPU: plain versions vs the JAX kernels.

Each CUDA kernel of the port has a plain PyTorch version in the same module,
which its wrapper takes for CPU tensors.  Here those plain versions are held
against the JAX package's Pallas kernels run in interpret mode on the same
numpy inputs (f64 at 1e-13, f32 at 1e-5 relative to max(1, max|ref|)), and
the autograd Functions around the kernels are checked with gradcheck.  The
kernels themselves run only on a CUDA card: ``chip_smoke.py`` compares them
with these plain versions there.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from blocksparse_tpu.core.layout import build_layout as jax_build_layout
from blocksparse_tpu.core.patch import build_patch_plan as jax_build_patch_plan
from blocksparse_tpu.ops import patch_engine as jax_patch
from blocksparse_tpu.ops.pallas import mask_select as jax_mask
from blocksparse_tpu.ops.pallas.fused_spmm import chunked_block_apply as jax_cba
from blocksparse_tpu.ops.xla_spmv import bucket_apply as jax_bucket_apply

from blocksparse_tpu_torch.core.layout import build_layout
from blocksparse_tpu_torch.core.patch import build_patch_plan
from blocksparse_tpu_torch.ops import patch_engine
from blocksparse_tpu_torch.ops.kernels import fused_spmm, mask_select
from blocksparse_tpu_torch.ops.torch_spmv import bucket_apply
from blocksparse_tpu_torch.utils import build
from blocksparse_tpu_torch.utils.testmatrices import random_block_sparse

torch.set_num_threads(2)

TOL = {np.float64: 1e-13, np.float32: 1e-5}


def relerr(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape
    return float(np.max(np.abs(a - b))) / max(1.0, float(np.max(np.abs(b))))


def chunk_inputs(kind, dtype):
    """(vals, row_chunk, col_chunk, C, n) as numpy."""
    if kind == "layout":
        blocks, rows, cols, shape = random_block_sparse(
            21, shape=(192, 192), nblocks=10, max_block=40, dtype=np.float64,
            contiguous=True)
        lay = build_layout([b.astype(dtype) for b in blocks], rows, cols,
                           shape)
        hb = max((b for b in lay.buckets if b.chunk > 1),
                 key=lambda b: b.nblocks)
        return hb.values, hb.row_chunk_idx, hb.col_chunk_idx, hb.chunk, 192
    rng = np.random.default_rng(22)
    n, nb, mp, kp, C = 160, 6, 16, 32, 8
    vals = rng.standard_normal((nb, mp, kp)).astype(dtype)
    rc = rng.integers(0, n // C, (nb, mp // C)).astype(np.int32)
    cc = rng.integers(0, n // C, (nb, kp // C)).astype(np.int32)
    return vals, rc, cc, C, n


MODES = {"forward": dict(), "transpose": dict(transpose=True),
         "symmetric": dict(symmetric=True)}


@pytest.mark.parametrize("r", [1, 3])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("kind", ["layout", "scattered-tables"])
def test_fused_plain_vs_jax_interpret(kind, dtype, mode, r):
    vals, rc, cc, C, n = chunk_inputs(kind, dtype)
    rng = np.random.default_rng(23)
    x = rng.standard_normal((n, r) if r > 1 else n).astype(dtype)
    ref = jax_cba(jnp.asarray(vals), jnp.asarray(rc), jnp.asarray(cc), C,
                  jnp.asarray(x), n, interpret=True, **MODES[mode])
    t = torch.from_numpy
    got = fused_spmm.chunked_block_apply_plain(t(vals), t(rc), t(cc), C,
                                               t(x), n, **MODES[mode])
    assert got.dtype == t(vals).dtype
    assert relerr(got.numpy(), ref) <= TOL[dtype]
    # the wrapper takes the plain version for CPU tensors and launches nothing
    before = fused_spmm.LAUNCHES
    wrapped = fused_spmm.chunked_block_apply(t(vals), t(rc), t(cc), C, t(x),
                                             n, **MODES[mode])
    assert torch.equal(wrapped, got)
    assert fused_spmm.LAUNCHES == before


def patch_inputs(seed=31, n=256):
    blocks, rows, cols, shape = random_block_sparse(
        seed, shape=(n, n - 32), nblocks=12, max_block=50, dtype=np.float64,
        contiguous=True)
    blocks = [b.astype(np.float32) for b in blocks]
    mine = build_patch_plan(build_layout(blocks, rows, cols, shape))
    ref = jax_build_patch_plan(
        jax_build_layout(blocks, rows, cols, shape, granularity="pow2"))
    return mine, ref, shape


@pytest.mark.parametrize("r", [2, 5])
@pytest.mark.parametrize("transpose", [False, True])
def test_patch_plain_vs_jax_interpret(transpose, r):
    mine, ref, shape = patch_inputs()
    rng = np.random.default_rng(32)
    X = rng.standard_normal((shape[0] if transpose else shape[1], r)).astype(
        np.float32)
    want = jax_patch.patch_spmm(ref, jax_patch.patch_device_arrays(ref),
                                jnp.asarray(X), transpose=transpose,
                                interpret=True)
    dev = patch_engine.patch_device_arrays(mine, "cpu")
    got = patch_engine.patch_spmm_plain(mine, dev, torch.from_numpy(X),
                                        transpose=transpose)
    assert relerr(got.numpy(), want) <= TOL[np.float32]
    before = patch_engine.LAUNCHES
    wrapped = patch_engine.patch_spmm(mine, dev, torch.from_numpy(X),
                                      transpose=transpose)
    assert relerr(wrapped.numpy(), want) <= TOL[np.float32]
    assert patch_engine.LAUNCHES == before


@pytest.mark.parametrize("mode", list(MODES))
def test_fused_gradcheck(mode):
    """B1's autograd on a one-bucket table (the bucket route's call)."""
    vals, rc, cc, C, n = chunk_inputs("scattered-tables", np.float64)
    vals = vals[:3, :8, :16].copy()
    rc, cc = rc[:3, :1].copy(), cc[:3, :2].copy()
    t = torch.from_numpy
    v = t(vals).requires_grad_()
    x = torch.randn(n, 2, dtype=torch.float64, requires_grad=True)

    def fn(v_, x_):
        table = fused_spmm.BucketTable([(v_, t(rc), t(cc), C)])
        return fused_spmm.multi_fused_apply(
            table, x_, out=torch.zeros(n, 2, dtype=torch.float64),
            **MODES[mode])
    assert torch.autograd.gradcheck(fn, (v, x))


@pytest.mark.parametrize("transpose", [False, True])
def test_patch_gradcheck(transpose):
    mine, _, shape = patch_inputs(seed=33, n=96)
    vals, cc, rs, _mk = patch_engine.patch_device_arrays(mine, "cpu")[0]
    vals = vals[:4].double().requires_grad_()
    cc, rs = cc[:4], rs[:4]
    n_in, n_out = (shape[0], shape[1]) if transpose else (shape[1], shape[0])
    X = torch.randn(n_in, 2, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda v_, x_: patch_engine._PatchSpmm.apply(v_, cc, rs, x_, n_out,
                                                     transpose),
        (vals, X))


def test_wrappers_refuse_other_devices_and_bad_inputs():
    vals, rc, cc, C, n = chunk_inputs("scattered-tables", np.float32)
    t = torch.from_numpy
    x = torch.zeros(n)
    meta = [a.to("meta") for a in (t(vals), t(rc), t(cc), x)]
    with pytest.raises(ValueError, match="no kernel for device"):
        fused_spmm.chunked_block_apply(*meta[:3], C, meta[3], n)
    with pytest.raises(ValueError, match="different devices"):
        fused_spmm.chunked_block_apply(t(vals), t(rc), t(cc), C, meta[3], n)
    # float32 values take a float32 or float64 operand, not a complex one
    with pytest.raises(TypeError, match="dtype"):
        fused_spmm.chunked_block_apply(t(vals), t(rc), t(cc), C,
                                       x.to(torch.complex64), n)
    with pytest.raises(ValueError, match="square"):
        fused_spmm.chunked_block_apply(t(vals), t(rc), t(cc), C, x, n + 8,
                                       symmetric=True)
    with pytest.raises(ValueError, match="transpose-invariant"):
        fused_spmm.chunked_block_apply(t(vals), t(rc), t(cc), C, x, n,
                                       transpose=True, symmetric=True)
    mine, _, shape = patch_inputs()
    pv, pcc, prs, _ = patch_engine.patch_device_arrays(mine, "cpu")[0]
    X = torch.zeros(shape[1], 2)
    with pytest.raises(ValueError, match="no kernel for device"):
        patch_engine.bucket_spmm(pv.to("meta"), pcc.to("meta"),
                                 prs.to("meta"), X.to("meta"), shape[0])
    with pytest.raises(TypeError, match="dtype"):
        patch_engine.bucket_spmm(pv, pcc, prs, X.double(), shape[0])


def mask_inputs(n, K, seed):
    """f32 x [n], int32 indices [K // 8, 8] with duplicates and sentinels."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(np.float32)
    idx = rng.integers(0, n, K).astype(np.int32)
    idx[::7] = n          # the layout's sentinel
    idx[3::11] = n + 5    # past it: also reads 0 / drops
    return x, idx.reshape(K // 8, 8)


@pytest.mark.parametrize("n,K", [(300, 4096), (1000, 9000)])
def test_mask_plain_vs_jax_interpret(n, K):
    x, idx = mask_inputs(n, K, seed=n)
    t = torch.from_numpy
    want = jax_mask.mask_gather(jnp.asarray(x), jnp.asarray(idx),
                                interpret=True)
    got = mask_select.mask_gather_plain(t(x), t(idx))
    assert got.shape == idx.shape
    assert relerr(got.numpy(), want) <= TOL[np.float32]
    v = np.random.default_rng(n + 1).standard_normal(K).astype(np.float32)
    want = jax_mask.mask_scatter_add(jnp.asarray(v), jnp.asarray(idx), n,
                                     interpret=True)
    got_s = mask_select.mask_scatter_add_plain(t(v), t(idx), n)
    assert relerr(got_s.numpy(), want) <= TOL[np.float32]
    # the wrappers take the plain versions for CPU tensors, launching nothing
    before = (mask_select.GATHER_LAUNCHES, mask_select.SCATTER_LAUNCHES)
    assert torch.equal(mask_select.mask_gather(t(x), t(idx)), got)
    assert torch.equal(mask_select.mask_scatter_add(t(v), t(idx), n), got_s)
    assert (mask_select.GATHER_LAUNCHES,
            mask_select.SCATTER_LAUNCHES) == before


@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("transpose", [False, True])
def test_element_engine_mask_route_vs_jax(transpose, symmetric):
    """bucket_apply with the B9 route against the JAX element engine with
    its mask-select kernels in interpret mode: one bucket with 4096-index
    tables (the JAX engine takes its kernels there) and one below that."""
    n = 400
    rng = np.random.default_rng(35)
    elem = []
    for nb, mp, kp in ((64, 64, 64), (3, 8, 16)):
        ridx = rng.integers(0, n, (nb, mp)).astype(np.int32)
        cidx = rng.integers(0, n, (nb, kp)).astype(np.int32)
        ridx[:, -1] = n   # sentinel lanes of the padded tile
        cidx[:, -2:] = n
        vals = rng.standard_normal((nb, mp, kp)).astype(np.float32)
        elem.append((vals, ridx, cidx))
    x = rng.standard_normal(n).astype(np.float32)
    want = jax_bucket_apply([tuple(map(jnp.asarray, e)) for e in elem], n,
                            jnp.asarray(x), transpose=transpose,
                            symmetric=symmetric, mask_gs="interpret",
                            precision="highest")
    t = torch.from_numpy
    got = bucket_apply([tuple(map(t, e)) for e in elem], n, t(x),
                       transpose=transpose, symmetric=symmetric,
                       mask_gs=True)
    assert relerr(got.numpy(), want) <= TOL[np.float32]


def test_mask_gradcheck():
    x, idx = mask_inputs(40, 64, seed=37)
    t = torch.from_numpy
    xg = t(x).double().requires_grad_()
    v = torch.randn(64, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda a: mask_select.gather_apply(a, t(idx)), (xg,))
    assert torch.autograd.gradcheck(
        lambda a: mask_select.scatter_apply(a, t(idx).reshape(-1), 40), (v,))


def test_mask_wrappers_refuse_bad_inputs():
    x, idx = mask_inputs(40, 64, seed=38)
    t = torch.from_numpy
    with pytest.raises(ValueError, match="no kernel for device"):
        mask_select.mask_gather(t(x).to("meta"), t(idx).to("meta"))
    with pytest.raises(ValueError, match="different devices"):
        mask_select.mask_gather(t(x), t(idx).to("meta"))
    with pytest.raises(ValueError, match="1-D"):
        mask_select.mask_gather(t(x)[:, None], t(idx))
    with pytest.raises(ValueError, match="elements"):
        mask_select.mask_scatter_add(t(x), t(idx), 40)


def test_build_needs_nvcc(monkeypatch, tmp_path):
    """No nvcc: the build raises instead of falling back."""
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build, "Path", lambda p: tmp_path / "missing-nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load_library()
    assert not list(tmp_path.iterdir())


def test_build_digest_tracks_sources():
    d = build._digest()
    assert d == build._digest() and len(d) == 16
    names = {p.name for p in build._sources()}
    assert {"fused_spmm.cu", "patch_spmm.cu", "patch_sym.cu",
            "mask_select.cu"} <= names
