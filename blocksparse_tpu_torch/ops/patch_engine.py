"""Merged-patch products: CUDA kernels B2, B3 and B7, plain versions, autograd.

Counterpart of ``blocksparse_tpu/ops/patch_engine.py``.  Matrices (r > 1)
run B2 / B3, vectors (r = 1) B7; :func:`patch_apply` routes by rank.
Kernel B2 replaces ``_kern_fwd`` / ``_kern_tr``:

  forward    Y[rs[b] : rs[b] + MP] += V_b @ concat_j X[cc[b, j]*32 : +32]
  transpose  the 32-row chunks cc[b, j] of Y += V_b^T @ X[rs[b] : rs[b] + MP]

The transpose product swaps the gather/scatter roles over the same storage.
Both run on wgmma + TMA after a prologue launch (:func:`patch_xt`) that
writes the K-major copy X^T the tensor cores read -- hi = tf32(X)^T and, at
"highest"/"high", lo = (X - hi)^T.  The forward (``csrc/patch_spmm.cu``)
reads V from shared memory; the transpose (``csrc/patch_spmm_tr.cu``,
:func:`patch_tr`) reads V^T into registers, since TF32 wgmma takes a
shared-memory operand only K-major and V^T is MN-major in V's storage, and
keeps each slot's window of X^T in shared memory.  The transpose takes a
product axis, so it is also ``batched_mm``'s dX (``kernels/batched_spmm.py``).

Kernel B3 (``csrc/patch_sym.cu``) replaces ``_kern_mir``, the product of a
symmetric plan (S = D + O + O^T, off-diagonals stored once): the forward
product, plus the mirrored ``V_b^T @ X[window]`` added into the column
chunks ``j < mk[b]`` (the chunks that hold stored off-diagonal blocks).
Its ``adjoint`` mode is the transpose of that map, which the backward pass
runs for dX.  A symmetric plan is transpose-invariant in its off-diagonal
pair; S^T is the plan built with ``transpose_main=True``
(``core/patch.py``).  B3 runs the mirrored product by chunk ownership: one
block per output chunk sums the transposed contributions of every (slot,
chunk) pair that lands on it and adds the sum once.  The pairs are the
owner tables (:func:`owner_tables`), derived here from the plan for both
modes and carried on each bucket's :class:`BucketArrays`; the plan itself
is the JAX package's, unchanged.

Buffers: the JAX wrapper padded X and Y to ``(NC + 1) * 32`` and
``(NR + MC) * 8`` rows and cut Y afterwards.  Here X and Y keep their true
row counts: rows past X's end read zero (sentinel chunk NC and the ends of
row windows) and rows past Y's end are dropped, which gives the same
result without the copies.

Race-freedom: slots run concurrently and may share output rows, so the
kernels add into a zeroed output (``torch.zeros``) with fp32 atomics (B2's
transpose with the TMA unit's reduce-add, atomic per element, where r % 4
== 0); the summation order varies from run to run.

Precision: B2 and B3 honour the operator's tier (:data:`TIERS`):
"highest" and "high" run 3xTF32 on the tensor cores, None one TF32 pass --
the JAX package's ``_slot_dot`` tiers.  The plain versions, which the CPU
runs, are exact in the operands' dtype at every tier.

Vectors: kernel B7 (``ops/kernels/patch_spmv1.py``, ``csrc/patch_spmv1.cu``)
replaces ``_kern1_f`` / ``_kern1_t`` / ``_kern1_m`` with the one-hot chunk
gathers and scatters around them, in one launch per bucket: mode ``f`` for
A x, ``t`` for A^T x, ``m`` for a symmetric plan (both contributions from
one read of the values), reading only the bucket's live row tiles
(``BucketArrays.tiles``).  :func:`patch_spmv_plain` is the counterpart of
the JAX package's one-hot XLA engine ``patch_spmv``, with direct chunk
gathers and ``index_add_`` in place of the one-hot matmuls.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.patch import CC, PatchPlan
from ..utils import build
from .kernels.patch_spmv1 import (live_row_tiles, patch_spmv1_apply,
                                  patch_spmv1_plain)
from .torch_spmv import chunk_rows, gather_rows, scatter_rows

__all__ = ["patch_device_arrays", "plan_entries", "patch_apply",
           "patch_spmm", "patch_spmm_plain", "patch_spmv", "patch_spmv_plain",
           "bucket_spmm", "bucket_spmm_plain", "patch_xt", "patch_xt_plain",
           "patch_tr", "transpose_spmm", "tr_geometry", "tf32_round",
           "bucket_spmm_sym", "bucket_spmm_sym_plain", "owner_tables",
           "precision_tier", "BucketArrays", "TIERS", "LAUNCHES",
           "XT_LAUNCHES", "TR_LAUNCHES", "SYM_LAUNCHES"]

LAUNCHES = 0       # kernel B2's forward
TR_LAUNCHES = 0    # kernel B2's transpose (A^T X, every dX, batched_mm's dX)
XT_LAUNCHES = 0    # kernel B2's prologue (X^T, one per forward or transpose)
SYM_LAUNCHES = 0   # kernel B3

# precision -> tensor-core tier of kernels B2, B3 and B4: 1 = 3xTF32, 0 =
# one TF32 pass (the JAX package's "highest" / "high" / None of _slot_dot)
TIERS = {"highest": 1, "high": 1, None: 0}


def precision_tier(precision) -> int:
    if precision not in TIERS:
        raise ValueError(f"unknown precision {precision!r}; expected one of "
                         f"{tuple(TIERS)}")
    return TIERS[precision]


class BucketArrays(tuple):
    """One bucket's device tensors ``(vals, cc, rs, mk)``.  ``owners``: on a
    symmetric plan, kernel B3's owner tables of the symmetric (index
    False) and adjoint (index True) modes, each ``(chunk, ptr, pair)``
    int32 tensors; None otherwise.  ``tiles``: kernel B7's live row-tile
    table (``patch_spmv1.live_row_tiles``), int32 [ntiles, 2], or None.
    ``entries``: ``(tile, stored)`` entries a launch over the bucket counts
    (``utils/build.launch``; :func:`plan_entries`), or None."""

    def __new__(cls, arrays, owners=None, tiles=None, entries=None):
        self = super().__new__(cls, arrays)
        self.owners = owners
        self.tiles = tiles
        self.entries = entries
        return self


def plan_entries(plan: PatchPlan) -> list:
    """Per bucket of ``plan``, ``(tile entries, stored entries)``: its
    tiles' value entries, padding included (``nb * MP * KP``), and the
    plan's stored entries (``logical_nnz``: each stored block once,
    off-diagonals too) on its first bucket (``build_patch_plan`` emits
    one), so the sums over a product, which launches every bucket, are
    exact."""
    return [(b.nb * b.MP * b.KP, plan.logical_nnz if i == 0 else 0)
            for i, b in enumerate(plan.buckets)]


def owner_tables(col_chunk: np.ndarray, mirror_kc: np.ndarray, nchunks: int,
                 adjoint: bool) -> tuple:
    """Kernel B3's owner tables of one bucket, in numpy.

    The pairs (slot b, chunk position j) whose transposed product
    ``V_b[:, j*32 : +32]^T @ X[window b]`` lands on a live chunk (id below
    ``nchunks``; the sentinel is ``nchunks``): those with ``j < mk[b]`` in
    the symmetric mode, all of them in the adjoint mode.  Grouped by target
    chunk as a CSR list: ``chunk [no]`` the owning chunks in descending
    fan-in (ties by chunk id), ``ptr [no + 1]``, ``pair [npairs]`` =
    ``b * KC + j``, ascending within a chunk (the kernel's summation order).
    """
    nb, KC = col_chunk.shape
    live = col_chunk < nchunks
    if not adjoint:
        live &= np.arange(KC)[None, :] < mirror_kc[:, None]
    b, j = np.nonzero(live)
    target = col_chunk[b, j].astype(np.int64)
    order = np.argsort(target, kind="stable")
    fan = np.bincount(target, minlength=nchunks)
    chunk = np.nonzero(fan)[0]
    chunk = chunk[np.argsort(-fan[chunk], kind="stable")]
    start = np.concatenate([[0], np.cumsum(fan)])
    ptr = np.concatenate([[0], np.cumsum(fan[chunk])])
    # pair positions in chunk-sorted order, taken owner by owner
    pos = np.repeat(start[chunk] - ptr[:-1], fan[chunk]) + np.arange(ptr[-1])
    pair = (b * KC + j)[order][pos]
    return (chunk.astype(np.int32), ptr.astype(np.int32),
            pair.astype(np.int32))


def patch_device_arrays(plan: PatchPlan, device) -> tuple:
    """Per bucket a :class:`BucketArrays`: (vals f32, cc int32, rs int32,
    mk int32) on ``device``, with B7's live row-tile table and, on a
    symmetric plan, B3's owner tables."""
    nchunks = -(-plan.ncols // CC)
    out = []
    for b, entries in zip(plan.buckets, plan_entries(plan)):
        owners = None
        if plan.symmetric:
            owners = tuple(
                tuple(torch.from_numpy(t).to(device) for t in owner_tables(
                    b.col_chunk, b.mirror_kc, nchunks, adjoint))
                for adjoint in (False, True))
        out.append(BucketArrays(
            (torch.from_numpy(b.vals).to(device),
             torch.from_numpy(b.col_chunk).to(device),
             torch.from_numpy(b.row_start).to(device),
             torch.from_numpy(b.mirror_kc).to(device)), owners,
            torch.from_numpy(live_row_tiles(b.vals)).to(device), entries))
    return tuple(out)


def _window_rows(rs: torch.Tensor, MP: int) -> torch.Tensor:
    return rs.long()[:, None] + torch.arange(MP, device=rs.device)


def bucket_spmm_plain(vals, cc, rs, X, n_out: int, *,
                      transpose: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernel for one bucket."""
    MP = vals.shape[1]
    win, cols = _window_rows(rs, MP), chunk_rows(cc, CC)
    if transpose:
        yt = torch.einsum("bmk,bmr->bkr", vals, gather_rows(X, win))
        return scatter_rows(n_out, cols, yt)
    yp = torch.einsum("bmk,bkr->bmr", vals, gather_rows(X, cols))
    return scatter_rows(n_out, win, yp)


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """float32 ``t`` rounded to TF32 as ``cvt.rna.tf32.f32`` rounds: to the
    nearest value with 10 explicit mantissa bits, ties away from zero (the
    low 13 bits of the result are zero)."""
    bits = t.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = ((bits + 0x1000) & 0xFFFFE000).to(torch.int32)
    return bits.view(torch.float32)


def _xt_ld(n: int) -> int:
    """Row stride of X^T: n rounded up to 4 floats (TMA's 16-byte strides)."""
    return -(-n // 4) * 4


def patch_xt_plain(X: torch.Tensor, tier: int) -> tuple:
    """Plain version of B2's prologue: (hi, lo), each [r, ld] for X [n, r]
    (each [P, r, ld] for X [P, n, r], product by product) with ld = n
    rounded up to 4, hi = tf32(X)^T and lo = (X - tf32(X))^T (None at tier
    0); columns past n are zero."""
    n, r = X.shape[-2:]
    shape = (*X.shape[:-2], r, _xt_ld(n))
    rounded = tf32_round(X)
    hi = X.new_zeros(shape)
    hi[..., :n] = rounded.transpose(-1, -2)
    lo = None
    if tier:
        lo = X.new_zeros(shape)
        lo[..., :n] = (X - rounded).transpose(-1, -2)
    return hi, lo


def patch_xt(X: torch.Tensor, tier: int) -> tuple:
    """B2's prologue: the K-major copy of X [n, r] or [P, n, r] f32 that
    the forward and the transposed kernels read (:func:`patch_xt_plain`
    says what it holds), one launch for all P products.  A CUDA tensor
    launches the kernel (the outputs come from ``torch.empty``), a CPU
    tensor takes the plain version."""
    global XT_LAUNCHES
    if tier not in (0, 1):
        raise ValueError(f"tier must be 0 or 1, got {tier!r}")
    if X.ndim not in (2, 3) or X.dtype != torch.float32:
        raise TypeError(f"X must be [n, r] or [P, n, r] float32, got "
                        f"{tuple(X.shape)} {X.dtype}")
    if X.device.type == "cpu":
        return patch_xt_plain(X, tier)
    if X.device.type != "cuda":
        raise ValueError(f"no kernel for device {X.device}")
    X = X.contiguous()
    n, r = X.shape[-2:]
    P = X.shape[0] if X.ndim == 3 else 1
    ld = _xt_ld(n)
    hi = torch.empty((*X.shape[:-2], r, ld), dtype=torch.float32,
                     device=X.device)
    lo = torch.empty_like(hi) if tier else None
    if n and r and P:
        build.launch("bst_patch_xt_f32", X.device, X.data_ptr(),
                     hi.data_ptr(), None if lo is None else lo.data_ptr(),
                     P, n, r, ld)
        XT_LAUNCHES += 1
    return hi, lo


def tr_geometry(P: int, nb: int, MP: int, KP: int, r: int, tier: int,
                sms: int) -> tuple:
    """(TR, group, blocks) that B2's transposed kernel launches with for
    these shapes on a card of ``sms`` multiprocessors: its column tile, the
    64-row tiles a block computes and the grid's size, as the kernel's entry
    point decides them (``csrc/patch_spmm_tr.cu``, ``geometry``).  Builds
    the kernels' library if needed."""
    out = (ctypes.c_longlong * 3)()
    build.check(build.load_library().bst_patch_tr_geometry(
        P, nb, MP, KP, r, tier, sms, out), "bst_patch_tr_geometry")
    return tuple(out)


def patch_tr(vals, cc, rs, hi, lo, n_in: int, n_out: int,
             tier: int, entries=None) -> torch.Tensor:
    """B2's transposed kernel alone, on CUDA tensors: Y [P, n_out, r] =
    the chunks cc[b, j] of each product's Y += V[p, b]^T @ X[p, window b],
    with X given as the prologue's hi / lo [P, r, ld] of X [P, n_in, r]
    (lo None at tier 0); vals [P, nb, MP, KP] 16-byte aligned, tables
    int32, all contiguous.  The tiles go into Y by the TMA unit's
    reduce-add (atomicAdd where r % 4 != 0); the kernel picks its launch
    geometry (:func:`tr_geometry`).  CPU tensors take the plain version on
    X = (hi + lo)^T.  ``entries``: the launch's ``(tile, stored)`` entries,
    counted with it."""
    global TR_LAUNCHES
    P, nb, MP, KP = vals.shape
    r = hi.shape[1]
    if hi.device.type == "cpu":
        X = (hi if lo is None else hi + lo)[..., :n_in].transpose(-1, -2)
        return torch.stack([bucket_spmm_plain(vals[p], cc, rs, X[p], n_out,
                                              transpose=True)
                            for p in range(P)])
    Y = torch.zeros((P, n_out, r), dtype=torch.float32, device=hi.device)
    if P and nb and r and n_out and n_in:
        build.launch("bst_patch_spmm_tr_f32", hi.device, vals.data_ptr(),
                     cc.data_ptr(), rs.data_ptr(), hi.data_ptr(),
                     None if lo is None else lo.data_ptr(), Y.data_ptr(), P,
                     nb, MP, KP, r, n_in, hi.shape[-1], n_out, tier,
                     entries=entries)
        TR_LAUNCHES += 1
    return Y


def transpose_spmm(vals, cc, rs, X, n_out: int, tier: int,
                   entries=None) -> torch.Tensor:
    """Y [P, n_out, r] = the transposed products of P value stacks vals
    [P, nb, MP, KP] sharing one plan's tables with X [P, n_in, r]: one
    prologue launch and one :func:`patch_tr` launch, for CUDA tensors the
    caller has checked."""
    X = _aligned(X.contiguous())
    vals = _aligned(vals.contiguous())
    P, n_in, r = X.shape
    if not (P and vals.shape[1] and r and n_out and n_in):
        return torch.zeros((P, n_out, r), dtype=torch.float32,
                           device=X.device)
    hi, lo = patch_xt(X, tier)
    return patch_tr(vals, cc.contiguous(), rs.contiguous(), hi, lo, n_in,
                    n_out, tier, entries)


def _check_bucket(vals, cc, rs, X, *extra) -> bool:
    """Validate one bucket's tensors (``extra``: further int32 tables);
    True when the kernel is to run (CUDA tensors), False for the plain
    version (CPU tensors)."""
    tables = (cc, rs, *extra)
    if vals.ndim != 3 or vals.shape[2] % CC:
        raise ValueError(f"vals must be [nb, MP, KP] with KP % {CC} == 0, "
                         f"got {tuple(vals.shape)}")
    nb, MP, KP = vals.shape
    if tuple(cc.shape) != (nb, KP // CC) or tuple(rs.shape) != (nb,):
        raise ValueError(f"tables {tuple(cc.shape)}, {tuple(rs.shape)} do not "
                         f"match vals {tuple(vals.shape)}")
    if X.ndim != 2:
        raise ValueError(f"X must be [n, r], got {tuple(X.shape)}")
    if X.dtype != vals.dtype:
        raise TypeError(f"X dtype {X.dtype} != values dtype {vals.dtype}")
    devs = {t.device for t in (vals, X, *tables)}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devs))}")
    if X.device.type == "cpu":
        return False
    if X.device.type != "cuda":
        raise ValueError(f"no kernel for device {X.device}")
    if vals.dtype != torch.float32:
        raise TypeError(f"the patch SpMM kernels are float32, got {vals.dtype}")
    if any(t.dtype != torch.int32 for t in tables):
        raise TypeError(f"plan tables must be int32, got "
                        f"{[t.dtype for t in tables]}")
    return True


def bucket_spmm(vals, cc, rs, X, n_out: int, *, transpose: bool = False,
                precision="highest", entries=None) -> torch.Tensor:
    """Y [n_out, r] = one patch bucket applied to X [n_in, r]: kernel B2 at
    ``precision``'s tier for CUDA tensors (the forward or the transpose,
    each after its prologue), its plain version (exact at every tier, any
    floating dtype) for CPU tensors.  ``entries``: the bucket's ``(tile,
    stored)`` entries, counted with the launch (``BucketArrays.entries``)."""
    global LAUNCHES
    tier = precision_tier(precision)
    if not _check_bucket(vals, cc, rs, X):
        return bucket_spmm_plain(vals, cc, rs, X, n_out, transpose=transpose)
    if transpose:
        return transpose_spmm(vals[None], cc, rs, X[None], n_out, tier,
                              entries)[0]
    nb, MP, KP = vals.shape
    X = _aligned(X.contiguous())
    vals = _aligned(vals.contiguous())
    cc, rs = cc.contiguous(), rs.contiguous()
    n_in, r = X.shape
    Y = torch.zeros((n_out, r), dtype=torch.float32, device=X.device)
    if not (nb and r and n_out and n_in):
        return Y
    hi, lo = patch_xt(X, tier)
    build.launch("bst_patch_spmm_f32", X.device, vals.data_ptr(),
                 cc.data_ptr(), rs.data_ptr(), hi.data_ptr(),
                 None if lo is None else lo.data_ptr(), Y.data_ptr(),
                 nb, MP, KP, r, n_in, hi.shape[1], n_out, tier,
                 entries=entries)
    LAUNCHES += 1
    return Y


def _mirror_rows(cc, mk):
    """[nb, KP] chunk rows of the mirrored product: column-chunk rows
    for chunks j < mk[b], an out-of-range row (dropped / read as zero)
    elsewhere."""
    cols = chunk_rows(cc, CC)
    j = torch.arange(cols.shape[1], device=cc.device) // CC
    return torch.where(j[None, :] < mk.long()[:, None], cols,
                       torch.iinfo(torch.int64).max // 2)


def _owners_for(cc, mk, n: int, adjoint: bool) -> tuple:
    """:func:`owner_tables` of one bucket's tensors, on their device (for
    callers that pass a bucket without its :class:`BucketArrays`)."""
    tabs = owner_tables(cc.cpu().numpy(), mk.cpu().numpy(), -(-n // CC),
                        adjoint)
    return tuple(torch.from_numpy(t).to(cc.device) for t in tabs)


def bucket_spmm_sym_plain(vals, cc, rs, mk, X, *, adjoint: bool = False,
                          owners=None) -> torch.Tensor:
    """Plain PyTorch version of kernel B3 for one bucket of a symmetric
    plan; X and the result are [n, r].  The same two passes as the kernel:
    the forward product into the slot windows (over every chunk, or the
    chunks ``j < mk[b]`` in the adjoint mode), and the transposed product
    of every pair that ``owners`` -- ``(chunk, ptr, pair)`` of this mode,
    built from ``cc`` and ``mk`` when None -- lists, added into the chunk
    ``cc`` names for it (independently of the kernel's grouping by
    ``chunk`` and ``ptr``)."""
    n, (nb, MP, KP) = X.shape[0], vals.shape
    if owners is None:
        owners = _owners_for(cc, mk, n, adjoint)
    pair = owners[2].long()
    win = _window_rows(rs, MP)
    cols = _mirror_rows(cc, mk) if adjoint else chunk_rows(cc, CC)
    yp = torch.einsum("bmk,bkr->bmr", vals, gather_rows(X, cols))
    yt = torch.einsum("bmk,bmr->bkr", vals, gather_rows(X, win))
    rows = chunk_rows(cc.reshape(-1)[pair][:, None], CC)
    return (scatter_rows(n, win, yp)
            + scatter_rows(n, rows, yt.reshape(nb * (KP // CC), CC, -1)[pair]))


def bucket_spmm_sym(vals, cc, rs, mk, X, *, adjoint: bool = False,
                    owners=None, precision="highest",
                    entries=None) -> torch.Tensor:
    """Y [n, r] = one bucket of a symmetric plan applied to X [n, r] (its
    transpose when ``adjoint``): kernel B3 at ``precision``'s tier for CUDA
    tensors, its plain version (exact at every tier) for CPU tensors.
    ``owners``: the owner tables of this mode (``BucketArrays.owners
    [adjoint]``), built from ``cc`` and ``mk`` when None; ``entries``: the
    bucket's ``(tile, stored)`` entries, counted with the launch."""
    global SYM_LAUNCHES
    tier = precision_tier(precision)
    if tuple(mk.shape) != tuple(rs.shape):
        raise ValueError(f"mk {tuple(mk.shape)} does not match rs "
                         f"{tuple(rs.shape)}")
    if owners is not None and len(owners) != 3:
        raise ValueError("owners must be (chunk, ptr, pair)")
    if not _check_bucket(vals, cc, rs, X, mk, *(owners or ())):
        return bucket_spmm_sym_plain(vals, cc, rs, mk, X, adjoint=adjoint,
                                     owners=owners)
    n, r = X.shape
    if owners is None:
        owners = _owners_for(cc, mk, n, adjoint)
    chunk, ptr, pair = (t.contiguous() for t in owners)
    X = _aligned(X.contiguous())
    vals = _aligned(vals.contiguous())
    cc, rs, mk = cc.contiguous(), rs.contiguous(), mk.contiguous()
    nb, MP, KP = vals.shape
    Y = torch.zeros((n, r), dtype=torch.float32, device=X.device)
    if nb and r and n:
        build.launch("bst_patch_sym_f32", X.device, vals.data_ptr(),
                     cc.data_ptr(), rs.data_ptr(), mk.data_ptr(),
                     chunk.data_ptr(), ptr.data_ptr(), pair.data_ptr(),
                     chunk.numel(), X.data_ptr(), Y.data_ptr(), nb, MP, KP, r,
                     n, int(adjoint), tier, entries=entries)
        SYM_LAUNCHES += 1
    return Y


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself, or a copy where its data is not 16-byte aligned (the
    tensor-core kernels stage it with 16-byte copies)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


class _PatchSpmmSym(torch.autograd.Function):
    """Exact cotangents of kernel B3 (mirrors the ``"mir"`` branch of the
    JAX package's ``patch_engine._spmm_vjp_bwd``): dX is the same kernel
    in its adjoint mode at the same tier, dvals is torch ops on the
    gathered rows.  ``owners``: the bucket's owner tables of both modes
    (``BucketArrays.owners``) or None; ``entries``: its ``(tile, stored)``
    entries or None."""

    @staticmethod
    def forward(ctx, vals, cc, rs, mk, X, adjoint, owners=None,
                precision="highest", entries=None):
        ctx.save_for_backward(vals, cc, rs, mk, X)
        ctx.adjoint, ctx.owners, ctx.precision = adjoint, owners, precision
        ctx.entries = entries
        return bucket_spmm_sym(
            vals, cc, rs, mk, X, adjoint=adjoint, precision=precision,
            owners=None if owners is None else owners[adjoint],
            entries=entries)

    @staticmethod
    def backward(ctx, g):
        vals, cc, rs, mk, X = ctx.saved_tensors
        g = g.contiguous()
        dvals = dX = None
        if ctx.needs_input_grad[4]:
            dX = _PatchSpmmSym.apply(vals, cc, rs, mk, g, not ctx.adjoint,
                                     ctx.owners, ctx.precision, ctx.entries)
        if ctx.needs_input_grad[0]:
            win = _window_rows(rs, vals.shape[1])
            cols, mir = chunk_rows(cc, CC), _mirror_rows(cc, mk)
            # d<g, F X + M X>/dV with F, M the forward and mirrored passes;
            # the adjoint map swaps which of g and X sits on which side
            a, b = (X, g) if ctx.adjoint else (g, X)
            dvals = (torch.einsum("bmr,bkr->bmk", gather_rows(a, win),
                                  gather_rows(b, cols))
                     + torch.einsum("bmr,bkr->bmk", gather_rows(b, win),
                                    gather_rows(a, mir)))
        return dvals, None, None, None, dX, None, None, None, None


class _PatchSpmm(torch.autograd.Function):
    """Exact cotangents (mirrors the JAX package's
    ``patch_engine._spmm_vjp_bwd``): dX is the same kernel in the other
    mode at the same tier, dvals is torch ops on the gathered rows."""

    @staticmethod
    def forward(ctx, vals, cc, rs, X, n_out, transpose, precision="highest",
                entries=None):
        ctx.save_for_backward(vals, cc, rs, X)
        ctx.transpose, ctx.precision = transpose, precision
        ctx.entries = entries
        return bucket_spmm(vals, cc, rs, X, n_out, transpose=transpose,
                           precision=precision, entries=entries)

    @staticmethod
    def backward(ctx, g):
        vals, cc, rs, X = ctx.saved_tensors
        g = g.contiguous()
        dvals = dX = None
        if ctx.needs_input_grad[3]:
            dX = _PatchSpmm.apply(vals, cc, rs, g, X.shape[0],
                                  not ctx.transpose, ctx.precision,
                                  ctx.entries)
        if ctx.needs_input_grad[0]:
            win, cols = _window_rows(rs, vals.shape[1]), chunk_rows(cc, CC)
            if ctx.transpose:
                dvals = torch.einsum("bmr,bkr->bmk", gather_rows(X, win),
                                     gather_rows(g, cols))
            else:
                dvals = torch.einsum("bmr,bkr->bmk", gather_rows(g, win),
                                     gather_rows(X, cols))
        return dvals, None, None, dX, None, None, None, None


def _n_out(plan: PatchPlan, transpose: bool) -> int:
    if plan.symmetric and transpose:
        raise ValueError(
            "a symmetric plan is applied as it is; S^T is the plan built "
            "with transpose_main=True")
    return plan.ncols if transpose else plan.nrows


def patch_spmm(plan: PatchPlan, dev, X, *, transpose: bool = False,
               precision="highest"):
    """Y = A @ X (A^T @ X when ``transpose``); X: [n, r] f32.  A symmetric
    plan runs kernel B3, any other B2, at ``precision``'s tier."""
    n_out = _n_out(plan, transpose)
    Y = None
    for bucket in dev:
        vals, cc, rs, mk = bucket
        entries = getattr(bucket, "entries", None)
        if plan.symmetric:
            part = _PatchSpmmSym.apply(vals, cc, rs, mk, X, False,
                                       getattr(bucket, "owners", None),
                                       precision, entries)
        else:
            part = _PatchSpmm.apply(vals, cc, rs, X, n_out, transpose,
                                    precision, entries)
        Y = part if Y is None else Y + part
    if Y is None:
        return X.new_zeros((n_out, X.shape[1]))
    return Y


def patch_spmm_plain(plan: PatchPlan, dev, X, *, transpose: bool = False):
    """Plain version of :func:`patch_spmm` (counterpart of the JAX
    package's ``patch_spmm_xla``), on any device."""
    n_out = _n_out(plan, transpose)
    Y = X.new_zeros((n_out, X.shape[1]))
    for bucket in dev:
        vals, cc, rs, mk = bucket
        if plan.symmetric:
            owners = getattr(bucket, "owners", None)
            Y = Y + bucket_spmm_sym_plain(
                vals, cc, rs, mk, X,
                owners=None if owners is None else owners[False])
        else:
            Y = Y + bucket_spmm_plain(vals, cc, rs, X, n_out,
                                      transpose=transpose)
    return Y


def _spmv_mode(plan: PatchPlan, transpose: bool) -> tuple:
    """(B7 mode, n_out) of an r = 1 product."""
    n_out = _n_out(plan, transpose)
    return ("m" if plan.symmetric else "t" if transpose else "f"), n_out


def patch_spmv(plan: PatchPlan, dev, x, *, transpose: bool = False):
    """y = A @ x (A^T @ x when ``transpose``); x: [n] f32.  One B7 launch
    per bucket on a CUDA tensor (mode ``m`` on a symmetric plan), the plain
    version on a CPU tensor."""
    mode, n_out = _spmv_mode(plan, transpose)
    y = None
    for bucket in dev:
        vals, cc, rs, mk = bucket
        part = patch_spmv1_apply(vals, cc, rs, mk, x, n_out, mode,
                                 tiles=getattr(bucket, "tiles", None),
                                 entries=getattr(bucket, "entries", None))
        y = part if y is None else y + part
    return x.new_zeros(n_out) if y is None else y


def patch_spmv_plain(plan: PatchPlan, dev, x, *, transpose: bool = False):
    """Plain version of :func:`patch_spmv` (counterpart of the JAX
    package's one-hot engine ``patch_spmv``), on any device."""
    mode, n_out = _spmv_mode(plan, transpose)
    y = x.new_zeros(n_out)
    for vals, cc, rs, mk in dev:
        y = y + patch_spmv1_plain(vals, cc, rs, mk, x, n_out, mode)
    return y


def patch_apply(plan: PatchPlan, dev, x, *, transpose: bool = False,
                precision="highest"):
    """Entry point: x [n] runs :func:`patch_spmv` (kernel B7), x [n, r]
    :func:`patch_spmm` (B2 / B3 at ``precision``'s tier).  A symmetric
    plan is applied as it is (``transpose`` must be False): S^T is the plan
    built with ``transpose_main=True``."""
    if x.ndim == 1:
        return patch_spmv(plan, dev, x, transpose=transpose)
    if x.ndim != 2:
        raise ValueError(f"patch_apply takes [n] or [n, r], got "
                         f"{tuple(x.shape)}")
    return patch_spmm(plan, dev, x, transpose=transpose, precision=precision)
