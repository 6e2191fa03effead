"""Merged-patch SpMV (r = 1): CUDA kernel B7, its plain versions, autograd.

The kernel (``csrc/patch_spmv1.cu``) replaces
``blocksparse_tpu/ops/patch_engine.py::_kern1_f``, ``::_kern1_t`` and
``::_kern1_m`` together with the one-hot chunk gathers and scatters that
``patch_spmv_kernel`` ran around them: one launch applies one bucket of a
patch plan (``core/patch.py``) to a vector, gathering x and adding into y
itself.  Modes, for slot b with row window ``rs[b] + m`` and columns
``cc[b, k // 32] * 32 + k % 32``:

  f  y[window] += V_b @ x[columns]                        (A x)
  t  y[columns] += V_b^T @ x[window]                      (A^T x)
  m  both from one read of V_b, the second only on chunks j < mk[b]
     (a symmetric plan: its stored off-diagonal chunks, the JAX ``flag``)
  a  the transpose of m, which the backward pass runs for dx

x indices past len(x) read zero and y indices past ``n_out`` are dropped.
The JAX package's ``patch_kernel_ok`` (G % 8 == 0, a Mosaic tiling rule) has
no counterpart: the kernel takes any slot count.

The live row tiles (:func:`live_row_tiles`): the kernel reads the values
only through a table built on the host beside the plan, one entry per
[8, KP] row tile of a slot that holds a nonzero value, with the chunks up
to its last nonzero one; the plan's whole zero tiles and trailing zero
chunks are never read (:func:`live_tile_bytes`).  For finite x that is
the plan's product; where x holds inf or NaN that only dropped values
face, y stays finite (scipy's product over the blocks), where the plain
version gives NaN (0 * inf).  ``patch_device_arrays`` stages the table
with each bucket; a wrapper given none builds it from the values.

Design (``csrc/patch_spmv1.cu``): kernel B5's ring over that table --
persistent blocks over its ranges, one producer warp feeding 1-D bulk
copies of each live tile's rows (its width, no more) and each stage's
tables into mbarrier ring slots, eight consumer warps; in modes t, m and a
each 128-column stretch of a slot has one owner warp, which sums its
column sums in shared memory and adds them into y once per slot visit.
:func:`patch_spmv1_geometry` reports the launch.

Race-freedom: slots run concurrently and share output rows and columns,
so the kernel adds into a zeroed output with fp32 atomics; the summation
order varies from run to run.  ``tiles_per_block`` moves sums between
registers, shared memory and atomics without changing the product.

Routing: a CPU tensor takes the plain version (:func:`patch_spmv1_plain`);
a CUDA tensor launches the kernel or raises.  ``LAUNCHES`` counts B7's
launches.  :func:`spmv1_plain` is the per-slot contraction alone, with the
JAX kernel's signature, so the tests can hold it against
``_spmv_kernel_raw``.

Gradient: :func:`patch_spmv1_apply` mirrors the JAX ``_spmv1_bwd`` around
the whole product: dx is kernel B7 in the transposed role (f and t swap, m
and a swap), dvals is torch ops on the gathered vectors.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...core.patch import CC, CR
from ...utils import build
from ..torch_spmv import chunk_rows

__all__ = ["spmv1_plain", "patch_spmv1_plain", "patch_spmv1",
           "patch_spmv1_apply", "live_row_tiles", "live_tile_bytes",
           "patch_spmv1_geometry", "MODES", "LAUNCHES"]

LAUNCHES = 0   # kernel B7

MODES = {"f": 0, "t": 1, "m": 2, "a": 3}
_ADJOINT = {"f": "t", "t": "f", "m": "a", "a": "m"}
_DROP = torch.iinfo(torch.int64).max // 2   # an index past any vector


def spmv1_plain(vals, xg, xr, mode: str):
    """The per-slot contractions of the JAX ``_spmv_kernel_raw``:
    ``f`` -> V xg [nb, MP], ``t`` -> V^T xr [nb, KP], ``m`` -> both."""
    if mode == "f":
        return torch.einsum("bmk,bk->bm", vals, xg)
    if mode == "t":
        return torch.einsum("bmk,bm->bk", vals, xr)
    if mode == "m":
        return (torch.einsum("bmk,bk->bm", vals, xg),
                torch.einsum("bmk,bm->bk", vals, xr))
    raise ValueError(f"unknown mode {mode!r}; expected 'f', 't' or 'm'")


def _sides(vals, cc, rs, mk, mode: str):
    """(window rows [nb, MP], the forward pass's column indices, the
    transposed pass's column indices) -- None for a pass the mode lacks;
    masked chunks index past any vector."""
    MP = vals.shape[1]
    win = rs.long()[:, None] + torch.arange(MP, device=rs.device)
    cols = chunk_rows(cc, CC)
    if mode == "f":
        return win, cols, None
    if mode == "t":
        return win, None, cols
    j = torch.arange(cols.shape[1], device=cc.device) // CC
    mir = torch.where(j[None, :] < mk.long()[:, None], cols, _DROP)
    return (win, cols, mir) if mode == "m" else (win, mir, cols)


def live_row_tiles(vals) -> np.ndarray:
    """The live row tiles of one bucket's values [nb, MP, KP]: int32
    [ntiles, 2], one row (b * MP // 8 + mi, width) per [8, KP] row tile mi
    of slot b that holds a nonzero value, in slot and tile order; ``width``
    counts the 32-column chunks up to and including the tile's last chunk
    that holds one.  Every nonzero value lies in a listed tile, below its
    width (NaN counts as nonzero)."""
    v = np.asarray(vals)
    nb, MP, KP = v.shape
    nz = (v.reshape(nb, MP // CR, CR, KP // CC, CC) != 0).any(axis=(2, 4))
    width = np.where(nz.any(axis=-1),
                     KP // CC - np.argmax(nz[..., ::-1], axis=-1), 0)
    tile = np.flatnonzero(width)
    return np.stack([tile, width.reshape(-1)[tile]], axis=1).astype(np.int32)


def live_tile_bytes(tiles) -> int:
    """Value bytes B7 reads for a live row-tile table: 8 rows of each
    tile's width."""
    w = np.asarray(tiles.cpu() if torch.is_tensor(tiles) else tiles)
    return int(w[:, 1].astype(np.int64).sum()) * CR * CC * 4


def patch_spmv1_geometry(ntiles: int, KP: int, mode: str) -> dict:
    """The launch B7 takes on the current card for ``ntiles`` live row
    tiles of width KP in ``mode``, as the kernel's C entry decides it: ring
    ``stages``, dynamic shared-memory bytes, ``blocks``,
    ``tiles_per_block`` and ``per_sm``.  Builds the kernels' library."""
    out = (ctypes.c_longlong * 5)()
    build.check(build.load_library().bst_patch_spmv1_geometry(
        ntiles, KP, MODES[mode], out), "bst_patch_spmv1_geometry")
    return dict(zip(("stages", "smem", "blocks", "tiles_per_block",
                     "per_sm"), out))


def _gather(x, idx):
    n = x.shape[0]
    return torch.cat([x, x.new_zeros(1)])[idx.clamp(max=n)]


def _scatter(n: int, idx, upd):
    return upd.new_zeros(n + 1).index_add_(
        0, idx.reshape(-1).clamp(max=n), upd.reshape(-1))[:n]


def patch_spmv1_plain(vals, cc, rs, mk, x, n_out: int, mode: str):
    """Plain PyTorch version of kernel B7 for one bucket: direct chunk
    gathers and ``index_add_`` where the JAX package used one-hot matmuls;
    any floating dtype."""
    win, fcols, tcols = _sides(vals, cc, rs, mk, mode)
    V = vals.to(x.dtype)
    y = x.new_zeros(n_out)
    if fcols is not None:
        y = y + _scatter(n_out, win, spmv1_plain(V, _gather(x, fcols), None,
                                                 "f"))
    if tcols is not None:
        y = y + _scatter(n_out, tcols, spmv1_plain(V, None, _gather(x, win),
                                                   "t"))
    return y


def _check(vals, cc, rs, mk, x, mode: str) -> bool:
    """Validate one bucket's tensors; True when the kernel is to run (CUDA
    tensors), False for the plain version (CPU tensors)."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {list(MODES)}")
    if vals.ndim != 3 or vals.shape[2] % CC:
        raise ValueError(f"vals must be [nb, MP, KP] with KP % {CC} == 0, "
                         f"got {tuple(vals.shape)}")
    nb, MP, KP = vals.shape
    if tuple(cc.shape) != (nb, KP // CC) or tuple(rs.shape) != (nb,):
        raise ValueError(f"tables {tuple(cc.shape)}, {tuple(rs.shape)} do not "
                         f"match vals {tuple(vals.shape)}")
    tables = (cc, rs)
    if mode in ("m", "a"):
        if mk is None or tuple(mk.shape) != (nb,):
            raise ValueError(f"mode {mode!r} needs mk of shape ({nb},)")
        tables += (mk,)
    if x.ndim != 1:
        raise ValueError(f"x must be a vector [n], got {tuple(x.shape)}")
    if x.dtype != vals.dtype:
        raise TypeError(f"x dtype {x.dtype} != values dtype {vals.dtype}")
    devs = {t.device for t in (vals, x, *tables)}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devs))}")
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if vals.dtype != torch.float32:
        raise TypeError(f"the patch SpMV kernel is float32, got {vals.dtype}")
    if MP % 8 or KP % 128:
        raise ValueError(f"the patch SpMV kernel takes MP % 8 == 0 and "
                         f"KP % 128 == 0, got {MP}x{KP}")
    if any(t.dtype != torch.int32 for t in tables):
        raise TypeError(f"plan tables must be int32, got "
                        f"{[t.dtype for t in tables]}")
    return True


def patch_spmv1(vals, cc, rs, mk, x, n_out: int, mode: str, *, tiles=None,
                tiles_per_block: int | None = None,
                entries=None) -> torch.Tensor:
    """y [n_out] = one patch bucket applied to x [n_in] in ``mode``: kernel
    B7 for CUDA tensors, its plain version for CPU tensors.  ``tiles``: the
    bucket's live row-tile table (:func:`live_row_tiles`, int32 on the
    device; built from ``vals`` when None); ``tiles_per_block``: the range
    of the table each block takes (default: the kernel's geometry).
    ``entries``: the bucket's ``(tile, stored)`` entries, counted with the
    launch (``BucketArrays.entries``)."""
    global LAUNCHES
    if not _check(vals, cc, rs, mk, x, mode):
        return patch_spmv1_plain(vals, cc, rs, mk, x, n_out, mode)
    nb, MP, KP = vals.shape
    if tiles is None:
        tiles = torch.from_numpy(live_row_tiles(
            vals.detach().cpu().numpy())).to(x.device)
    if (tiles.ndim != 2 or tiles.shape[1] != 2 or tiles.dtype != torch.int32
            or tiles.device != x.device):
        raise ValueError(f"tiles must be an int32 [ntiles, 2] table on "
                         f"{x.device}, got {tuple(tiles.shape)} "
                         f"{tiles.dtype} on {tiles.device}")
    x, vals, tiles = x.contiguous(), vals.contiguous(), tiles.contiguous()
    cc, rs = cc.contiguous(), rs.contiguous()
    mk = mk.contiguous() if mode in ("m", "a") else None
    y = torch.zeros(n_out, dtype=torch.float32, device=x.device)
    if nb and n_out and tiles.shape[0]:
        build.launch("bst_patch_spmv1_f32", x.device, vals.data_ptr(),
                     cc.data_ptr(), rs.data_ptr(),
                     None if mk is None else mk.data_ptr(), tiles.data_ptr(),
                     tiles.shape[0], x.data_ptr(), y.data_ptr(), nb, MP, KP,
                     x.shape[0], n_out, MODES[mode], tiles_per_block or 0,
                     entries=entries)
        LAUNCHES += 1
    return y


class _PatchSpmv1(torch.autograd.Function):
    """Exact cotangents (the JAX ``_spmv1_bwd`` around the whole product):
    dx is kernel B7 in the transposed role (on the same live row tiles),
    dvals torch ops on the gathered vectors."""

    @staticmethod
    def forward(ctx, vals, cc, rs, mk, x, n_out, mode, tiles=None,
                entries=None):
        ctx.save_for_backward(vals, cc, rs, mk, x)
        ctx.mode, ctx.tiles, ctx.entries = mode, tiles, entries
        return patch_spmv1(vals, cc, rs, mk, x, n_out, mode, tiles=tiles,
                           entries=entries)

    @staticmethod
    def backward(ctx, g):
        vals, cc, rs, mk, x = ctx.saved_tensors
        g = g.contiguous()
        dvals = dx = None
        if ctx.needs_input_grad[4]:
            dx = _PatchSpmv1.apply(vals, cc, rs, mk, g, x.shape[0],
                                   _ADJOINT[ctx.mode], ctx.tiles,
                                   ctx.entries)
        if ctx.needs_input_grad[0]:
            win, fcols, tcols = _sides(vals, cc, rs, mk, ctx.mode)
            dvals = torch.zeros_like(vals)
            if fcols is not None:   # y[win] += V x[fcols]
                dvals = dvals + _gather(g, win)[:, :, None] * \
                    _gather(x, fcols)[:, None, :]
            if tcols is not None:   # y[tcols] += V^T x[win]
                dvals = dvals + _gather(x, win)[:, :, None] * \
                    _gather(g, tcols)[:, None, :]
        return dvals, None, None, None, dx, None, None, None, None


def patch_spmv1_apply(vals, cc, rs, mk, x, n_out: int, mode: str, *,
                      tiles=None, entries=None):
    """:func:`patch_spmv1` with autograd in ``x`` and ``vals``."""
    return _PatchSpmv1.apply(vals, cc, rs, mk, x, n_out, mode, tiles,
                             entries)
