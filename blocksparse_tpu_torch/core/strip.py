"""Strip/tile layout: uniform [8,128]-tile decomposition + slab plan.

numpy copy of ``blocksparse_tpu/core/strip.py`` (the port cannot import the
JAX package); ``tests/test_torch_stream.py`` holds every field equal to the
original's.  Every block is decomposed into tiles on a fixed [8, 128] grid,
so the whole operand becomes

    vals [S*TS, 8, 128]  (f32, sorted by output row chunk)

cut into S slabs of TS tiles, each slab's row-chunk spread inside an RW
window starting at ``b8[s]``.  The plan keeps the JAX package's one-hot
gather/scatter matrices

    rs [S, RW, TS]   row-chunk scatter one-hot
    cs [S, TS, NC]   col-chunk gather one-hot
    flag [S, 1, TS]  mirror flag per tile (symmetric: off-diag 1, diag 0)

because ``tile_bytes`` and ``aux_bytes`` (which count them) decide the
route (``ops/dispatch.stream_plan_choice``).  The Hopper kernel B8 reads
per-tile integer ids derived from them at staging
(``ops/kernels/slab_spmv.plan_device_arrays``), not the one-hots.

Slabs are cut greedily so each slab's row-chunk spread fits the RW window;
slabs are padded to TS tiles with zero tiles (no row and no column in the
one-hots, so they contribute nothing).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .layout import BlockLayout, is_contiguous

__all__ = ["StripPlan", "build_strip_plan", "plan_from_layout",
           "plan_symmetric", "RC", "CC", "RW"]

RC = 8     # rows per tile / output chunk granularity
CC = 128   # cols per tile / input chunk granularity
RW = 128   # row-chunk window per slab (rows covered = RW * RC = 1024)

_MAX_NC = 256          # cap: ncols <= 32768 (the TPU kernel's resident x)
_MAX_VEC_ROWS = 2**21  # cap: resident x8/y8 footprint on the TPU (8 MB)


@dataclass(frozen=True, eq=False)
class StripPlan:
    """Host-side slab plan."""

    nrows: int
    ncols: int
    S: int          # number of slabs
    TS: int         # tiles per slab
    NC: int         # input col chunks (ncols padded to NC*CC)
    n8p: int        # output row chunks (>= RW; nrows padded to n8p*RC)
    mirror: bool    # symmetric fused pass (square only)
    vals: np.ndarray   # [S*TS, RC, CC] f32
    rs: np.ndarray     # [S, RW, TS] 0/1
    cs: np.ndarray     # [S, TS, NC] 0/1
    flag: np.ndarray   # [S, 1, TS] f32
    b8: np.ndarray     # [S] int32
    nt: int            # real (non-padding) tile count

    @property
    def tile_bytes(self) -> int:
        """Bytes of the tile stream (incl. slab padding)."""
        return int(self.vals.size * self.vals.dtype.itemsize)

    @property
    def aux_bytes(self) -> int:
        """Bytes of the one-hot operators as the JAX package streams them
        (bf16); the route decision reads this."""
        return int((self.rs.size + self.cs.size) * 2 + self.flag.size * 4)


def _tiles_from_blocks(entries):
    """entries: iterable of (block[np 2d], rowstart, colstart, mirror)."""
    tiles, rid, cid, mfl = [], [], [], []
    for b, rs_, cs_, mi in entries:
        b = np.asarray(b, np.float32)
        m, k = b.shape
        if m == 0 or k == 0:
            continue
        ro, co = rs_ % RC, cs_ % CC
        mp = -(-(ro + m) // RC) * RC
        kp = -(-(co + k) // CC) * CC
        pad = np.zeros((mp, kp), np.float32)
        pad[ro:ro + m, co:co + k] = b
        r0, c0 = rs_ // RC, cs_ // CC
        for i in range(mp // RC):
            for j in range(kp // CC):
                t = pad[i * RC:(i + 1) * RC, j * CC:(j + 1) * CC]
                if not t.any() and (i or j):
                    continue  # fully-zero padding tile: skip
                tiles.append(t)
                rid.append(r0 + i)
                cid.append(c0 + j)
                mfl.append(mi)
    if not tiles:
        return None
    tiles = np.stack(tiles)
    rid = np.asarray(rid, np.int64)
    cid = np.asarray(cid, np.int64)
    mfl = np.asarray(mfl, np.float32)
    order = np.argsort(rid, kind="stable")
    return tiles[order], rid[order], cid[order], mfl[order]


def build_strip_plan(entries, shape, *, mirror: bool, TS: int = 512):
    """Build a StripPlan from (block, rowstart, colstart, mirrorflag) entries.

    Returns None when the population yields no tiles or exceeds the
    JAX kernel's residency caps (kept so the route decision is the same).
    """
    nrows, ncols = map(int, shape)
    NC = -(-ncols // CC)
    if NC > _MAX_NC or nrows > _MAX_VEC_ROWS or (mirror and nrows != ncols):
        return None
    built = _tiles_from_blocks(entries)
    if built is None:
        return None
    tiles, rid, cid, mfl = built
    nt = tiles.shape[0]
    n8 = -(-nrows // RC)
    n8p = max(n8, RW)

    # greedy slabs: cut when the row-chunk spread would exceed RW
    slabs = []
    s0 = 0
    while s0 < nt:
        s1 = min(s0 + TS, nt)
        lo = int(rid[s0])
        if int(rid[s1 - 1]) - lo >= RW:
            s1 = s0 + int(np.searchsorted(rid[s0:s1], lo + RW, side="left"))
        slabs.append((s0, s1))
        s0 = s1
    S = len(slabs)

    vals = np.zeros((S * TS, RC, CC), np.float32)
    rs = np.zeros((S, RW, TS), np.float32)
    cs = np.zeros((S, TS, NC), np.float32)
    flag = np.zeros((S, 1, TS), np.float32)
    b8 = np.zeros((S,), np.int32)
    for si, (a, b) in enumerate(slabs):
        cnt = b - a
        base = min(int(rid[a]), n8p - RW)
        b8[si] = base
        vals[si * TS:si * TS + cnt] = tiles[a:b]
        rs[si, rid[a:b] - base, np.arange(cnt)] = 1.0
        cs[si, np.arange(cnt), cid[a:b]] = 1.0
        flag[si, 0, :cnt] = mfl[a:b]
    return StripPlan(
        nrows=nrows, ncols=ncols, S=S, TS=TS, NC=NC, n8p=n8p,
        mirror=bool(mirror), vals=vals, rs=rs, cs=cs, flag=flag, b8=b8, nt=nt,
    )


def _layout_entries(layout: BlockLayout, *, transpose: bool = False,
                    mirror_flag: float = 0.0):
    """(block, rowstart, colstart, mirror) from a BlockLayout.

    Scattered (non-contiguous) index lists embed span-dense: the block's
    values land at their true offsets inside a zero dense patch anchored at
    (min row, min col); ``_tiles_from_blocks`` then skips all-zero [8,128]
    tiles.  Returns None when one list's cover would waste > 8x its logical
    area, or all of them together > 3.2x."""
    out = []
    cover_total = 0
    logical_total = 0
    for i in range(layout.nblocks):
        r = layout.rowindices[i]
        c = layout.colindices[i]
        if r.size == 0 or c.size == 0:
            continue
        blk = layout.extract_block(i)
        logical_total += r.size * c.size
        cover_total += r.size * c.size
        if not (is_contiguous(r) and is_contiguous(c)):
            r64 = np.asarray(r, np.int64)
            c64 = np.asarray(c, np.int64)
            cover = (np.unique(r64 // RC).size * RC
                     * np.unique(c64 // CC).size * CC)
            cover_total += cover - r.size * c.size
            if cover > 8 * max(1, r.size * c.size):
                return None  # pathological single block: no locality at all
            r0, c0 = int(r64.min()), int(c64.min())
            dense = np.zeros(
                (int(r64.max()) - r0 + 1, int(c64.max()) - c0 + 1),
                np.float32,
            )
            dense[np.ix_(r64 - r0, c64 - c0)] = blk
            blk, rs_, cs_ = dense, r0, c0
        else:
            rs_, cs_ = int(r[0]), int(c[0])
        if transpose:
            out.append((blk.T, cs_, rs_, mirror_flag))
        else:
            out.append((blk, rs_, cs_, mirror_flag))
    if cover_total > 3.2 * max(1, logical_total):
        return None  # total dilution too high: scattered engines win
    return out


def plan_from_layout(layout: BlockLayout, *, transpose: bool = False,
                     TS: int = 512):
    """General (non-symmetric) plan for one operand; None if ineligible."""
    if layout.nblocks == 0:
        return None
    dt = np.result_type(*[b.values.dtype for b in layout.buckets])
    if dt != np.float32:
        return None
    entries = _layout_entries(layout, transpose=transpose)
    if entries is None:
        return None
    shape = (layout.ncols, layout.nrows) if transpose else (layout.nrows,
                                                            layout.ncols)
    return build_strip_plan(entries, shape, mirror=False, TS=TS)


def plan_symmetric(dlayout: BlockLayout, olayout: BlockLayout, *,
                   transpose_diag: bool = False, TS: int = 512):
    """Unified symmetric plan: diagonal tiles (mirror 0) and off-diagonal
    tiles (mirror 1) in one stream, so one launch computes S = D + O + O^T.
    ``transpose_diag`` builds the S^T variant (only the diagonal pass
    transposes; the off-diagonal pair is transpose-invariant)."""
    dts = [b.values.dtype for b in dlayout.buckets] + [
        b.values.dtype for b in olayout.buckets]
    if dts and np.result_type(*dts) != np.float32:
        return None
    d_entries = _layout_entries(dlayout, transpose=transpose_diag,
                                mirror_flag=0.0)
    o_entries = _layout_entries(olayout, mirror_flag=1.0)
    if d_entries is None or o_entries is None:
        return None
    return build_strip_plan(d_entries + o_entries,
                            (dlayout.nrows, dlayout.ncols), mirror=True, TS=TS)
