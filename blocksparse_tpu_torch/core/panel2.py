"""Panel layout v2: SEG-parametric K-merged canvases with greedy covers.

numpy copy of ``blocksparse_tpu/core/panel2.py`` (the port cannot import
the JAX package); ``tests/test_torch_panel2.py`` holds every array it emits
byte-equal to the original's.  It is v1's packing (``core/panel.py``) with
one change of column cover:

* **Greedy 0-aligned segment covers.**  Any column index list is covered by
  a greedy sweep of SEG-wide windows on the natural grid of
  ``x.reshape(-1, SEG)``: one grid, no shifted copies, so lane ``l`` of a
  panel chunk reads ``x[segid * seg + l % seg]`` directly.
* **SEG is a plan parameter (8 / 16 / 32).**  A smaller SEG pads blocks
  less; a larger one keeps the segment tables smaller.  ``choose_seg``
  builds the two best-covering candidates and keeps the cheaper plan.
* **Mirror (fused symmetric) plans** carry, per panel segment, the y
  segment its mirrored sums land in (``tgt``, sentinel ``n_yseg``).

Kernel B10 (``ops/kernels/panel2_spmv.py``) streams the plan.  The
cost-model constants (``_STEP_TAX``, ``_ROW_COVER_CAP``, ``_MAX_CANVAS``,
``_MIRROR_RATE_PENALTY2`` and ``choose_seg``'s gather and map-back weights)
are the JAX package's, measured on a TPU v5e, and kept as they are so the
port plans as the JAX package does; they await measurement on the H100
(ROADMAP D18).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .layout import BlockLayout, is_contiguous
from .panel import _balanced_cuts
from .strip import CC, RC

__all__ = ["Panel2Plan", "build_panel2_plan", "panel2_plan_from_layout",
           "panel2_plan_symmetric", "choose_seg", "greedy_cover"]

# v5e rules, kept verbatim (ROADMAP D18)
_ROW_COVER_CAP = 3.2   # scattered rows: max tile-cover dilution
_MAX_CANVAS = 1 << 26  # per-panel canvas element cap (host memory guard)
_STEP_TAX = 1 << 18    # per-grid-step overhead, stream-byte equivalents
_GATHER_ROW_COST = 330     # choose_seg: stream bytes per gathered x segment
_MAPBACK_COST = 2.5        # choose_seg: per map-back one-hot element
# end-to-end flip point of the fused mirror plan against the expanded one
_MIRROR_RATE_PENALTY2 = 1.4


@dataclass(frozen=True, eq=False)
class Panel2Plan:
    """Host-side v2 panel plan."""

    nrows: int
    ncols: int
    seg: int            # segment width (8 / 16 / 32 lanes)
    S: int              # slabs
    TS: int             # tiles per slab
    CW: int             # lane chunks per slab
    RW: int             # row-chunk window
    n8p: int            # output row chunks (>= RW)
    NC: int             # x segments (ceil(ncols / seg)); the segid sentinel
    mirror: bool
    vals: np.ndarray    # [S*TS, RC, CC] f32
    rid8: np.ndarray    # [S, 1, TS] int32 tile row chunk - b8 (RW = pad)
    cid8: np.ndarray    # [S, 1, TS] int32 tile compact chunk (CW = pad)
    segid: np.ndarray   # [S, CW*NSEG] int32 rows of x.reshape(-1, seg)
    tgt: np.ndarray | None    # [S, CW*NSEG] int32 mirror target y segment
                              # (sentinel n_yseg); mirror plans only
    b8: np.ndarray      # [S] int32 first row chunk per slab
    nt: int             # real tile count

    @property
    def nseg(self) -> int:
        return CC // self.seg

    @property
    def n_yseg(self) -> int:
        return -(-self.nrows // self.seg)

    @property
    def tile_bytes(self) -> int:
        return int(self.vals.size * 4)

    @property
    def aux_bytes(self) -> int:
        """Streamed per product beyond the value tiles."""
        a = (self.rid8.size + self.cid8.size + self.segid.size) * 4
        if self.tgt is not None:
            a += self.tgt.size * 4
        return int(a)


def greedy_cover(cols: np.ndarray, seg: int):
    """Greedy cover of a column list by windows of ``x.reshape(-1, seg)``.

    Returns (win_starts [ns], lanepos [len(cols)]): absolute window start
    per segment and, per column, its lane position inside the cover
    (seg_index * seg + offset).  Order-insensitive.
    """
    c = np.asarray(cols, np.int64)
    order = np.argsort(c, kind="stable")
    cs = c[order]
    starts = []
    lane_sorted = np.empty(cs.size, np.int64)
    i = 0
    while i < cs.size:
        w0 = cs[i] - cs[i] % seg
        j = int(np.searchsorted(cs, w0 + seg, "left"))
        lane_sorted[i:j] = len(starts) * seg + (cs[i:j] - w0)
        starts.append(int(w0))
        i = j
    lanepos = np.empty(cs.size, np.int64)
    lanepos[order] = lane_sorted
    return np.asarray(starts, np.int64), lanepos


def _canonical_rows(rows: np.ndarray):
    """(r0, height, embed) for a row list; None = past the dilution cap."""
    r = np.asarray(rows, np.int64)
    if is_contiguous(r):
        return int(r[0]), r.size, None
    r0 = int(r.min())
    span = int(r.max()) - r0 + 1
    cover8 = np.unique(r // RC).size * RC
    if cover8 > _ROW_COVER_CAP * max(1, r.size):
        return None
    return r0, span, (r - r0)


def build_panel2_plan(entries, shape, *, seg: int = 32, mirror: bool = False,
                      TS_max: int = 1024):
    """Build a Panel2Plan from entries ``(block, rows, cols, is_mirror)``.

    Packing skeleton as in v1 (``core/panel.py``): group by identical row
    lists, concatenate each group's covers along a continuous seg-granular
    global K axis, collect nonzero [8, 128] tiles, cut into row-windowed
    slabs.
    """
    nrows, ncols = map(int, shape)
    if mirror and nrows != ncols:
        return None
    NC = -(-ncols // seg)
    nseg = CC // seg
    n_yseg = -(-nrows // seg)

    panels: dict = {}
    canon = []
    any_mirror = False
    for blk, rows, cols, is_m in entries:
        blk = np.asarray(blk, np.float32)
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        if blk.size == 0:
            continue
        cr = _canonical_rows(rows)
        if cr is None:
            return None
        any_mirror |= bool(is_m)
        key = (cr[0], rows.tobytes())
        canon.append((cr, blk, cols, bool(is_m)))
        panels.setdefault(key, []).append(len(canon) - 1)
    if not canon:
        return None
    mirror = mirror and any_mirror

    order = sorted(panels, key=lambda k: k[0])
    seg_rows = []          # per global seg: row of x.reshape(-1, seg)
    seg_tgts = []          # per global seg: y-seg target (mirror) or sentinel
    tiledict: dict = {}
    kcur = 0               # global K cursor in lanes (seg-aligned)
    for key in order:
        group = []
        r0, H, emb = canon[panels[key][0]][0]
        rpos = np.arange(H) if emb is None else emb
        W = 0
        for i in panels[key]:
            _, blk, cols, is_m = canon[i]
            wins, lanepos = greedy_cover(cols, seg)
            group.append((blk, lanepos + W, wins, is_m))
            W += wins.size * seg
        if H * W > _MAX_CANVAS:
            return None
        canvas = np.zeros((H, W), np.float32)
        for blk, lanes, _, _ in group:
            np.add.at(canvas, (rpos[:, None], lanes[None, :]), blk)

        def pieces(koff):
            ro, co = r0 % RC, koff % CC
            mp = -(-(ro + H) // RC) * RC
            kp = -(-(co + W) // CC) * CC
            pad = np.zeros((mp, kp), np.float32)
            pad[ro:ro + H, co:co + W] = canvas
            rb, cb = r0 // RC, koff // CC
            out = {}
            for ii in range(mp // RC):
                rows_ = pad[ii * RC:(ii + 1) * RC]
                if not rows_.any():
                    continue
                for jj in range(kp // CC):
                    t = rows_[:, jj * CC:(jj + 1) * CC]
                    if t.any():
                        out[(rb + ii, cb + jj)] = t
            return out

        kfresh = -(-kcur // CC) * CC
        cands = [kcur] if kcur == kfresh else [kcur, kfresh]
        best_p = None
        for koff in cands:
            p = pieces(koff)
            new = sum(1 for k in p if k not in tiledict)
            cost = new * RC * CC * 4 + ((koff - kcur) // seg) * 16
            if best_p is None or cost < best_p[0]:
                best_p = (cost, koff, p)
        _, koff, p = best_p
        npad = (koff - kcur) // seg
        seg_rows.extend([NC] * npad)
        seg_tgts.extend([n_yseg] * npad)
        for _, _, wins, is_m in group:
            for w0 in wins:
                seg_rows.append(int(w0) // seg)
                seg_tgts.append(int(w0) // seg
                                if (is_m and mirror) else n_yseg)
        for tk, t in p.items():
            if tk in tiledict:
                tiledict[tk] += t
            else:
                tiledict[tk] = t.copy()
        kcur = koff + W
    if not tiledict:
        return None

    nseg_tot = len(seg_rows)
    pad_to = -(-nseg_tot // nseg) * nseg
    cseg_flat = np.full(pad_to, NC, np.int64)
    cseg_flat[:nseg_tot] = seg_rows
    ctgt_flat = np.full(pad_to, n_yseg, np.int64)
    ctgt_flat[:nseg_tot] = seg_tgts
    chunk_segs = cseg_flat.reshape(-1, nseg)
    chunk_tgts = ctgt_flat.reshape(-1, nseg)

    keys = sorted(tiledict)
    rid = np.asarray([k[0] for k in keys], np.int64)
    cid = np.asarray([k[1] for k in keys], np.int64)
    tiles = np.stack([tiledict[k] for k in keys])
    nt = tiles.shape[0]
    n8 = -(-nrows // RC)

    best = None
    for RW in (16, 32, 64, 128):
        if RW > max(n8, 16):
            continue
        TS, slabs = _balanced_cuts(rid, nt, RW, TS_max)
        S = len(slabs)
        cw = 8
        for a, b in slabs:
            cw = max(cw, -(-np.unique(cid[a:b]).size // 8) * 8)
        bytes_ = (S * TS * RC * CC * 4 + S * TS * 8
                  + S * cw * nseg * 8 + S * _STEP_TAX)
        if best is None or bytes_ < best[0]:
            best = (bytes_, RW, TS, S, cw, slabs)
    if best is None:
        return None
    _, RW, TS, S, CW, slabs = best
    n8p = max(n8, RW)

    segid = np.full((S, CW * nseg), NC, np.int32)
    tgt = np.full((S, CW * nseg), n_yseg, np.int32) if mirror else None
    b8 = np.zeros((S,), np.int32)
    vals = np.zeros((S * TS, RC, CC), np.float32)
    rid8 = np.full((S, 1, TS), RW, np.int32)
    cid8 = np.full((S, 1, TS), CW, np.int32)
    for si, (a, b) in enumerate(slabs):
        cnt = b - a
        base = min(int(rid[a]), n8p - RW)
        b8[si] = base
        vals[si * TS:si * TS + cnt] = tiles[a:b]
        rid8[si, 0, :cnt] = rid[a:b] - base
        uniq, inv = np.unique(cid[a:b], return_inverse=True)
        cid8[si, 0, :cnt] = inv
        segid[si, :uniq.size * nseg] = chunk_segs[uniq].reshape(-1)
        if mirror:
            tgt[si, :uniq.size * nseg] = chunk_tgts[uniq].reshape(-1)

    return Panel2Plan(
        nrows=nrows, ncols=ncols, seg=seg, S=S, TS=TS, CW=CW, RW=RW,
        n8p=n8p, NC=NC, mirror=bool(mirror), vals=vals, rid8=rid8,
        cid8=cid8, segid=segid, tgt=tgt, b8=b8, nt=nt,
    )


def _layout_entries(layout: BlockLayout, *, transpose: bool,
                    is_mirror: bool = False):
    out = []
    for i in range(layout.nblocks):
        r = layout.rowindices[i]
        c = layout.colindices[i]
        if r.size == 0 or c.size == 0:
            continue
        blk = layout.extract_block(i)
        if transpose:
            out.append((blk.T, c, r, is_mirror))
        else:
            out.append((blk, r, c, is_mirror))
    return out


def _cover_lanes(entries, seg):
    """Exact lane count of the greedy covers (fast pre-metric)."""
    tot = 0
    for blk, rows, cols, is_m in entries:
        wins, _ = greedy_cover(np.asarray(cols), seg)
        tot += wins.size * seg * len(rows)
    return tot


def choose_seg(entries, shape, *, mirror: bool = False, segs=(8, 16, 32),
               TS_max: int = 1024):
    """Build the plan at the SEG minimizing the modeled stream cost.

    Cost = tile + aux bytes, plus gather-table and (mirror) map-back
    burden in stream-byte equivalents (v5e weights).  Candidates are
    pre-screened by exact cover-lane counts; larger SEG wins ties.
    """
    lanes = {s: _cover_lanes(entries, s) for s in segs}
    ranked = sorted(segs, key=lambda s: (lanes[s], -s))
    best = None
    for s in ranked[:2]:
        p = build_panel2_plan(entries, shape, seg=s, mirror=mirror,
                              TS_max=TS_max)
        if p is None:
            continue
        gather_rows = p.S * p.CW * p.nseg
        cost = p.tile_bytes + p.aux_bytes + gather_rows * _GATHER_ROW_COST
        if p.mirror:
            nyp = -(-p.n_yseg // 8) * 8
            cost += p.S * nyp * p.CW * p.nseg * _MAPBACK_COST
        if best is None or cost < best[0]:
            best = (cost, p)
    return None if best is None else best[1]


def panel2_plan_from_layout(layout: BlockLayout, *, transpose: bool = False,
                            TS_max: int = 1024):
    """General (non-symmetric) v2 panel plan; None if ineligible."""
    if layout.nblocks == 0:
        return None
    dt = np.result_type(*[b.values.dtype for b in layout.buckets])
    if dt != np.float32:
        return None
    shape = ((layout.ncols, layout.nrows) if transpose
             else (layout.nrows, layout.ncols))
    return choose_seg(_layout_entries(layout, transpose=transpose), shape,
                      mirror=False, TS_max=TS_max)


def panel2_plan_symmetric(dlayout: BlockLayout, olayout: BlockLayout, *,
                          transpose_diag: bool = False, TS_max: int = 1024):
    """Symmetric v2 plan: S = D + O + O^T in one launch, one value read per
    stored block.  Fused (mirror) against expanded is decided by the
    modeled cost, as in v1."""
    dts = [b.values.dtype for b in dlayout.buckets] + [
        b.values.dtype for b in olayout.buckets]
    if dts and np.result_type(*dts) != np.float32:
        return None
    shape = (dlayout.nrows, dlayout.ncols)
    diag = _layout_entries(dlayout, transpose=transpose_diag)
    off = _layout_entries(olayout, transpose=False)
    off_t = _layout_entries(olayout, transpose=True)
    fused = choose_seg(
        diag + [(b, r, c, True) for b, r, c, _ in off], shape, mirror=True,
        TS_max=TS_max)
    expanded = choose_seg(diag + off + off_t, shape, mirror=False,
                          TS_max=TS_max)

    def cost(p, factor):
        return None if p is None else (p.tile_bytes + p.aux_bytes) * factor

    cf = cost(fused, _MIRROR_RATE_PENALTY2)
    ce = cost(expanded, 1.0)
    if cf is None:
        return expanded
    if ce is None:
        return fused
    return expanded if ce <= cf else fused
