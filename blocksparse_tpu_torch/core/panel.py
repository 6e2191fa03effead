"""Panel layout: K-merged row-group canvases on the [8,128] tile grid.

numpy copy of ``blocksparse_tpu/core/panel.py`` (the port cannot import the
JAX package); ``tests/test_torch_stream.py`` holds every field equal to the
original's.  All blocks sharing one row index list concatenate along K into
a panel, panels pack back-to-back in a global panel-K space, and the whole
operand streams as [8, 128] tiles through kernel B5
(``ops/kernels/panel_spmv.py``).  Columns are re-indexed by **32-lane
segments**: every block occupies the 32-segment cover of its column index
list, placed at the columns' in-segment offsets, so lane ``l`` of a panel
chunk maps to one x element through ``segid`` (eight shifted segment grids,
``GRIDS``, shrink the cover of arbitrary-offset runs).

Symmetric fusion: a stored off-diagonal block streams once, and the kernel
emits both its product and its mirrored product; the mirrored per-lane sums
map back to y through each segment's target, the same segment of x.

One departure from the JAX package: the mirror map-back is a per-segment
int32 target table ``otgt`` instead of the one-hot ``omap``
[S*CW*4, NG*NC32] (tens to hundreds of MB at real sizes).  ``aux_bytes``
still counts the one-hot, so ``stream_plan_choice`` charges a general
operand's plan as the JAX package does (a symmetric operand's plan is
charged the port's own cost, ``ops/panel_router.py::route_bytes``).

The cost-model constants (``_STEP_TAX``, ``_ROLL_TAX``,
``_MIRROR_RATE_PENALTY``, the 256-768 slab budgets) were measured on a TPU
v5e and are kept as they are, so these planners plan as the JAX package
does.  The port's route picks between a symmetric operand's two candidate
plans (:func:`symmetric_candidates`) by its own H100 rule
(``ops/panel_router.py``); :func:`panel_plan_symmetric` keeps the JAX
rule.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .layout import BlockLayout, is_contiguous
from .strip import CC, RC

__all__ = ["PanelPlan", "build_panel_plan", "panel_plan_from_layout",
           "panel_plan_symmetric", "symmetric_candidates", "SEG", "GRIDS",
           "NSEG"]

SEG = 32               # x-gather segment (lanes) = one row of x.reshape(-1,32)
GRIDS = tuple(range(0, 32, 4))   # shifted seg grids (rows of roll(x, -g))
NSEG = CC // SEG       # segments per lane chunk
_ROW_COVER_CAP = 3.2   # scattered rows: max tile-cover dilution
_MAX_CANVAS = 1 << 26  # per-panel canvas element cap (host memory guard)
_STEP_TAX = 1 << 18    # per-grid-step overhead, in stream-byte equivalents
                       # (v5e value; awaits measurement on the H100)


@dataclass(frozen=True, eq=False)
class PanelPlan:
    """Host-side panel plan."""

    nrows: int
    ncols: int          # REAL input length
    S: int              # slabs
    TS: int             # tiles per slab (adaptive; max real slab size)
    CW: int             # compacted lane chunks per slab
    RW: int             # row-chunk window (adaptive)
    n8p: int            # output row chunks
    NC32: int           # input segments (ncols // 32, padded)
    mirror: bool
    vals: np.ndarray    # [S*TS, RC, CC] f32
    rid8: np.ndarray    # [S, 1, TS] int32 tile row chunk - b8 (RW = pad)
    cid8: np.ndarray    # [S, 1, TS] int32 tile compact chunk id (CW = pad)
    segid: np.ndarray   # [S, CW*NSEG] int32 rows of the stacked shifted
                        # x32 grids; sentinel == len(GRIDS)*NC32
    b8: np.ndarray      # [S] int32 first row chunk per slab
    nt: int             # real (non-padding) tile count
    otgt: np.ndarray | None  # [S, CW*NSEG] int32 mirror target segment of
                             # each panel segment, -1 = dropped (mirror
                             # plans only; the JAX package's omap one-hot
                             # has a 1 at [s*CW*NSEG + j, otgt[s, j]])
    grids_used: tuple = GRIDS   # shift grids the segids reference

    @property
    def tile_bytes(self) -> int:
        return int(self.vals.size * 4)

    @property
    def omap_size(self) -> int:
        """Elements of the JAX package's map-back one-hot
        [S*CW*NSEG, len(grids_used)*NC32]; 0 for plain plans."""
        if self.otgt is None:
            return 0
        return self.otgt.size * len(self.grids_used) * self.NC32

    @property
    def aux_bytes(self) -> int:
        """Per-product aux stream as the JAX package counts it: id vectors,
        segment tables and (mirror plans) the bf16 map-back one-hot.  The
        JAX package's rules read this (``_plan_cost``, and
        ``stream_plan_choice`` for a general operand), so the one-hot is
        counted though the port stages only ``otgt``."""
        a = (self.rid8.size + self.cid8.size + self.segid.size) * 4
        return int(a + self.omap_size * 2)


def _canonical_rows(rows: np.ndarray):
    """(r0, height, embed) for a row index list (None embed = contiguous).

    Scattered lists embed span-dense; the cover's all-zero [8,128] strips
    drop in the tiler.  Returns None past _ROW_COVER_CAP dilution.
    """
    r = np.asarray(rows, np.int64)
    if is_contiguous(r):
        return int(r[0]), r.size, None
    r0 = int(r.min())
    span = int(r.max()) - r0 + 1
    cover8 = np.unique(r // RC).size * RC
    if cover8 > _ROW_COVER_CAP * max(1, r.size):
        return None
    return r0, span, (r - r0)


def _seg_cover(cols: np.ndarray, NC32: int, *, allow_shift: bool = True):
    """(segids [ns], lanepos [len(cols)]) -- the 32-segment cover of an
    index list and each column's lane position inside the cover.

    Eight shifted segment grids are available (GRIDS); the one with the
    smallest cover wins -- on contiguous runs this cuts the head+tail waste
    from ~31 to ~19 lanes.  Grid g's segment a is row a of
    ``roll(x, -g).reshape(-1, 32)`` and gets ids offset by ``gi * NC32``.
    ``allow_shift=False`` builds the grid-0-only variant (more cover
    waste, a one-op gather in the JAX package)."""
    c = np.asarray(cols, np.int64)
    best = None
    for gi, g in enumerate(GRIDS):
        if g and (not allow_shift or (c < g).any()):
            continue
        segs, inv = np.unique((c - g) // SEG, return_inverse=True)
        if best is None or segs.size < best[0].size:
            best = (segs + gi * NC32, inv * SEG + ((c - g) % SEG))
            if segs.size * SEG - c.size < SEG:
                break
    return best


def _balanced_cuts(rid: np.ndarray, nt: int, RW: int, TS_max: int):
    """Greedy slab cuts under the RW row window; scan tile budgets and
    return the (TS, cuts) minimizing padded slab bytes S*TS."""
    def greedy(budget):
        slabs = []
        s0 = 0
        while s0 < nt:
            s1 = min(s0 + budget, nt)
            lo = int(rid[s0])
            if int(rid[s1 - 1]) - lo >= RW:
                s1 = s0 + int(np.searchsorted(rid[s0:s1], lo + RW, "left"))
            slabs.append((s0, s1))
            s0 = s1
        return slabs

    best = None
    # slab budgets of 256-768 tiles (1-3 MB), measured good on the v5e;
    # awaits measurement on the H100
    for budget in range(256, min(TS_max, 768) + 1, 32):
        slabs = greedy(budget)
        TS = -(-max(b - a for a, b in slabs) // 8) * 8
        score = len(slabs) * (TS * RC * CC * 4 + _STEP_TAX)
        if best is None or score < best[0]:
            best = (score, TS, slabs)
    return best[1], best[2]


def build_panel_plan(entries, shape, *, mirror: bool = False,
                     TS_max: int = 1024, allow_shift: bool = True):
    """Build a PanelPlan from entries ``(block, rows, cols, is_mirror)``.

    ``block``  : 2-D float32 values [len(rows), len(cols)]
    ``rows``   : output row index list (any order; scattered allowed)
    ``cols``   : input column index list (ANY list -- 32-seg-covered)
    ``is_mirror``: True for stored symmetric off-diagonals (the fused
                 kernel emits their transposed contribution too).
    ``allow_shift``: permit the shifted segment grids.  Shifts shrink
                 covers (~12 lanes/run) but each extra grid costs one
                 roll op per product (~0.3 us floor); the caller builds
                 both variants and picks by the measured tax
                 (:func:`_best_shift_variant`).

    Returns None when ineligible (row dilution past the cap, or empty).
    """
    nrows, ncols = map(int, shape)
    if mirror and nrows != ncols:
        return None
    NC32 = -(-ncols // SEG)

    # -- group entries into panels by identical row lists -------------------
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

    # -- pack blocks along a CONTINUOUS 32-granular global K axis -----------
    # Entries sort by row list, so same-row blocks are adjacent and chunks
    # shared between neighbors usually carry near-identical row ranges; no
    # per-panel 128-rounding exists at all (a chunk straddling two row
    # groups just holds both groups' strips, which the zero-strip skip
    # keeps exact).
    order = sorted(panels, key=lambda k: k[0])
    seg_rows = []         # per global 32-seg: source row of the x32 grids
    seg_mirr = []         # per global 32-seg: seg feeds the mirror map-back
    tiledict: dict = {}   # (rid, cid) -> [8, 128] tile
    kcur = 0              # global K cursor (lanes; always 32-aligned)
    sent = len(GRIDS) * NC32
    for key in order:
        # assemble the whole row group: entries pack back-to-back in K
        group = []
        r0, H, emb = canon[panels[key][0]][0]
        rpos = np.arange(H) if emb is None else emb
        W = 0
        for i in panels[key]:
            _, blk, cols, is_m = canon[i]
            # mirror entries may use shifted grids too: the map-back adds
            # the grid's shift back (otgt); _plan_cost charges the grids
            segs, lanepos = _seg_cover(cols, NC32, allow_shift=allow_shift)
            group.append((blk, lanepos + W, segs, is_m))
            W += segs.size * SEG
        if H * W > _MAX_CANVAS:
            return None
        canvas = np.zeros((H, W), np.float32)
        for blk, lanes, _, _ in group:
            np.add.at(canvas, (rpos[:, None], lanes[None, :]), blk)

        def pieces(koff):
            """Nonzero [8,128] pieces of the group canvas at offset koff."""
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

        # share the tail chunk of the previous group vs start 128-aligned:
        # whichever adds fewer tiles over the WHOLE group wins (sharing is
        # usually a loss for cleanly aligned groups and a big win for wide
        # singleton covers; a per-entry greedy is myopic about the group's
        # downstream alignment, so the decision is per group)
        kfresh = -(-kcur // CC) * CC
        cands = [kcur] if kcur == kfresh else [kcur, kfresh]
        best_p = None
        for koff in cands:
            p = pieces(koff)
            new = sum(1 for k in p if k not in tiledict)
            cost = new * RC * CC * 4 + (
                (koff - kcur) // SEG) * (NC32 * 2 if mirror else 16)
            if best_p is None or cost < best_p[0]:
                best_p = (cost, koff, p)
        _, koff, p = best_p
        npad = (koff - kcur) // SEG
        seg_rows.extend([sent] * npad)
        seg_mirr.extend([False] * npad)
        for _, _, segs, is_m in group:
            seg_rows.extend(segs.tolist())
            seg_mirr.extend([bool(is_m)] * segs.size)
        for tk, t in p.items():
            if tk in tiledict:
                tiledict[tk] += t
            else:
                tiledict[tk] = t.copy()
        kcur = koff + W
    if not tiledict:
        return None
    # compact the grid table to the grids actually referenced (the JAX
    # gather builds one roll per grid)
    used = sorted({int(v) // NC32 for v in seg_rows if v < sent}) or [0]
    remap = {g: i for i, g in enumerate(used)}
    sent = len(used) * NC32
    seg_rows = [sent if v >= len(GRIDS) * NC32
                else remap[int(v) // NC32] * NC32 + int(v) % NC32
                for v in seg_rows]
    grids_used = tuple(GRIDS[g] for g in used)
    nseg_tot = len(seg_rows)
    cseg_flat = np.full(-(-nseg_tot // NSEG) * NSEG, sent, np.int64)
    cseg_flat[:nseg_tot] = seg_rows
    cmir_flat = np.zeros(cseg_flat.size, bool)
    cmir_flat[:nseg_tot] = seg_mirr
    chunk_segs = cseg_flat.reshape(-1, NSEG)
    chunk_mirror = cmir_flat.reshape(-1, NSEG)

    keys = sorted(tiledict)
    rid = np.asarray([k[0] for k in keys], np.int64)
    cid = np.asarray([k[1] for k in keys], np.int64)
    tiles = np.stack([tiledict[k] for k in keys])
    nt = tiles.shape[0]
    n8 = -(-nrows // RC)

    # -- adaptive slab cuts: least total streamed bytes over RW choices -----
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
                  + S * cw * NSEG * 4 + S * _STEP_TAX
                  + (S * cw * NSEG * NC32 * 2 if mirror else 0))
        if best is None or bytes_ < best[0]:
            best = (bytes_, RW, TS, S, cw, slabs)
    if best is None:
        return None
    _, RW, TS, S, CW, slabs = best
    n8p = max(n8, RW)

    cseg = chunk_segs                      # [K̂, NSEG]
    cmir = chunk_mirror                    # [K̂, NSEG]
    vals = np.zeros((S * TS, RC, CC), np.float32)
    rid8 = np.full((S, 1, TS), RW, np.int32)
    cid8 = np.full((S, 1, TS), CW, np.int32)
    segid = np.full((S, CW * NSEG), sent, np.int32)
    b8 = np.zeros((S,), np.int32)
    # mirror map-back over ALL used grids: target gi*NC32 + a maps a
    # grid-gi panel segment to y[a*32 + lane + GRIDS[gi]]
    otgt = np.full((S, CW * NSEG), -1, np.int32) if mirror else None
    for si, (a, b) in enumerate(slabs):
        cnt = b - a
        base = min(int(rid[a]), n8p - RW)
        b8[si] = base
        vals[si * TS:si * TS + cnt] = tiles[a:b]
        rid8[si, 0, :cnt] = rid[a:b] - base
        uniq, inv = np.unique(cid[a:b], return_inverse=True)
        cid8[si, 0, :cnt] = inv
        segid[si, :uniq.size * NSEG] = cseg[uniq].reshape(-1)
        if mirror:
            tgt = cseg[uniq].reshape(-1)
            live = cmir[uniq].reshape(-1) & (tgt < sent)
            otgt[si, :uniq.size * NSEG] = np.where(live, tgt, -1)

    return PanelPlan(
        nrows=nrows, ncols=ncols, S=S, TS=TS, CW=CW, RW=RW, n8p=n8p,
        NC32=NC32, mirror=bool(mirror), vals=vals, rid8=rid8, cid8=cid8,
        segid=segid, b8=b8, nt=nt, otgt=otgt, grids_used=grids_used,
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


_ROLL_TAX = 250_000   # stream-byte equivalent of one roll op (~0.3 us
                      # XLA op floor at 819 GB/s on the v5e; awaits
                      # measurement on the H100, whose kernel has no rolls)


def _plan_cost(p) -> int:
    # each extra grid costs one roll op on the gather side, plus (mirror
    # plans) a pad+add pair to un-shift that grid's map-back plane
    per_grid = _ROLL_TAX * (3 if p.mirror else 1)
    return p.tile_bytes + p.aux_bytes + (len(p.grids_used) - 1) * per_grid


def _best_shift_variant(entries, shape, *, mirror, TS_max):
    """Shifted grids shrink covers but cost one roll op per extra grid
    per product; grid-0-only streams more bytes with a one-op gather.
    Build both, charge the roll tax, keep the cheaper (the JAX package's
    rule, kept so the port plans as it does)."""
    ps = build_panel_plan(entries, shape, mirror=mirror, TS_max=TS_max)
    if ps is not None and len(ps.grids_used) == 1:
        return ps
    p0 = build_panel_plan(entries, shape, mirror=mirror, TS_max=TS_max,
                          allow_shift=False)
    cands = [p for p in (ps, p0) if p is not None]
    if not cands:
        return None
    return min(cands, key=_plan_cost)


def panel_plan_from_layout(layout: BlockLayout, *, transpose: bool = False,
                           TS_max: int = 1024):
    """General (non-symmetric) panel plan; None if ineligible."""
    if layout.nblocks == 0:
        return None
    dt = np.result_type(*[b.values.dtype for b in layout.buckets])
    if dt != np.float32:
        return None
    shape = ((layout.ncols, layout.nrows) if transpose
             else (layout.nrows, layout.ncols))
    return _best_shift_variant(
        _layout_entries(layout, transpose=transpose), shape, mirror=False,
        TS_max=TS_max)


# Per-byte cost of the fused mirror pass relative to the plain pass, as the
# JAX package measured it on the v5e (its mirror-side reductions were
# VPU-bound); awaits measurement on the H100.
_MIRROR_RATE_PENALTY = 1.4


def symmetric_candidates(dlayout: BlockLayout, olayout: BlockLayout, *,
                         transpose_diag: bool = False, TS_max: int = 1024):
    """(fused, expanded): the two candidate plans of a symmetric operand
    S = D + O + O^T, each None where ineligible (both None unless f32).

      * **fused**: each off-diagonal stored once; the kernel emits both
        contributions from one value read (mirror plan);
      * **expanded**: O^T blocks materialized too, run by the plain
        (forward-only) kernel.

    ``transpose_diag`` builds the S^T variant (diagonal blocks transpose;
    the off-diagonal pair is transpose-invariant)."""
    dts = [b.values.dtype for b in dlayout.buckets] + [
        b.values.dtype for b in olayout.buckets]
    if dts and np.result_type(*dts) != np.float32:
        return None, None
    shape = (dlayout.nrows, dlayout.ncols)
    diag = _layout_entries(dlayout, transpose=transpose_diag)
    off = _layout_entries(olayout, transpose=False)
    off_t = _layout_entries(olayout, transpose=True)
    fused = _best_shift_variant(
        diag + [(b, r, c, True) for b, r, c, _ in off], shape,
        mirror=True, TS_max=TS_max)
    expanded = _best_shift_variant(diag + off + off_t, shape, mirror=False,
                                   TS_max=TS_max)
    return fused, expanded


def panel_plan_symmetric(dlayout: BlockLayout, olayout: BlockLayout, *,
                         transpose_diag: bool = False, TS_max: int = 1024):
    """Symmetric panel plan: S = D + O + O^T in one kernel launch, the
    cheaper of :func:`symmetric_candidates` by the JAX package's cost model
    (the fused plan charged ``_MIRROR_RATE_PENALTY`` per byte).  The port's
    route takes its own rule (``ops/panel_router.py``)."""
    fused, expanded = symmetric_candidates(
        dlayout, olayout, transpose_diag=transpose_diag, TS_max=TS_max)

    def cost(p, factor):
        return None if p is None else _plan_cost(p) * factor

    cf = cost(fused, _MIRROR_RATE_PENALTY)
    ce = cost(expanded, 1.0)
    if cf is None:
        return expanded
    if ce is None:
        return fused
    return expanded if ce <= cf else fused
