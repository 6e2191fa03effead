"""Host-side block layout engine: shape bucketing, padding, index tables.

numpy copy of ``build_layout`` from ``blocksparse_tpu/core/layout.py`` at
its format defaults (automatic chunking, k-merge) with both bucket-key
policies (power-of-two keys or ``(gm, gk)`` multiples); the port cannot
import the JAX package, whose ``__init__`` imports jax.
``tests/test_torch_layout.py`` holds the two bit-identical.  Sparse
(scipy) input blocks are carried as there: densified into the buckets, their
stored entry counts kept as ``block_nnz``.  The JAX package's
``chunk``/``merge`` options and its optional native packer are not
carried.

Dense blocks are packed into a small number of *shape buckets*.  Every
block in a bucket is zero-padded up to the bucket's tile shape ``(mp, kp)``
and the bucket becomes

    values  : [nb, mp, kp]   dense, zero-padded block data
    row_idx : [nb, mp] int32 output (row) gather/scatter indices, sentinel = M
    col_idx : [nb, kp] int32 input (column) gather indices,       sentinel = N

The sentinel convention lets the compute path use an extended ``x_ext =
concat(x, [0])`` so padded lanes read zero and padded rows scatter into a
dropped slot ``y_ext[M]`` -- no masks anywhere in the hot path.

``nnz`` keeps the reference's *logical* semantics (``prod(size)`` of the
unpadded block, the stored entry count of a sparse one,
abstractblockmatrix.jl:65-71).

``BlockLayout.digest`` is the JAX layout's content digest, computed at its
first read and cached: the key of the population policy
(``ops/dispatch.set_population_policy``).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from functools import cached_property
from typing import Sequence

import numpy as np

from ..utils.profiling import annotate

__all__ = [
    "BlockLayout",
    "Bucket",
    "build_layout",
    "round_up",
    "is_contiguous",
]


def round_up(x: int, m: int) -> int:
    return -(-int(x) // int(m)) * int(m)


def pow2_ceil(x: int) -> int:
    """Smallest power of two >= x (>= 1)."""
    return 1 << max(int(x) - 1, 0).bit_length()


def is_contiguous(idx: np.ndarray) -> bool:
    """True iff ``idx`` is a contiguous ascending integer range."""
    idx = np.asarray(idx)
    if idx.size == 0:
        return True
    # cheap reject first (lists may be unsorted, so confirm with the full check)
    if int(idx[-1]) - int(idx[0]) + 1 != idx.size:
        return False
    return bool(np.all(idx[1:] == idx[:-1] + 1))


def _cover_chunks(idx: np.ndarray, C: int) -> np.ndarray:
    """Sorted distinct C-chunks an index list touches."""
    idx = np.asarray(idx, dtype=np.int64)
    if idx.size == 0:
        return np.zeros(0, dtype=np.int64)
    return np.unique(idx // C)


def _cover_positions(idx: np.ndarray, C: int) -> np.ndarray:
    """In-tile positions under chunk-cover placement: element e lands at
    (rank of its chunk among the distinct chunks) * C + e % C.

    For a contiguous range this reduces exactly to the classic offset
    placement (start % C shift), so one code path serves both."""
    idx = np.asarray(idx, dtype=np.int64)
    ch = _cover_chunks(idx, C)
    return (np.searchsorted(ch, idx // C) * C + idx % C).astype(np.int64)


@dataclass(frozen=True)
class Bucket:
    """One shape bucket: all blocks padded to the same (mp, kp) tile.

    ``block_ids`` maps bucket-local position -> original block index.

    Chunking (``chunk`` = C > 1): every block in the bucket has its values
    stored on whole C-aligned chunks of x and y (contiguous ranges shifted
    by ``(row_start % C, col_start % C)``; scattered lists dilated onto the
    chunks they touch), so gather/scatter run at *chunk* granularity via
    ``row_chunk_idx``/``col_chunk_idx`` ([nb, mp/C] / [nb, kp/C] indices
    into x and y viewed as [len/C, C]).  The element tables remain valid
    (the shifted positions hold sentinels) so every engine works on one
    storage.
    """

    mp: int
    kp: int
    values: np.ndarray  # [nb, mp, kp]
    row_idx: np.ndarray  # [nb, mp] int32
    col_idx: np.ndarray  # [nb, kp] int32
    block_ids: np.ndarray  # [nb] int32
    # Per-block true (unpadded) shapes, parallel to block_ids.
    true_m: np.ndarray  # [nb] int32
    true_k: np.ndarray  # [nb] int32
    # ALIGNED start index (row_start - row_off) when the index list is a
    # contiguous range, else -1.
    row_start: np.ndarray  # [nb] int32
    col_start: np.ndarray  # [nb] int32
    # In-tile offsets of the true block (nonzero only when chunk > 1).
    row_off: np.ndarray  # [nb] int32
    col_off: np.ndarray  # [nb] int32
    chunk: int = 1
    row_chunk_idx: np.ndarray = None  # [nb, mp // chunk] int32
    col_chunk_idx: np.ndarray = None  # [nb, kp // chunk] int32

    @property
    def nblocks(self) -> int:
        return int(self.values.shape[0])

    @property
    def all_contiguous(self) -> bool:
        return bool(np.all(self.row_start >= 0) and np.all(self.col_start >= 0))


@dataclass(frozen=True, eq=False)
class BlockLayout:
    """Complete host-side layout for one block-sparse operand.

    Compared and hashed by identity: plan caches (``ops/colored.py``) key
    on the layout object an operator holds.  :attr:`digest` is the content
    hash, computed only where it is read."""

    nrows: int
    ncols: int
    buckets: tuple[Bucket, ...]
    nblocks: int
    # Original ragged index lists (reference API parity: rowindices/colindices,
    # blockmatrix.jl:124-160).  Tuples of int32 arrays, one per block.
    rowindices: tuple[np.ndarray, ...]
    colindices: tuple[np.ndarray, ...]
    # block id -> (bucket, slot, row_off, col_off, m, k): where the block's
    # true (unpadded) data lives inside the bucket tile.  k-merged slots
    # (see _kmerge) hold several blocks at different col_off.
    block_loc: tuple[tuple[int, int, int, int, int, int], ...] = ()
    # per-block logical nnz: prod(shape) for dense input blocks, the stored
    # entry count for sparse (scipy) input blocks.  Empty tuple = all dense.
    block_nnz: tuple[int, ...] = ()

    @cached_property
    def digest(self) -> str:
        """SHA-256 hex digest of the shape, the block count and every
        bucket's tile shape, chunk, values and index tables: the JAX
        ``BlockLayout._digest``, over the same bytes."""
        h = hashlib.sha256()
        h.update(np.int64([self.nrows, self.ncols, self.nblocks]).tobytes())
        for b in self.buckets:
            h.update(np.int64([b.mp, b.kp, b.chunk]).tobytes())
            h.update(np.ascontiguousarray(b.values).tobytes())
            h.update(np.ascontiguousarray(b.row_idx).tobytes())
            h.update(np.ascontiguousarray(b.col_idx).tobytes())
        return h.hexdigest()

    @property
    def nnz(self) -> int:
        """Logical nnz: sum of unpadded block areas for dense blocks and of
        stored entry counts for sparse input blocks -- invariant under
        bucketing, chunking and merging."""
        if self.block_nnz:
            return int(sum(self.block_nnz))
        return int(
            sum(int(r.size) * int(c.size)
                for r, c in zip(self.rowindices, self.colindices))
        )

    def extract_block(self, i: int) -> np.ndarray:
        """Original block i's values, handling every placement.

        Contiguous / element placements are a dense sub-slice; chunk-cover
        placements (scattered lists dilated onto their covering C-chunks)
        recompute the dilated positions from the stored index lists."""
        bi, slot, orr, occ, m, k = self.block_loc[i]
        b = self.buckets[bi]
        ri = self.rowindices[i]
        ci = self.colindices[i]
        C = int(b.chunk)
        if C > 1 and not (is_contiguous(ri) and is_contiguous(ci)):
            rpos = _cover_positions(ri, C)
            cpos = _cover_positions(ci, C)
            return np.asarray(b.values[slot][np.ix_(rpos, cpos)])
        return np.asarray(b.values[slot, orr:orr + m, occ:occ + k])

    @property
    def padded_nnz(self) -> int:
        return int(sum(b.nblocks * b.mp * b.kp for b in self.buckets))

    @cached_property
    def stored_by_bucket(self) -> tuple[int, ...]:
        """Per bucket, the stored entries of the blocks it holds (the
        products of their index lists' lengths): with the tiles' entries
        (``nb * mp * kp``), what a launch over the bucket counts."""
        out = [0] * len(self.buckets)
        for loc, r, c in zip(self.block_loc, self.rowindices,
                             self.colindices):
            out[loc[0]] += int(r.size) * int(c.size)
        return tuple(out)


CHUNK_CANDIDATES = (128, 64, 32, 16, 8, 4)

MERGE_CAP = 512  # max k-extent of a merged slot


def _bucket_slot(b: Bucket, j: int) -> dict:
    """Per-slot arrays of bucket ``b`` slot ``j`` as a pool entry."""
    return dict(
        values=b.values[j],
        row_idx=b.row_idx[j],
        col_idx=b.col_idx[j],
        row_chunk_idx=None if b.row_chunk_idx is None else b.row_chunk_idx[j],
        col_chunk_idx=None if b.col_chunk_idx is None else b.col_chunk_idx[j],
        row_start=int(b.row_start[j]),
        col_start=int(b.col_start[j]),
        row_off=int(b.row_off[j]),
        col_off=int(b.col_off[j]),
        true_m=int(b.true_m[j]),
        true_k=int(b.true_k[j]),
        block_id=int(b.block_ids[j]),
    )


def _merged_slot(b: Bucket, part: list[int], rs: int, nrows: int) -> dict:
    """Concatenate bucket ``b`` slots ``part`` (sharing row window ``rs``)
    along k.  The merged row table covers the whole aligned window with real
    rows (zero-padded values scatter zeros there, which is harmless and keeps
    one table for all members)."""
    mp, kp, C = b.mp, b.kp, int(b.chunk)
    g = len(part)
    rows = rs + np.arange(mp, dtype=np.int64)
    return dict(
        values=np.concatenate([b.values[j] for j in part], axis=1),
        row_idx=np.where(rows < nrows, rows, nrows).astype(np.int32),
        col_idx=np.concatenate([b.col_idx[j] for j in part]),
        row_chunk_idx=(rs // C + np.arange(mp // C)).astype(np.int32),
        col_chunk_idx=np.concatenate([b.col_chunk_idx[j] for j in part]),
        row_start=rs,
        col_start=-1,
        row_off=0,
        col_off=0,
        true_m=mp,
        true_k=g * kp,
        block_id=int(b.block_ids[part[0]]),
    )


def _kmerge(buckets: list[Bucket], nrows: int, cap: int = MERGE_CAP):
    """k-merge stage: concatenate blocks sharing an output row window.

    Within a chunked bucket, blocks whose aligned row windows coincide are
    concatenated along k in power-of-two groups (exact binary decomposition:
    a window with q blocks becomes groups of sizes from q's binary digits --
    no zero-block padding, so ``padded_nnz`` is unchanged).  A merged slot
    needs one output scatter instead of g, and g-fold fewer row indices.
    Its row chunk table covers the whole aligned window, which may reach
    up to ``mp - 1`` rows past the operand's last row.  Column
    contiguity is traded away: merged slots carry per-chunk column tables
    (col_chunk_idx / element col_idx concatenations) and col_start=-1, which
    every engine already consumes.

    Returns (new_buckets, loc) where loc maps original block id ->
    (bucket, slot, row_off, col_off, m, k).
    """
    pools: dict[tuple[int, int, int], list] = {}
    order: list[tuple[int, int, int]] = []
    loc_by_key: dict[int, tuple] = {}

    def pool_add(key, slot) -> int:
        if key not in pools:
            pools[key] = []
            order.append(key)
        pools[key].append(slot)
        return len(pools[key]) - 1

    def add_single(b, j):
        key = (b.mp, b.kp, int(b.chunk))
        sidx = pool_add(key, _bucket_slot(b, j))
        loc_by_key[int(b.block_ids[j])] = (
            key, sidx, int(b.row_off[j]), int(b.col_off[j]),
            int(b.true_m[j]), int(b.true_k[j]),
        )

    for b in buckets:
        nb = b.nblocks
        C = int(b.chunk)
        groups: dict[int, list[int]] = {}
        if C > 1 and b.all_contiguous and nb > 1:
            for j in range(nb):
                groups.setdefault(int(b.row_start[j]), []).append(j)
        if not any(len(g) > 1 for g in groups.values()):
            for j in range(nb):
                add_single(b, j)
            continue
        gmax = max(1, cap // b.kp)
        gmax = 1 << (gmax.bit_length() - 1)  # floor to power of two
        for rs, members in groups.items():
            pos = 0
            while pos < len(members):
                rem = len(members) - pos
                g = min(gmax, 1 << (rem.bit_length() - 1))
                part = members[pos : pos + g]
                pos += g
                if g == 1:
                    add_single(b, part[0])
                    continue
                key = (b.mp, g * b.kp, C)
                sidx = pool_add(key, _merged_slot(b, part, rs, nrows))
                for jj, j in enumerate(part):
                    loc_by_key[int(b.block_ids[j])] = (
                        key, sidx, int(b.row_off[j]),
                        jj * b.kp + int(b.col_off[j]),
                        int(b.true_m[j]), int(b.true_k[j]),
                    )

    new_buckets = []
    key_to_bi = {}
    for key in sorted(order):
        mp, kp, C = key
        slots = pools[key]
        key_to_bi[key] = len(new_buckets)
        chunked = C > 1
        new_buckets.append(
            Bucket(
                mp=mp,
                kp=kp,
                values=np.stack([s["values"] for s in slots]),
                row_idx=np.stack([s["row_idx"] for s in slots]),
                col_idx=np.stack([s["col_idx"] for s in slots]),
                block_ids=np.asarray([s["block_id"] for s in slots], np.int32),
                true_m=np.asarray([s["true_m"] for s in slots], np.int32),
                true_k=np.asarray([s["true_k"] for s in slots], np.int32),
                row_start=np.asarray([s["row_start"] for s in slots], np.int32),
                col_start=np.asarray([s["col_start"] for s in slots], np.int32),
                row_off=np.asarray([s["row_off"] for s in slots], np.int32),
                col_off=np.asarray([s["col_off"] for s in slots], np.int32),
                chunk=C,
                row_chunk_idx=(
                    np.stack([s["row_chunk_idx"] for s in slots]) if chunked else None
                ),
                col_chunk_idx=(
                    np.stack([s["col_chunk_idx"] for s in slots]) if chunked else None
                ),
            )
        )
    loc = {
        bid: (key_to_bi[key], sidx, orr, occ, m, k)
        for bid, (key, sidx, orr, occ, m, k) in loc_by_key.items()
    }
    return new_buckets, loc


def _emit_bucket(ids, rcov, ccov, mp, kp, C, blocks, rlists, clists,
                 r_contig, c_contig, dtype, nrows, ncols) -> Bucket:
    """Pack one bucket's blocks into uniform tiles.

    Placement: element layout (C == 1), classic offset-shift (contiguous
    ranges), or chunk-cover dilation (scattered lists) -- the latter two
    share the position rule (see _cover_positions)."""
    nb = len(ids)
    offs_r = np.zeros(nb, dtype=np.int32)
    offs_c = np.zeros(nb, dtype=np.int32)
    rpos_l = [None] * nb
    cpos_l = [None] * nb
    if C > 1:
        for j, i in enumerate(ids):
            rpos_l[j] = _cover_positions(rlists[i], C)
            cpos_l[j] = _cover_positions(clists[i], C)
            offs_r[j] = int(rpos_l[j][0]) if rpos_l[j].size else 0
            offs_c[j] = int(cpos_l[j][0]) if cpos_l[j].size else 0

    vals = np.zeros((nb, mp, kp), dtype=dtype)
    ridx = np.full((nb, mp), nrows, dtype=np.int32)
    cidx = np.full((nb, kp), ncols, dtype=np.int32)
    tm = np.zeros((nb,), dtype=np.int32)
    tk = np.zeros((nb,), dtype=np.int32)
    rstart = np.full((nb,), -1, dtype=np.int32)
    cstart = np.full((nb,), -1, dtype=np.int32)
    rchunk = np.zeros((nb, mp // C), dtype=np.int32) if C > 1 else None
    cchunk = np.zeros((nb, kp // C), dtype=np.int32) if C > 1 else None
    for j, i in enumerate(ids):
        b = np.asarray(blocks[i])
        m, k = b.shape
        orr, occ = int(offs_r[j]), int(offs_c[j])
        if C > 1 and not (r_contig[i] and c_contig[i]):
            # chunk-cover placement of a scattered list
            vals[j][np.ix_(rpos_l[j], cpos_l[j])] = b
            ridx[j, rpos_l[j]] = rlists[i]
            cidx[j, cpos_l[j]] = clists[i]
        else:
            vals[j, orr : orr + m, occ : occ + k] = b
            ridx[j, orr : orr + m] = rlists[i]
            cidx[j, occ : occ + k] = clists[i]
        tm[j], tk[j] = m, k
        if r_contig[i] and m > 0:
            rstart[j] = int(rlists[i][0]) - orr  # C-aligned tile start
        if c_contig[i] and k > 0:
            cstart[j] = int(clists[i][0]) - occ
        if C > 1:
            # chunk tables from the cover (== consecutive window for
            # contiguous ranges); padded slots repeat the last real
            # chunk -- their value rows/cols are zero, so the duplicate
            # gather/scatter contributes exactly 0
            rc_ = rcov[j]
            if rc_.size:
                rchunk[j, : rc_.size] = rc_
                rchunk[j, rc_.size:] = rc_[-1]
            cc_ = ccov[j]
            if cc_.size:
                cchunk[j, : cc_.size] = cc_
                cchunk[j, cc_.size:] = cc_[-1]
    return Bucket(
        mp=mp,
        kp=kp,
        values=vals,
        row_idx=ridx,
        col_idx=cidx,
        block_ids=np.asarray(ids, dtype=np.int32),
        true_m=tm,
        true_k=tk,
        row_start=rstart,
        col_start=cstart,
        row_off=offs_r,
        col_off=offs_c,
        chunk=C,
        row_chunk_idx=rchunk,
        col_chunk_idx=cchunk,
    )


def build_layout(
    blocks: Sequence[np.ndarray],
    rowindices: Sequence[np.ndarray],
    colindices: Sequence[np.ndarray],
    shape: tuple[int, int],
    *,
    granularity="pow2",
    dtype=None,
) -> BlockLayout:
    """Bucket ``blocks`` by padded shape and build SoA index tables.

    granularity: the bucket-key policy.
      - "pow2" (the formats' default): the next power of two per dim; the
        number of buckets (= kernel launches per product) stays at log^2
        while wasting at most ~2x area per dim.
      - (gm, gk): each dim rounded up to these multiples; (1, 1) buckets by
        exact shape.

    Chunking: per bucket of contiguous-range blocks, the largest C in
    CHUNK_CANDIDATES whose offset-padding keeps the tile area within 2x of
    the pow2 tile (always chunking if any candidate fits the block dims);
    blocks are stored offset-shifted so gather/scatter run at C-element
    chunk granularity (see Bucket docstring).  Scattered lists take the
    tightest chunk cover while it stays within 3.25x of their logical area,
    else element granularity.

    The k-merge stage (see _kmerge) then concatenates blocks sharing an
    output row window along k.  Span ``bsp.layout``.
    """
    with annotate("bsp.layout", blocks=len(blocks)) as span:
        layout = _build_layout(blocks, rowindices, colindices, shape,
                               granularity=granularity, dtype=dtype)
        span.set(buckets=len(layout.buckets))
        return layout


def _build_layout(
    blocks: Sequence[np.ndarray],
    rowindices: Sequence[np.ndarray],
    colindices: Sequence[np.ndarray],
    shape: tuple[int, int],
    *,
    granularity="pow2",
    dtype=None,
) -> BlockLayout:
    """:func:`build_layout`'s work."""
    nrows, ncols = map(int, shape)
    n = len(blocks)
    if not (len(rowindices) == len(colindices) == n):
        raise ValueError("blocks, rowindices, colindices must have equal length")
    # a scipy.sparse block densifies into the buckets and keeps its stored
    # entry count as its logical nnz (the reference's _nnz rule)
    sparse = [hasattr(b, "toarray") and hasattr(b, "nnz") for b in blocks]
    block_nnz = tuple(int(b.nnz) if sp else int(np.prod(np.shape(b)))
                      for b, sp in zip(blocks, sparse))
    blocks = [np.asarray(b.toarray() if sp else b)
              for b, sp in zip(blocks, sparse)]

    if granularity == "pow2":
        key_of = lambda m, k: (pow2_ceil(m), pow2_ceil(k))
    else:
        if (isinstance(granularity, str) or len(granularity) != 2
                or min(int(g) for g in granularity) < 1):
            raise ValueError(
                f"granularity must be 'pow2' or (gm, gk) >= 1, got {granularity!r}")
        gm, gk = granularity
        key_of = lambda m, k: (round_up(max(m, 1), gm), round_up(max(k, 1), gk))

    rlists, clists = [], []
    if dtype is None:
        dtype = np.result_type(*[b.dtype for b in blocks]) if n else np.float64

    groups: dict[tuple[int, int], list[int]] = {}
    for i in range(n):
        b = blocks[i]
        ri = np.asarray(rowindices[i], dtype=np.int64).ravel()
        ci = np.asarray(colindices[i], dtype=np.int64).ravel()
        if b.ndim != 2:
            raise ValueError(f"block {i} is not 2-D")
        if b.shape != (ri.size, ci.size):
            raise ValueError(
                f"block {i} shape {b.shape} != (len(rowindices), len(colindices))"
                f" = ({ri.size}, {ci.size})"
            )
        if ri.size and (ri.min() < 0 or ri.max() >= nrows):
            raise ValueError(f"block {i} row indices out of range [0, {nrows})")
        if ci.size and (ci.min() < 0 or ci.max() >= ncols):
            raise ValueError(f"block {i} col indices out of range [0, {ncols})")
        rlists.append(np.ascontiguousarray(ri, dtype=np.int32))
        clists.append(np.ascontiguousarray(ci, dtype=np.int32))
        key = key_of(b.shape[0], b.shape[1])
        groups.setdefault(key, []).append(i)

    # contiguity computed once per index list (hot at production block counts)
    r_contig = [is_contiguous(l) for l in rlists]
    c_contig = [is_contiguous(l) for l in clists]

    buckets = []
    for (mp, kp), ids in sorted(groups.items()):
        nb = len(ids)
        contig = all(
            rlists[i].size > 0
            and clists[i].size > 0
            and r_contig[i]
            and c_contig[i]
            for i in ids
        )

        def cover_for(c):
            """Chunk-cover tile for candidate c: every block's values dilate
            onto the distinct C-chunks its (possibly scattered) index lists
            touch.  For contiguous ranges this is exactly the classic
            offset-shift placement (see _cover_positions)."""
            rch = [_cover_chunks(rlists[i], c) for i in ids]
            cch = [_cover_chunks(clists[i], c) for i in ids]
            mpc = c * max(1, max((x.size for x in rch), default=1))
            kpc = c * max(1, max((x.size for x in cch), default=1))
            return rch, cch, mpc, kpc

        C = 1
        rcov = ccov = None
        entries = [(c,) + cover_for(c) for c in CHUNK_CANDIDATES
                   if c <= mp and c <= kp]
        chosen = None
        if contig:
            # largest candidate whose offset-padding stays within 2x of
            # the pow2 tile area; else the candidate wasting least
            for e in entries:
                if e[3] * e[4] <= 2 * mp * kp:
                    chosen = e
                    break
            if chosen is None and entries:
                chosen = min(entries, key=lambda t: t[3] * t[4])
        elif entries:
            # Scattered (non-contiguous) lists: pick the tightest cover by
            # TOTAL dilated area (tie -> larger C = fewer indices); dilate
            # only while the waste stays under ~3.25x of the logical area
            # -- beyond that the element engine is kept (the JAX package's
            # crossover, kept for parity).
            logical = sum(
                max(1, rlists[i].size) * max(1, clists[i].size)
                for i in ids
            )

            def total_area(e):
                c = e[0]
                return sum(
                    c * max(1, r.size) * c * max(1, k.size)
                    for r, k in zip(e[1], e[2])
                )

            best = min(entries, key=lambda t: (total_area(t), -t[0]))
            if total_area(best) <= 3.25 * logical:
                chosen = best
        if chosen is not None:
            C, rcov, ccov, mp, kp = chosen

        if C > 1 and not contig:
            # sub-split cover buckets by chunk-count size class (eighth
            # granularity: <= 12.5% rounding waste per dim) so one
            # wide-span block does not dilate every other block's tile;
            # each sub-bucket's tile is its actual max cover
            def _cls(v: int) -> int:
                v = max(1, v)
                g = max(1, 1 << max(0, v.bit_length() - 3))
                return -(-v // g) * g

            by_key: dict[tuple[int, int], list[int]] = {}
            for j in range(nb):
                by_key.setdefault(
                    (_cls(rcov[j].size), _cls(ccov[j].size)), []
                ).append(j)
            subgroups = []
            for _, js in sorted(by_key.items()):
                s_mp = C * max(max(1, rcov[j].size) for j in js)
                s_kp = C * max(max(1, ccov[j].size) for j in js)
                subgroups.append((
                    [ids[j] for j in js], [rcov[j] for j in js],
                    [ccov[j] for j in js], s_mp, s_kp,
                ))
        else:
            subgroups = [(ids, rcov, ccov, mp, kp)]

        for s_ids, s_rcov, s_ccov, s_mp, s_kp in subgroups:
            buckets.append(_emit_bucket(
                s_ids, s_rcov, s_ccov, s_mp, s_kp, C, blocks, rlists, clists,
                r_contig, c_contig, dtype, nrows, ncols,
            ))

    buckets, loc_map = _kmerge(buckets, nrows)
    return BlockLayout(
        nrows=nrows,
        ncols=ncols,
        buckets=tuple(buckets),
        nblocks=n,
        rowindices=tuple(rlists),
        colindices=tuple(clists),
        block_loc=tuple(loc_map[i] for i in range(n)),
        block_nnz=block_nnz if any(sparse) else (),
    )
