"""Block-row partitioning and halo planning for sharded execution.

numpy copy of ``blocksparse_tpu/parallel/partition.py`` (the port cannot
import the JAX package); ``tests/test_torch_partition.py`` holds every
array it emits byte-equal to the JAX functions'.  It reads the port's host
layouts (``core/layout.py``), whose buckets are byte-equal to the JAX ones.

Each of S shards owns a contiguous range of output rows and every block
whose first real row falls in that range; x is sharded by the matching
128-aligned column partition.  A **halo plan**, computed at construction,
lists the 128-element chunks (``G``) that each shard's boundary-crossing
blocks touch outside its own range; they are exchanged with ring
neighbours, one round per ring distance d that has any traffic, each round
moving max-over-shards(needed chunks).  Exchanged bytes scale with the
block structure's shard overlap, not with N.

The same plan serves both dataflow directions:

- **forward** (gather): owners send the needed x chunks; each shard gathers
  from ``[x_local ++ halo]``.
- **reverse** (scatter-reduce): shards accumulate contributions for rows
  they do not own into the halo region of ``[y_local ++ halo]`` and send
  the region back to the owners, who add it in.

One position table per index space drives both: ``rowtab`` (positions in
the row space) is the scatter target of ``y = A x`` and the gather source
of ``y = A^T x``; ``coltab`` vice versa.  Padded value rows and columns are
zero, so a padding entry may alias any slot; its sentinel (``Lr`` / ``Lc``,
or ``Lr // C`` / ``Lc // C`` in chunk units) lies one past the buffer,
where the port's kernels read zero and drop writes.

The stacking produces *uniform* per-shard arrays (every shard the same
shapes, max-padded with zero-value slots), as the JAX package's
``shard_map`` body needs; the port's shards drop the padding slots when
they stage their tables (``parallel/distributed.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = [
    "G", "RowPartition", "partition_rows", "HaloPlan", "plan_halo",
    "collect_reads", "stack_operand",
]

G = 128  # halo granule (elements); also the partition alignment granule


@dataclass(frozen=True)
class RowPartition:
    """Row ownership: shard s owns rows [offsets[s], offsets[s+1])."""

    nshards: int
    nrows: int
    offsets: tuple[int, ...]  # length nshards + 1

    def owner_of_row(self, r: int) -> int:
        return int(np.searchsorted(np.asarray(self.offsets), r, side="right") - 1)

    @property
    def shard_rows(self) -> int:
        sizes = {self.offsets[i + 1] - self.offsets[i] for i in range(self.nshards)}
        assert len(sizes) == 1, "non-uniform partition"
        return int(next(iter(sizes)))


def partition_rows(nrows: int, nshards: int, granule: int = G) -> RowPartition:
    """Uniform contiguous partition, shard size rounded up to ``granule`` so
    every chunk size C (C divides 128) stays aligned to shard boundaries."""
    per = -(-(-(-nrows // nshards)) // granule) * granule
    offsets = tuple(i * per for i in range(nshards + 1))
    return RowPartition(nshards=nshards, nrows=nrows, offsets=offsets)


@dataclass(frozen=True)
class HaloPlan:
    """Static neighbour-exchange schedule over one 128-aligned partition.

    For each active ring distance d, shard s sends to shard (s+d) % S:
    ``send_idx[d]`` is a [S, E_d] table of *local* G-chunk ids,
    zero-padded; padded slots send (forward) or receive into (reverse)
    chunk 0 with an all-zero payload, which is harmless.  Each shard's halo
    buffer is the concatenation over active distances of the E_d chunks it
    exchanges; ``chunk_pos[s]`` maps a global G-chunk id to its position in
    that buffer (G-chunk units).
    """

    S: int
    per: int                        # elements per shard in this partition
    dists: tuple[int, ...]          # active ring distances
    send_idx: tuple[np.ndarray, ...]  # per distance: [S, E_d] int32 local ids
    halo_chunks: int                # H = sum(E_d): halo G-chunks per shard
    chunk_pos: tuple[dict, ...]     # per shard: {global G-chunk -> position}

    @property
    def exchanged_bytes_per_call(self) -> int:
        """Bytes moved by the halo per SpMV (r=1, f32), summed over shards."""
        return sum(int(si.shape[1]) for si in self.send_idx) * G * 4 * self.S

    def elem_pos(self, shard: int, e: int) -> int:
        """Position of global element ``e`` in shard's [local ++ halo]."""
        c, o = divmod(int(e), G)
        lo = shard * (self.per // G)
        if lo <= c < lo + self.per // G:
            return int(e) - shard * self.per
        return (self.per // G + self.chunk_pos[shard][c]) * G + o

    def chunk_pos_c(self, shard: int, cc: int, C: int) -> int:
        """Position of global C-chunk ``cc`` in [local ++ halo], C units."""
        g = int(cc) * C // G
        lo = shard * (self.per // G)
        if lo <= g < lo + self.per // G:
            return int(cc) - shard * self.per // C
        pos_g = self.per // G + self.chunk_pos[shard][g]
        return pos_g * (G // C) + (int(cc) - g * (G // C))

    def _halo_pos(self, shard: int, g: np.ndarray) -> np.ndarray:
        """``chunk_pos[shard][g]`` for an array of global G-chunks, each of
        which must be in the plan (a missing one raises, as the dict does)."""
        table = self.chunk_pos[shard]
        if not g.size:
            return np.zeros(0, np.int64)
        keys, inv = np.unique(g, return_inverse=True)
        try:
            vals = np.array([table[int(k)] for k in keys], np.int64)
        except KeyError as e:
            raise KeyError(f"G-chunk {e.args[0]} is not in shard {shard}'s "
                           "halo plan") from None
        return vals[inv.reshape(g.shape)]

    def elem_pos_array(self, shard: int, e: np.ndarray) -> np.ndarray:
        """:meth:`elem_pos` of every element of ``e`` (int64, same shape)."""
        e = np.asarray(e, np.int64)
        c, o = e // G, e % G
        lo = shard * (self.per // G)
        local = (c >= lo) & (c < lo + self.per // G)
        out = e - shard * self.per
        far = ~local
        out[far] = (self.per // G + self._halo_pos(shard, c[far])) * G + o[far]
        return out

    def chunk_pos_c_array(self, shard: int, cc: np.ndarray, C: int
                          ) -> np.ndarray:
        """:meth:`chunk_pos_c` of every C-chunk of ``cc`` (int64)."""
        cc = np.asarray(cc, np.int64)
        g = cc * C // G
        lo = shard * (self.per // G)
        local = (g >= lo) & (g < lo + self.per // G)
        out = cc - shard * self.per // C
        far = ~local
        pos_g = self.per // G + self._halo_pos(shard, g[far])
        out[far] = pos_g * (G // C) + (cc[far] - g[far] * (G // C))
        return out


def plan_halo(needed_by_shard, S: int, per: int) -> HaloPlan:
    """``needed_by_shard``: per shard, the set of global G-chunks it touches
    outside its own range.  Returns a HaloPlan (dists may be empty)."""
    cpg = per // G
    sends = {d: [[] for _ in range(S)] for d in range(1, S)}
    for s in range(S):
        for c in sorted(needed_by_shard[s]):
            if int(c) >= S * cpg:
                continue  # beyond the padded extent: zero payload anyway
            owner = min(int(c) // cpg, S - 1)
            if owner == s:
                continue
            d = (s - owner) % S
            sends[d][owner].append(int(c))
    dists = tuple(d for d in range(1, S) if any(sends[d]))
    send_idx = []
    chunk_pos = [dict() for _ in range(S)]
    offset = 0
    for d in dists:
        E = max(len(sends[d][src]) for src in range(S))
        tab = np.zeros((S, E), np.int32)
        for src in range(S):
            lst = sends[d][src]
            tab[src, : len(lst)] = [c - src * cpg for c in lst]
            dst = (src + d) % S
            for j, c in enumerate(lst):
                chunk_pos[dst][c] = offset + j
        send_idx.append(tab)
        offset += E
    return HaloPlan(S=S, per=per, dists=dists, send_idx=tuple(send_idx),
                    halo_chunks=offset, chunk_pos=tuple(chunk_pos))


def _owners(b, nrows: int, rows_per: int, S: int) -> np.ndarray:
    """Owning shard of each block of bucket ``b`` (by its first real row
    index; the first table entry where that is a sentinel)."""
    nb = b.nblocks
    if not b.mp:
        first = np.zeros(nb, np.int64)
    else:
        first = np.take_along_axis(
            b.row_idx, b.row_off.astype(np.int64)[:, None], axis=1
        )[:, 0].astype(np.int64)
        first = np.where(first >= nrows, b.row_idx[:, 0].astype(np.int64),
                         first)
    return np.minimum(first // rows_per, S - 1)


def collect_reads(layout, part: RowPartition, rows_per: int, cols_per: int,
                  side: str):
    """Per shard, the set of global G-chunks of one index space ("rows" or
    "cols") that the shard's blocks touch outside its own range.

    The same chunk set covers both directions: for ``side="cols"`` these are
    the x chunks gathered in the forward product AND the y chunks scattered
    in the transpose product (one plan, two uses)."""
    S = part.nshards
    use_rows = side == "rows"
    per = rows_per if use_rows else cols_per
    needed = [set() for _ in range(S)]
    for b in layout.buckets:
        C = int(b.chunk)
        owners = _owners(b, layout.nrows, rows_per, S)
        for j in range(b.nblocks):
            s = int(owners[j])
            lo, hi = s * per, (s + 1) * per
            if C > 1:
                idx = b.row_chunk_idx[j] if use_rows else b.col_chunk_idx[j]
                start = int(b.row_start[j] if use_rows else b.col_start[j])
                ext = b.mp if use_rows else b.kp
                if lo <= start and start + ext <= hi:
                    continue
                for cc in np.unique(idx.astype(np.int64) * C // G):
                    if not (lo // G <= cc < hi // G):
                        needed[s].add(int(cc))
            else:
                lim = layout.nrows if use_rows else layout.ncols
                ci = (b.row_idx[j] if use_rows else b.col_idx[j]).astype(np.int64)
                ci = ci[ci < lim]
                out = ci[(ci < lo) | (ci >= hi)]
                for cc in np.unique(out // G):
                    needed[s].add(int(cc))
    return needed


def _local_blocks(b, owner, chunked: bool, nrows: int, ncols: int,
                  rows_per: int, cols_per: int) -> np.ndarray:
    """Per block of ``b``: True where its real rows AND columns all lie in
    its owner's ranges (chunked buckets: by their aligned starts)."""
    rlo, clo = owner * rows_per, owner * cols_per
    rhi, chi = rlo + rows_per, clo + cols_per
    if chunked:
        rs = b.row_start.astype(np.int64)
        cs = b.col_start.astype(np.int64)
        return ((rlo <= rs) & (rs + b.mp <= rhi)
                & (clo <= cs) & (cs + b.kp <= chi))
    ri = b.row_idx.astype(np.int64)
    ci = b.col_idx.astype(np.int64)
    rows_ok = (ri >= nrows) | ((ri >= rlo[:, None]) & (ri < rhi[:, None]))
    cols_ok = (ci >= ncols) | ((ci >= clo[:, None]) & (ci < chi[:, None]))
    return rows_ok.all(axis=1) & cols_ok.all(axis=1)


def stack_operand(layout, part: RowPartition, cols_per: int,
                  row_halo: HaloPlan, col_halo: HaloPlan):
    """Stack one operand's buckets into uniform per-shard arrays.

    Blocks are split by locality: "loc" blocks touch only their owner's row
    AND col ranges (they run before the halo lands, overlapping the
    exchange); "rem" blocks address the halo regions.  Each group carries:

      values [S, nbmax, mp, kp]
      rowtab [S, nbmax, mp(/C)]  positions in [rows_per ++ Hr*G], sentinel Lr
      coltab [S, nbmax, kp(/C)]  positions in [cols_per ++ Hc*G], sentinel Lc

    ``rowtab`` scatters y (forward) and gathers x (transpose/mirror);
    ``coltab`` gathers x (forward) and scatters y (transpose/mirror).  The
    sentinel absorbs padding (zero values, so any aliasing is +0).

    Returns a list over buckets of {"loc": {...}, "rem": {...}}.  The JAX
    function fills the tables entry by entry; this one computes the same
    entries with array operations, shard by shard.
    """
    S = part.nshards
    rows_per = part.shard_rows
    Lr = rows_per + row_halo.halo_chunks * G
    Lc = cols_per + col_halo.halo_chunks * G
    out = []
    for b in layout.buckets:
        nb = b.nblocks
        mp, kp = b.mp, b.kp
        C = int(b.chunk)
        chunked = C > 1 and cols_per % C == 0 and rows_per % C == 0
        owner = _owners(b, layout.nrows, rows_per, S)
        local = _local_blocks(b, owner, chunked, layout.nrows, layout.ncols,
                              rows_per, cols_per)

        groups = {}
        for key, members in (("loc", local), ("rem", ~local)):
            ids = np.nonzero(members)[0]
            counts = (np.bincount(owner[ids], minlength=S) if ids.size
                      else np.zeros(S, int))
            nbmax = int(counts.max()) if ids.size else 0
            values = np.zeros((S, nbmax, mp, kp), dtype=b.values.dtype)
            if chunked:
                rowtab = np.full((S, nbmax, mp // C), Lr // C, np.int32)
                coltab = np.full((S, nbmax, kp // C), Lc // C, np.int32)
            else:
                rowtab = np.full((S, nbmax, mp), Lr, np.int32)
                coltab = np.full((S, nbmax, kp), Lc, np.int32)
            for s in range(S):
                js = ids[owner[ids] == s]  # ascending: the JAX fill order
                if not js.size:
                    continue
                slots = slice(0, js.size)
                values[s, slots] = b.values[js]
                if chunked:
                    rowtab[s, slots] = _positions(
                        b.row_chunk_idx[js], S * rows_per // C, Lr // C,
                        lambda v: row_halo.chunk_pos_c_array(s, v, C))
                    coltab[s, slots] = _positions(
                        b.col_chunk_idx[js], S * cols_per // C, Lc // C,
                        lambda v: col_halo.chunk_pos_c_array(s, v, C))
                else:
                    rowtab[s, slots] = _positions(
                        b.row_idx[js], layout.nrows, Lr,
                        lambda v: row_halo.elem_pos_array(s, v))
                    coltab[s, slots] = _positions(
                        b.col_idx[js], layout.ncols, Lc,
                        lambda v: col_halo.elem_pos_array(s, v))
            groups[key] = dict(values=values, rowtab=rowtab, coltab=coltab,
                               chunk=C if chunked else 1)
        out.append(groups)
    return out


def _positions(idx, limit: int, sentinel: int, pos):
    """``idx`` mapped through ``pos`` where it is below ``limit``, else
    ``sentinel`` (chunk tables: ``limit`` is the padded extent in chunks,
    ``S * per // C``, exact since C divides ``per``)."""
    idx = np.asarray(idx, np.int64)
    keep = idx < limit
    res = np.full(idx.shape, sentinel, np.int64)
    res[keep] = pos(idx[keep])
    return res
