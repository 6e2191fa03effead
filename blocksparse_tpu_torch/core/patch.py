"""Patch-merged layout: ragged row-window merge with chunk-exact column cover.

numpy copy of ``build_patch_plan`` from ``blocksparse_tpu/core/patch.py``
with its plan bias ``optimize`` ("auto" | "latency" | "throughput" | None,
the operators' ``optimize=``; None is "auto", the JAX ``BST_OPT`` variable
is not read); ``tests/test_torch_layout.py`` holds the two bit-identical
under each value.  The plan's shape choices (canvas search, grid group
``G``) are the JAX package's, kept as they are so the port's kernel
consumes the very plan the reference kernel consumed; the bias moves only
``G``, the number of zero slots that pad the plan.  Not carried: the
forced-canvas and forced-``G`` options and the one-hot row tables of the
r = 1 TPU path.

Contiguous-range blocks are merged into **patch slots**:

  - all blocks sharing one output row window concatenate along k, each
    member placed at its exact cover of CC-wide column chunks: per-member
    waste is only the partial first/last chunk;
  - a slot's k-extent is padded to the canvas width with *sentinel* chunks
    (gather index NC reads a zero chunk; values zero);
  - slot counts are padded to a multiple of ``G`` with zero slots whose row
    window starts at 0 (an in-bounds zero contribution).

Eligibility: f32 values, contiguous row and column index lists.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .layout import BlockLayout, is_contiguous, round_up

__all__ = ["PatchPlan", "PatchBucket", "build_patch_plan", "CC", "CR"]

CC = 32   # column chunk width (gather granularity)
CR = 8    # row chunk width (scatter granularity)
LANE = 128
KC_ALIGN = LANE // CC   # k chunk counts padded to this so KP % 128 == 0

_MAX_KP = 4096          # canvas k-extent cap
_STEP_BYTES = 600_000   # target value bytes per reference grid step
_SLOT_TAX = 512         # cost-model bytes per canvas (per-slot overhead)


@dataclass(frozen=True)
class PatchBucket:
    """One size class of merged slots (nb is padded to a multiple of G).

    vals      : [nb, MP, KP] f32 (KP % 128 == 0)
    col_chunk : [nb, KC] int32 -- CC-chunk id per k-chunk, sentinel NC
    row_start : [nb] int32 -- element start of the slot's row window
                (padded slots point at an in-bounds zero region)
    mirror_kc : [nb] int32 -- leading k-chunks with a mirrored (transposed)
                contribution; 0 for plain operands
    G         : grid group size of the reference mono-kernel (nb % G == 0)
    """

    MP: int
    KP: int
    G: int
    vals: np.ndarray
    col_chunk: np.ndarray
    row_start: np.ndarray
    mirror_kc: np.ndarray

    @property
    def nb(self) -> int:
        return int(self.vals.shape[0])


@dataclass(frozen=True)
class PatchPlan:
    """Host-side merged-patch plan for one operand."""

    nrows: int
    ncols: int
    buckets: tuple[PatchBucket, ...]
    symmetric: bool          # fused mirror pass present
    logical_nnz: int

    @property
    def value_bytes(self) -> int:
        return int(sum(b.vals.size * b.vals.dtype.itemsize
                       for b in self.buckets))


def build_patch_plan(layout: BlockLayout,
                     extra_layout: BlockLayout | None = None,
                     transpose_main: bool = False,
                     optimize: str | None = None):
    """Build a PatchPlan from one layout (or a diag+offdiag pair).

    ``extra_layout``: when given, ``layout`` is the DIAGONAL operand and
    ``extra_layout`` the stored OFF-DIAGONAL operand of a symmetric matrix;
    both merge into one plan whose off-diagonal chunks are mirror-counted.
    Returns None when ineligible (non-f32 values, any non-contiguous index
    list, or no nonempty block).

    ``transpose_main``: embed the transpose of ``layout``'s blocks (indices
    swapped).  Used for S^T = D^T + O + O^T: the off-diagonal pair is
    transpose-invariant, only the diagonal operand transposes.  Plain
    operands do not need it -- their transpose swaps the gather/scatter
    roles over the same plan.

    ``optimize``: the grid-group bias.  "auto" / "latency" (and None) pick
    an even step count around 2-8 where the group fits the reference
    kernel's step budget; "throughput" searches the step count for the
    fewest padded bytes plus a per-step tax, which the other values also
    fall back to when the even-step group does not fit.
    """
    dts = [b.values.dtype for b in layout.buckets]
    if extra_layout is not None:
        dts += [b.values.dtype for b in extra_layout.buckets]
    if dts and np.result_type(*dts) != np.float32:
        return None

    entries = []   # (block values f32, row_start, col_start, mirrored)

    def collect(lay: BlockLayout, mirrored: bool, transposed: bool) -> bool:
        for i in range(lay.nblocks):
            r = lay.rowindices[i]
            c = lay.colindices[i]
            if r.size == 0 or c.size == 0:
                continue
            if not (is_contiguous(r) and is_contiguous(c)):
                return False
            blk = np.asarray(lay.extract_block(i), np.float32)
            if transposed:
                blk, r, c = blk.T, c, r
            entries.append((blk, int(r[0]), int(c[0]), mirrored))
        return True

    if not collect(layout, False, transpose_main):
        return None
    if extra_layout is not None and not collect(extra_layout, True, False):
        return None
    if not entries:
        return None

    nrows, ncols = layout.nrows, layout.ncols
    if transpose_main:
        nrows, ncols = ncols, nrows
    NC = -(-ncols // CC)
    NR = -(-nrows // CR)
    logical = sum(b.shape[0] * b.shape[1] for b, _, _, _ in entries)
    symmetric = extra_layout is not None

    # -- uniform canvas -------------------------------------------------------
    # Every slot is normalized onto ONE canvas shape [MP*, KC* chunks]:
    # blocks split freely along rows (window tiles anchored at the block's
    # CR-aligned start) and along column chunks, so the plan always has
    # exactly one bucket.  (MP*, KC*) come from an exact cost search.

    def block_kc(j):
        blk, rs, cs, mi = entries[j]
        return int(-(-((cs % CC) + blk.shape[1]) // CC))

    def window_groups(MPc):
        """window start -> list of (entry j, piece row range)."""
        groups: dict[int, list[tuple[int, int, int]]] = {}
        for j, (blk, rs, cs, mi) in enumerate(entries):
            a = rs - rs % CR
            h = blk.shape[0]
            t = 0
            while a + t * MPc < rs + h:
                w0 = a + t * MPc
                lo = max(rs, w0)
                hi = min(rs + h, w0 + MPc)
                if hi > lo:
                    groups.setdefault(w0, []).append((j, lo, hi))
                t += 1
        return groups

    mp_cands = [m for m in (8, 16, 24, 32, 48, 64, 96, 128, 192, 256)
                if m % CR == 0]
    kc_cands = [k for k in (4, 8, 12, 16, 24, 32, 48, 64)
                if k % KC_ALIGN == 0 and k * CC <= _MAX_KP]
    best = None
    for MPc in mp_cands:
        groups = window_groups(MPc)
        kc_per_group = [sum(block_kc(j) for j, _, _ in g)
                        for g in groups.values()]
        for KCc in kc_cands:
            canvases = sum(-(-k // KCc) for k in kc_per_group)
            vbytes = canvases * MPc * KCc * CC * 4
            aux = canvases * (KCc * (NC + 1) + (MPc // CR) * (NR + 1)) * 2
            cost = vbytes + aux + canvases * _SLOT_TAX
            if best is None or cost < best[0]:
                best = (cost, MPc, KCc)
    _, MP, KCn = best
    KP = KCn * CC

    # -- emit slots -----------------------------------------------------------
    # Walk each window group's members (mirrored first, so mirror chunks are
    # a prefix of every canvas), cutting canvases of KC* chunks; a member
    # whose chunk cover exceeds the remaining space splits by chunk range.
    slot_rows = []   # (w0, [(j, lo, hi, q0, q1)], nmir_chunks)
    groups = window_groups(MP)
    for w0, pieces in sorted(groups.items()):
        pieces = sorted(pieces, key=lambda p: not entries[p[0]][3])
        cur, used, curmir = [], 0, 0
        for j, lo, hi in pieces:
            kc_b = block_kc(j)
            mi = entries[j][3]
            q0 = 0
            while q0 < kc_b:
                if used == KCn:
                    slot_rows.append((w0, cur, curmir))
                    cur, used, curmir = [], 0, 0
                take = min(kc_b - q0, KCn - used)
                if take < kc_b - q0 and used > 0 and q0 == 0 \
                        and kc_b <= KCn:
                    # member fits a fresh canvas: avoid mid-member split
                    slot_rows.append((w0, cur, curmir))
                    cur, used, curmir = [], 0, 0
                    take = kc_b
                cur.append((j, lo, hi, q0, q0 + take))
                if mi:
                    curmir += take
                used += take
                q0 += take
        if cur:
            slot_rows.append((w0, cur, curmir))

    # Grid group size G: the reference kernels tile the slots G at a time
    # (a multiple of 8 where the canvas allows).  The port's kernels take
    # any slot count; G only fixes how many zero slots pad the plan.
    canvas_b = MP * KP * 4
    nb_real = len(slot_rows)
    if optimize not in ("auto", "latency", "throughput", None):
        raise ValueError(f"unknown optimize={optimize!r}; expected 'auto', "
                         "'latency', 'throughput' or None")
    if optimize != "throughput" and canvas_b * 8 <= 4 * _STEP_BYTES and (
            round_up(max(1, -(-nb_real // 8)), 8) * canvas_b
            <= 4 * _STEP_BYTES):
        # an even step count around 2-8, zero-slot padding capped at ~25%
        g_cap = max(8, (4 * _STEP_BYTES // canvas_b) // 8 * 8)
        G = steps = None
        for target in (2, 4, 6, 8):
            g = round_up(max(1, -(-nb_real // target)), 8)
            if g <= g_cap and target * g <= nb_real + max(8, nb_real // 4):
                G, steps = g, target
                break
        if G is None:
            G = min(g_cap, round_up(nb_real, 8))
            steps = -(-nb_real // G)
    elif canvas_b * 8 <= 4 * _STEP_BYTES:
        # G a multiple of 8 within the step budget: the step count with the
        # fewest padded bytes plus a per-step tax
        g_cap = max(8, (4 * _STEP_BYTES // canvas_b) // 8 * 8)
        steps_lo = max(1, -(-nb_real // g_cap))
        steps_hi = max(steps_lo, -(-nb_real // 8))
        best_g = None
        for steps in range(steps_lo, steps_hi + 1):
            g = round_up(-(-nb_real // steps), 8)
            if g > g_cap:
                continue
            cost = steps * g * canvas_b + steps * 16_384
            if best_g is None or cost < best_g[0]:
                best_g = (cost, g, steps)
        _, G, steps = best_g
    else:
        # canvas too large for a G that is a multiple of 8
        G = max(1, _STEP_BYTES // canvas_b)
        G = min(G, nb_real)
        steps = -(-nb_real // G)
        G = -(-nb_real // steps)
    nb = steps * G
    vals = np.zeros((nb, MP, KP), np.float32)
    colc = np.full((nb, KCn), NC, np.int32)        # sentinel -> zero chunk
    rstart = np.zeros((nb,), np.int32)             # padded slots: zero window
    mirkc = np.zeros((nb,), np.int32)
    for si, (w0, mem, nmir) in enumerate(slot_rows):
        rstart[si] = w0
        mirkc[si] = nmir
        kpos = 0
        for (j, lo, hi, q0, q1) in mem:
            blk, rs, cs, mi = entries[j]
            c_off = cs % CC
            # column range of chunks [q0, q1) within the block's cover
            cl = max(0, q0 * CC - c_off)
            ch = min(blk.shape[1], q1 * CC - c_off)
            sub = blk[lo - rs:hi - rs, cl:ch]
            place_off = c_off if q0 == 0 else 0
            vals[si, lo - w0:hi - w0,
                 kpos * CC + place_off: kpos * CC + place_off + sub.shape[1]
                 ] += sub
            colc[si, kpos:kpos + (q1 - q0)] = (
                cs // CC + q0 + np.arange(q1 - q0))
            kpos += q1 - q0

    bucket = PatchBucket(MP=MP, KP=KP, G=G, vals=vals, col_chunk=colc,
                         row_start=rstart, mirror_kc=mirkc)
    return PatchPlan(
        nrows=nrows, ncols=ncols, buckets=(bucket,),
        symmetric=symmetric, logical_nnz=int(logical),
    )
