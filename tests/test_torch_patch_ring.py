"""Kernels B7 and B10 on their bulk-copy rings: what their launches rely on,
on the CPU.

The CUDA kernels (``csrc/patch_spmv1.cu``; ``csrc/panel2_spmv.cu`` on
``csrc/panel_ring.cuh``, the ring it shares with kernel B5) run only on a
card (``chip_smoke.py`` phases 1, 10 and 11).  Here:

* B7's live row-tile table (``patch_spmv1.live_row_tiles``) on the fixture
  plans of ``test_torch_patch_spmv.py`` (general, rectangular, VBCRS-like,
  symmetric fused, G = 1) and a G = 1 plan whose row windows run past n:
  every nonzero value lies in a listed tile below its width, no listed
  tile is all zero, the table ``patch_device_arrays`` stages is that
  table, and a sum driven by the table alone -- the kernel's walk over
  [8, 128] units -- equals ``patch_spmv1_plain`` in modes f, t, m and a
  (f64, 1e-13 relative to max(1, max|ref|)); where x holds inf at rows only
  all-zero tiles face, that sum equals scipy's product over the blocks and
  stays finite, where the plain version gives NaN;
* B10's ring tables on v2 plans of ``test_torch_panel2.py``'s fixtures at
  seg 8, 16 and 32, plain and fused mirror: in every slab the padding tiles
  trail the live ones (as ``test_torch_panel_ring.py`` holds for v1), and
  the x and y bases per segment the producer writes (``ring_bases``, as
  ``V2Geo`` in the ring computes them) put every lane where
  ``panel2_spmv._lane_index`` puts it;
* on CPU tensors both wrappers take their plain versions, whatever
  ``tiles`` and ``tiles_per_block`` say, and count no launch.
"""

import functools

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import blocksparse_tpu_torch as bt
from blocksparse_tpu_torch.core import panel2
from blocksparse_tpu_torch.core.layout import build_layout
from blocksparse_tpu_torch.core.patch import CC, CR, build_patch_plan
from blocksparse_tpu_torch.ops import patch_engine
from blocksparse_tpu_torch.ops.kernels import panel2_spmv, patch_spmv1

from test_torch_panel2 import GENERAL as V2_GENERAL
from test_torch_panel2 import SYMMETRIC as V2_SYMMETRIC
from test_torch_patch_spmv import GENERAL, _vbcrs, relerr, symmetric_fixture

torch.set_num_threads(2)

TOL64 = 1e-13


def _past_n():
    """Five 120 x 1000 blocks in a 2030^2 matrix (``chip_smoke.py``'s
    phase-1 recipe): one slot per canvas of 128 x 1024 (G = 1), row windows
    that run past n, and rows 120-127 of each window covered by no block."""
    rng = np.random.default_rng(14)
    n, starts = 2030, [(0, 0), (256, 1000), (1910, 0), (1910, 1000),
                       (640, 512)]
    rows = [np.arange(r, r + 120) for r, _ in starts]
    cols = [np.arange(c, min(c + 1000, n)) for _, c in starts]
    blocks = [rng.standard_normal((120, len(c))).astype(np.float32)
              for c in cols]
    return blocks, rows, cols, (n, n)


def _vbcrs_blocks():
    blocks, rs, cs, shape = _vbcrs()
    return (blocks, [np.arange(r, r + b.shape[0]) for r, b in zip(rs, blocks)],
            [np.arange(c, c + b.shape[1]) for c, b in zip(cs, blocks)], shape)


def _symmetric_blocks():
    """The symmetric fixture as the blocks of S (each stored off-diagonal
    also transposed), for scipy."""
    d, di, o, ri, ci, shape = symmetric_fixture()
    return (list(d) + list(o) + [b.T for b in o], list(di) + list(ri) + list(ci),
            list(di) + list(ci) + list(ri), shape)


PATCH = {**{k: GENERAL[k] for k in GENERAL}, "vbcrs": _vbcrs_blocks,
         "G = 1, windows past n": _past_n, "symmetric fused":
         _symmetric_blocks}


@functools.lru_cache(maxsize=None)
def patch_plan(kind):
    """(plan, blocks, rows, cols, shape)."""
    if kind == "symmetric fused":
        d, di, o, ri, ci, shape = symmetric_fixture()
        plan = build_patch_plan(build_layout(d, di, di, shape),
                                extra_layout=build_layout(o, ri, ci, shape))
        assert plan.symmetric
    else:
        blocks, rows, cols, shape = PATCH[kind]()
        plan = build_patch_plan(build_layout(blocks, rows, cols, shape))
    return (plan,) + tuple(PATCH[kind]())


def test_fixture_plans_have_what_the_table_skips():
    """The fixtures drive what B7's table is for: all-zero row tiles, tiles
    narrower than KP, a G = 1 plan whose windows run past n."""
    skipped = narrow = 0
    for kind in PATCH:
        plan = patch_plan(kind)[0]
        for b in plan.buckets:
            tiles = patch_spmv1.live_row_tiles(b.vals)
            skipped += b.nb * (b.MP // CR) - len(tiles)
            narrow += int(np.sum(tiles[:, 1] < b.KP // CC))
    assert skipped and narrow
    plan = patch_plan("G = 1, windows past n")[0]
    b = plan.buckets[0]
    assert b.G == 1 and int(b.row_start.max()) + b.MP > plan.nrows


@pytest.mark.parametrize("kind", list(PATCH))
def test_live_row_tiles_cover_every_nonzero(kind):
    plan = patch_plan(kind)[0]
    for b in plan.buckets:
        tiles = patch_spmv1.live_row_tiles(b.vals)
        MT, KC = b.MP // CR, b.KP // CC
        assert tiles.dtype == np.int32 and tiles.shape[1] == 2
        assert np.all(np.diff(tiles[:, 0]) > 0)           # slot, tile order
        assert np.all((tiles[:, 1] >= 1) & (tiles[:, 1] <= KC))
        listed = np.zeros((b.nb * MT, KC), bool)
        for t, w in tiles:
            listed[t, :w] = True
            tile = b.vals[t // MT, (t % MT) * CR:(t % MT + 1) * CR]
            assert np.any(tile[:, (w - 1) * CC:w * CC])   # none all zero
        nz = (b.vals.reshape(b.nb * MT, CR, KC, CC) != 0).any(axis=(1, 3))
        assert not np.any(nz & ~listed)
        # chunks past a slot's columns (sentinels) are never listed
        sentinel = b.col_chunk.repeat(MT, axis=0) >= -(-plan.ncols // CC)
        assert not np.any(listed & sentinel)


@pytest.mark.parametrize("kind", list(PATCH))
def test_staged_table_is_the_live_row_tiles(kind):
    plan = patch_plan(kind)[0]
    dev = patch_engine.patch_device_arrays(plan, "cpu")
    for b, arrays in zip(plan.buckets, dev):
        assert arrays.tiles.dtype == torch.int32
        assert np.array_equal(arrays.tiles.numpy(),
                              patch_spmv1.live_row_tiles(b.vals))


def table_sum(vals, cc, rs, mk, tiles, x, n_out, mode):
    """The product B7 computes, driven by the live row-tile table alone, in
    the kernel's order of work: unit by unit ([8 rows, 128 columns] of a
    tile, the last one short), x past len(x) read as 0, y past n_out
    dropped; float64 numpy."""
    vals, x = np.asarray(vals, np.float64), np.asarray(x, np.float64)
    MT = vals.shape[1] // CR
    xe = np.concatenate([x, [0.0]])
    y = np.zeros(n_out + 1)
    for t, w in np.asarray(tiles):
        b, mi = divmod(int(t), MT)
        rows = int(rs[b]) + mi * CR + np.arange(CR)
        rows_x = np.where(rows < len(x), rows, len(x))
        rows_y = np.where(rows < n_out, rows, n_out)
        for s0 in range(0, int(w) * CC, 128):
            k = np.arange(s0, min(s0 + 128, int(w) * CC))
            chunk = k // CC
            cols = np.asarray(cc[b], np.int64)[chunk] * CC + k % CC
            V = vals[b, mi * CR:(mi + 1) * CR][:, k]
            fwd = mode in "fm" or chunk < mk[b]            # a: j < mk only
            mir = mode in "ta" or chunk < mk[b]            # m: j < mk only
            if mode != "t":
                xg = np.where(fwd & (cols < len(x)), xe[np.minimum(
                    cols, len(x))], 0.0)
                np.add.at(y, rows_y, V @ xg)
            if mode != "f":
                yt = np.where(mir, V.T @ xe[rows_x], 0.0)
                np.add.at(y, np.where(cols < n_out, cols, n_out), yt)
    return y[:n_out]


def _sides(plan, mode):
    """(n_in, n_out) of a mode: x on the columns in f and m, on the rows in
    t and a (the plans of the m / a tests on a general operand have mk = 0)."""
    m, n = plan.nrows, plan.ncols
    return (n, m) if mode in "fm" else (m, n)


@pytest.mark.parametrize("mode", ["f", "t", "m", "a"])
@pytest.mark.parametrize("kind", list(PATCH))
def test_table_sum_equals_plain(kind, mode):
    plan = patch_plan(kind)[0]
    n_in, n_out = _sides(plan, mode)
    x = np.random.default_rng(61).standard_normal(n_in)
    for b in plan.buckets:
        tiles = patch_spmv1.live_row_tiles(b.vals)
        got = table_sum(b.vals, b.col_chunk, b.row_start, b.mirror_kc, tiles,
                        x, n_out, mode)
        ref = patch_spmv1.patch_spmv1_plain(
            torch.from_numpy(b.vals).double(), torch.from_numpy(b.col_chunk),
            torch.from_numpy(b.row_start), torch.from_numpy(b.mirror_kc),
            torch.from_numpy(x), n_out, mode)
        assert relerr(got, ref) <= TOL64


def _scipy(blocks, rows, cols, shape):
    r = np.concatenate([np.repeat(np.asarray(ri), len(ci))
                        for ri, ci in zip(rows, cols)])
    c = np.concatenate([np.tile(np.asarray(ci), len(ri))
                        for ri, ci in zip(rows, cols)])
    v = np.concatenate([np.asarray(b, np.float64).reshape(-1)
                        for b in blocks])
    return sp.coo_matrix((v, (r, c)), shape=shape).tocsr()


@pytest.mark.parametrize("mode", ["t", "a"])
def test_inf_where_only_zero_tiles_face_it(mode):
    """Modes t and a read x at a tile's rows (a general plan has mk = 0, so
    mode a is mode t): inf at rows no listed tile covers leaves the table's
    sum finite and equal to scipy's A^T x over the blocks, while the plain
    version, which multiplies the plan's padding too, gives NaN."""
    plan, blocks, rows, cols, shape = patch_plan("G = 1, windows past n")
    b = plan.buckets[0]
    tiles = patch_spmv1.live_row_tiles(b.vals)
    MT = b.MP // CR
    covered = np.zeros(plan.nrows + b.MP, bool)
    for t in tiles[:, 0]:
        r0 = int(b.row_start[t // MT]) + (t % MT) * CR
        covered[r0:r0 + CR] = True
    windows = np.zeros_like(covered)
    for r0 in b.row_start:
        windows[r0:r0 + b.MP] = True
    faced = np.flatnonzero(windows[:plan.nrows] & ~covered[:plan.nrows])
    assert faced.size
    x = np.random.default_rng(62).standard_normal(plan.nrows)
    x[faced] = np.inf
    got = table_sum(b.vals, b.col_chunk, b.row_start, b.mirror_kc, tiles, x,
                    plan.ncols, mode)
    ref = _scipy(blocks, rows, cols, shape).T @ x
    assert np.all(np.isfinite(got)) and relerr(got, ref) <= TOL64
    plain = patch_spmv1.patch_spmv1_plain(
        torch.from_numpy(b.vals).double(), torch.from_numpy(b.col_chunk),
        torch.from_numpy(b.row_start), torch.from_numpy(b.mirror_kc),
        torch.from_numpy(x), plan.ncols, mode)
    assert torch.isnan(plain).any()


@pytest.mark.parametrize("mode", ["f", "t", "m", "a"])
def test_patch_spmv1_on_cpu_takes_the_plain_version(mode):
    plan = patch_plan("symmetric fused")[0]
    vals, cc, rs, mk = patch_engine.patch_device_arrays(plan, "cpu")[0]
    n_in, n_out = _sides(plan, mode)
    x = torch.from_numpy(np.random.default_rng(63).standard_normal(
        n_in).astype(np.float32))
    before = patch_spmv1.LAUNCHES
    ref = patch_spmv1.patch_spmv1_plain(vals, cc, rs, mk, x, n_out, mode)
    tiles = torch.from_numpy(patch_spmv1.live_row_tiles(vals.numpy()))
    for kw in ({}, {"tiles": tiles}, {"tiles": tiles, "tiles_per_block": 1}):
        assert torch.equal(patch_spmv1.patch_spmv1(vals, cc, rs, mk, x, n_out,
                                                   mode, **kw), ref)
    assert patch_spmv1.LAUNCHES == before


def test_live_tile_bytes():
    tiles = np.array([[0, 3], [5, 24], [9, 1]], np.int32)
    assert patch_spmv1.live_tile_bytes(tiles) == 28 * CR * CC * 4
    assert patch_spmv1.live_tile_bytes(torch.from_numpy(tiles)) == \
        28 * CR * CC * 4


# -- B10 ------------------------------------------------------------------------

V2_KINDS = ["contiguous 16", "clustered 8", "uniform aligned", "rectangular",
            "vbcrs 15"]
V2_MIRROR = ["seg 8", "fused", "expanded"]


@functools.lru_cache(maxsize=None)
def v2_plan(kind, seg):
    if kind in V2_SYMMETRIC:
        d, di, o, ri, ci, shape = V2_SYMMETRIC[kind]()
        diag = panel2._layout_entries(build_layout(d, di, di, shape),
                                      transpose=False)
        off = panel2._layout_entries(build_layout(o, ri, ci, shape),
                                     transpose=False)
        plan = panel2.build_panel2_plan(
            diag + [(b, r, c, True) for b, r, c, _ in off], shape, seg=seg,
            mirror=True)
        assert plan.mirror
        return plan
    blocks, rows, cols, shape = V2_GENERAL[kind]()
    return panel2.build_panel2_plan(
        panel2._layout_entries(build_layout(blocks, rows, cols, shape),
                               transpose=False), shape, seg=seg)


V2_CASES = [(k, s) for k in V2_KINDS + V2_MIRROR for s in (8, 16, 32)]


@pytest.mark.parametrize("kind,seg", V2_CASES)
def test_v2_padding_trails_live_tiles(kind, seg):
    """B10's producer copies a stage's live tiles as one span, as B5's: in
    every slab of a v2 plan the live tiles are a prefix."""
    plan = v2_plan(kind, seg)
    assert plan.seg == seg
    rid = plan.rid8.reshape(plan.S, plan.TS)
    cid = plan.cid8.reshape(plan.S, plan.TS)
    live = rid < plan.RW
    n_live = live.sum(axis=1)
    assert np.array_equal(live, np.arange(plan.TS)[None, :] < n_live[:, None])
    assert int(n_live.sum()) == plan.nt
    assert np.all(rid[live] >= 0) and np.all(rid[~live] == plan.RW)
    assert np.all((cid[live] >= 0) & (cid[live] < plan.CW))
    assert np.all(cid[~live] == plan.CW)


def ring_bases(plan):
    """What B10's producer writes into a ring slot for each segment of the
    plan (``V2Geo`` in ``csrc/panel_ring.cuh``): x's base ``segid * seg``
    and, on a mirror plan, y's base ``tgt * seg``, -1 for the sentinels
    (NC, n_yseg) and anything outside them; [S, CW, NSEG] each (y None on
    a plain plan)."""
    def bases(table, sentinel):
        t = np.asarray(table, np.int64).reshape(plan.S, plan.CW, plan.nseg)
        return np.where((t >= 0) & (t < sentinel), t * plan.seg, -1)
    return (bases(plan.segid, plan.NC),
            bases(plan.tgt, plan.n_yseg) if plan.mirror else None)


def _lanes(bases, seg, limit):
    """Every lane's index from per-segment bases [S, CW, NSEG]: base +
    k % seg, ``limit`` for dropped segments and indices >= ``limit``."""
    S, CW, nseg = bases.shape
    idx = bases[..., None] + np.arange(seg)
    idx = np.where((bases[..., None] >= 0) & (idx < limit), idx, limit)
    return idx.reshape(S, CW, nseg * seg)


@pytest.mark.parametrize("kind,seg", V2_CASES)
def test_v2_ring_bases_place_every_lane(kind, seg):
    plan = v2_plan(kind, seg)
    xb, yb = ring_bases(plan)
    assert xb.shape == (plan.S, plan.CW, 128 // seg)
    segid = torch.from_numpy(plan.segid.reshape(-1))
    assert np.array_equal(
        _lanes(xb, seg, plan.ncols),
        panel2_spmv._lane_index(plan, segid, plan.NC, plan.ncols).numpy())
    assert (yb is None) == (not plan.mirror)
    if plan.mirror:
        tgt = torch.from_numpy(plan.tgt.reshape(-1))
        assert np.array_equal(
            _lanes(yb, seg, plan.nrows),
            panel2_spmv._lane_index(plan, tgt, plan.n_yseg,
                                    plan.nrows).numpy())


def test_panel2_spmv_on_cpu_takes_the_plain_version():
    """tiles_per_block changes nothing on the CPU: the plain version runs,
    no launch is counted."""
    plan = v2_plan("fused", 16)
    dev = panel2_spmv.panel2_device_arrays(plan, "cpu")
    x = torch.from_numpy(np.random.default_rng(64).standard_normal(
        plan.ncols).astype(np.float32))
    before = (panel2_spmv.LAUNCHES, panel2_spmv.MIRROR_LAUNCHES)
    ref = panel2_spmv.panel2_apply_plain(plan, dev, x)
    for tpb in (None, 1, 7):
        assert torch.equal(panel2_spmv.panel2_spmv(plan, dev, x,
                                                   tiles_per_block=tpb), ref)
    assert (panel2_spmv.LAUNCHES, panel2_spmv.MIRROR_LAUNCHES) == before


def test_patch_route_products_stay_on_the_plain_version():
    """A format built with patch="always" on the CPU: the product through
    the staged table equals scipy over the blocks (f32: 1e-5)."""
    blocks, rows, cols, shape = _past_n()
    A = bt.BlockSparseMatrix(blocks, rows, cols, shape, device="cpu",
                             patch="always")
    x = np.random.default_rng(65).standard_normal(shape[1]).astype(
        np.float32)
    before = patch_spmv1.LAUNCHES
    y = A @ torch.from_numpy(x)
    assert relerr(y, _scipy(blocks, rows, cols, shape) @ x.astype(
        np.float64)) <= 1e-5
    assert patch_spmv1.LAUNCHES == before
