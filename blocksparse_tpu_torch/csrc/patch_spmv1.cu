// Merged-patch SpMV (r = 1) on Hopper (kernel B7 of the port).
//
// Replaces blocksparse_tpu/ops/patch_engine.py::_kern1_f, ::_kern1_t and
// ::_kern1_m (launched from _spmv_kernel_raw / patch_spmv_kernel) together
// with the one-hot chunk gathers and scatters that patch_spmv_kernel ran
// around them as XLA matmuls.  For every slot b of a patch plan, with V_b of
// shape [MP, KP], its KP/32 column chunks cc[b] (sentinel NC) and the row
// window starting at rs[b]; col(k) = cc[b, k/32]*32 + k%32, row(m) = rs[b] + m:
//   f  y[row(m)] += sum_k V_b[m, k] x[col(k)]                     (A x)
//   t  y[col(k)] += sum_m V_b[m, k] x[row(m)]                     (A^T x)
//   m  both from one read of V_b, the second only for chunks
//      k/32 < mk[b] (a symmetric plan's stored off-diagonal chunks)
//   a  the transpose of m (the backward pass's dx): t on every chunk, plus
//      f reading x only on chunks k/32 < mk[b]
// x indices at or past n_in read 0 and y indices at or past n_out are
// dropped, so no padded buffers are needed (as B2).  Unlike the TPU kernel,
// which blocked slots G at a time for Mosaic (G % 8 == 0), any slot count is
// taken.
//
// The live row tiles.  The plan pads each slot's row window to MP rows and
// its columns to KP with sentinel chunks, so many of its [8, KP] row tiles
// are all zero (a VBCRS row group of 16 rows in a 64-row window) and most
// end in zero chunks.  The kernel reads the values only through a table
// built on the host beside the plan (ops/kernels/patch_spmv1.py,
// live_row_tiles): one entry (b * MP/8 + mi, width) per row tile mi of slot
// b that holds a nonzero value, in slot order, with `width` the chunks up to
// and including its last chunk that holds one.  Every nonzero value lies in
// a listed tile below its width, so for finite x the product is the plan's.
// For x that holds inf or NaN, the dropped values (whole zero tiles, and the
// zero chunks past a tile's width) never meet it: where only such values
// face a non-finite x, y stays finite, as scipy's product over the blocks
// does, while a dense sum over the plan gives NaN (0 * inf).
//
// What bounds it on the card: each value is read once for 2 flops (4 in
// modes m and a), so the live tiles' bytes bound it.  Design, the ring of
// kernel B5 (panel_ring.cuh) over the table:
//
//   * Persistent blocks over contiguous ranges of the table: one range per
//     resident block (1-3 per SM, as their rings fit).
//   * One producer warp reads the range's table ahead, a window of kWin
//     entries at a time with coalesced loads, and cuts the live tiles into
//     units of [8 rows, 128 columns] (a tile of width w has ceil(w / 4),
//     the last one short) and stages of up to kUnits units: whole tiles
//     while they fit, a tile wider than a stage split across stages.  Each
//     tile's piece of a stage lands as [8][k*128] floats (k its units),
//     by 1-D bulk copies (cp.async.bulk, completing on the stage's
//     mbarrier): one per row of width*128 bytes or less -- the bytes the
//     tile holds and no more -- or, for a whole full-width tile, whose
//     rows are one span in the plan, one copy.
//   * The producer writes each stage's tables into its ring slot before it
//     arrives: per unit its place in the stage, its row tile, slot, stretch
//     and row window, and the chunk id of each of its four 32-lane segments
//     (-1 past the tile's width: not copied, not read).  Their loads (rs,
//     mk, cc) are issued one stage ahead, and each stage's copies before the
//     previous stage's tables are written.
//   * Eight consumer warps.  Lane l owns columns 4l .. 4l+3 of a unit: one
//     float4 of each of its 8 rows from shared memory.  Mode f: warp w takes
//     unit w of each stage and keeps the eight row sums in registers while
//     its units stay in one row tile.  Modes t, m, a: warp w takes the units
//     of the stretches s with s % 8 == w, so each 128-column stretch of a
//     slot has one owner warp; the owner sums V^T x[the unit's 8 rows] into
//     its own [128]-float accumulator of that stretch in shared memory
//     (plain loads and stores: no other thread touches it) and flushes it
//     into y when its units move to another slot; the forward sums of modes
//     m and a are kept in registers as in mode f.
//
// Race-freedom: slots share output rows and columns and blocks run in no
// order, so every add into y is an fp32 atomic into the zeroed output the
// wrapper allocated: a warp's row sums once per row-tile change (scalar
// atomics), an owner warp's column sums once per slot visit (one float4
// atomicAdd per nonzero group of four columns; scalar where a group runs
// past n_out or y is not 16-byte aligned).  The summation order varies
// between runs.  The launch's tiles per block moves sums between registers,
// shared memory and atomics: 1 flushes every tile on its own, ntiles keeps a
// slot's column sums in one block.  The TPU kernel wrote per-slot vectors
// and left the scatter-add to XLA.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "panel_ring.cuh"
#include "tile_stream.cuh"

namespace {

using bst_ring::add4;
using bst_ring::bulk_load;
using bst_ring::expect_bytes;
using bst_tma::mbar_arrive;
using bst_tma::mbar_init;
using bst_tma::mbar_wait;

constexpr int kCC = 32;                   // column chunk width of the plan
constexpr int kRows = bst::kTileRows;     // rows of a row tile
constexpr int kCols = bst::kTileCols;     // columns of a unit
constexpr int kUnitFloats = kRows * kCols;
constexpr int kUnits = 8;                 // units per stage
constexpr int kConsumers = 8;             // consumer warps
constexpr int kThreads = 32 * (kConsumers + 1);
constexpr int kStageBytes = kUnits * kUnitFloats * 4;  // 32 KB
constexpr int kWin = 512;                 // table entries read ahead
constexpr int kSmStages = 6;              // ring stages per SM
constexpr int kMaxPerSm = 3;              // blocks per SM (2 stages each)
constexpr int kSmemCap = 227 * 1024;
constexpr int kSmSmem = 228 * 1024;
constexpr int kBlockReserve = 1024;

enum Mode { kF = 0, kT = 1, kM = 2, kA = 3 };

struct Args {
  const float* vals;
  const int *cc, *rs, *mk, *tiles;  // tiles [ntiles, 2]: (b*MT + mi, width)
  const float* x;
  float* y;
  long long ntiles, span;  // table entries, of a block's range
  int MP, KP, KC, MT, ntw;  // ntw: stretches each consumer warp owns
  int n_in, n_out, stages;
};

// A ring stage's tables, written by the producer warp before it arrives.
struct Slot {
  int n, pad[3];  // units (-1: the range is done)
  int off[kUnits];    // the unit's row 0 in the stage, in floats
  int pitch[kUnits];  // its row pitch, in floats
  int tile[kUnits];   // its row tile, b * MT + mi
  int row0[kUnits];   // rs[b] + 8 mi
  int b[kUnits], s[kUnits], mk[kUnits];  // slot, stretch, mk[b]
  int cb[kUnits * 4];  // chunk id per 32-lane segment; -1 past the width
};

// A stage the producer has found, with its tables' loads in flight.  Lane j
// < n holds unit j; lane l holds segment l % 4 of unit l / 4 (cb) and the
// bulk copies of rows l % 8 of pieces l / 8 and l / 8 + 4.
struct Stage {
  int n, total;       // units; bytes of all its copies
  int off, pitch, tile, b, s, rs, mk, cb;
  long long src[2];   // float offset into vals (-1: no copy)
  int dst[2], bytes[2];
};

long long smem_bytes(int stages, int ntw, int mode) {
  return (long long)stages * (kStageBytes + sizeof(Slot) + 16) +
         2LL * kWin * 4 +
         (mode == kF ? 0 : (long long)kConsumers * ntw * kCols * 4);
}

__device__ __forceinline__ float dot4(float4 v, const float (&xv)[4],
                                      float acc) {
  acc = fmaf(v.x, xv[0], acc);
  acc = fmaf(v.y, xv[1], acc);
  acc = fmaf(v.z, xv[2], acc);
  return fmaf(v.w, xv[3], acc);
}

template <int MODE>
__global__ void __launch_bounds__(kThreads, kMaxPerSm)
    patch_ring_kernel(const Args a) {
  constexpr unsigned kFull = 0xffffffffu;
  extern __shared__ __align__(128) unsigned char smem[];
  const long long T0 = (long long)blockIdx.x * a.span;
  const long long T1 = min(T0 + a.span, a.ntiles);
  if (T0 >= T1) return;
  const int NST = a.stages, MT = a.MT;
  unsigned char* ring = smem;
  Slot* slots = reinterpret_cast<Slot*>(ring + NST * kStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(slots + NST);
  uint64_t* empty = full + NST;
  int* win_t = reinterpret_cast<int*>(empty + NST);
  int* win_w = win_t + kWin;
  float* tacc = reinterpret_cast<float*>(win_w + kWin);  // [8][ntw][128]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if constexpr (MODE != kF)
    for (int i = tid; i < kConsumers * a.ntw * kCols; i += kThreads)
      tacc[i] = 0.f;
  if (tid == 0) {
    for (int i = 0; i < NST; ++i) {
      mbar_init(&full[i], 32);           // every producer lane arrives
      mbar_init(&empty[i], kConsumers);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers) {  // the producer warp
    long long W0 = T0, T = T0;
    int s0 = 0;  // the first unit of tile T not yet in a stage
    bool fresh = true;
    // The next stage from (T, s0) on, its table loads issued (not waited
    // for); false at the end of the range.
    auto find = [&](Stage& st) -> bool {
      if (T >= T1) return false;
      if (fresh || (T + kUnits > W0 + kWin && W0 + kWin < T1)) {
        __syncwarp();
        W0 = T;
        const int len = (int)min((long long)kWin, T1 - W0);
        for (int k = lane; k < len; k += 32) {
          win_t[k] = __ldg(a.tiles + 2 * (W0 + k));
          win_w[k] = __ldg(a.tiles + 2 * (W0 + k) + 1);
        }
        __syncwarp();
        fresh = false;
      }
      // lane i < 8: the piece of tile T + i in this stage, its first unit
      // sf, its units k, at stage unit e
      const long long avail = min(T1, W0 + kWin) - T;
      int t = 0, w = 0, sf = 0, u = 0;
      if (lane < kUnits && lane < avail) {
        t = win_t[T - W0 + lane];
        w = win_w[T - W0 + lane];
        sf = lane == 0 ? s0 : 0;
        u = (w + 3) / 4 - sf;
      }
      int p = u;  // inclusive scan of u over lanes 0 .. 7
#pragma unroll
      for (int d = 1; d < kUnits; d <<= 1) {
        const int q = __shfl_up_sync(kFull, p, d);
        if (lane >= d) p += q;
      }
      const int e = p - u;
      // whole tiles while they fit; a tile wider than a stage is split
      const int k = lane == 0 ? min(u, kUnits) : (e + u <= kUnits ? u : 0);
      const int last = 31 - __clz(__ballot_sync(kFull, k > 0));
      st.n = __shfl_sync(kFull, e + k, last);
      // unit `lane` lies in piece pj
      int pj = 0;
#pragma unroll
      for (int i = 1; i < kUnits; ++i) {
        const int ei = __shfl_sync(kFull, e, i);
        const int ki = __shfl_sync(kFull, k, i);
        if (ki > 0 && lane >= ei) pj = i;
      }
      const int ep = __shfl_sync(kFull, e, pj);
      const int kp = __shfl_sync(kFull, k, pj);
      const int q = lane - ep;
      st.tile = __shfl_sync(kFull, t, pj);
      const int wu = __shfl_sync(kFull, w, pj);
      st.s = __shfl_sync(kFull, sf, pj) + q;
      st.off = ep * kUnitFloats + q * kCols;
      st.pitch = kp * kCols;
      st.b = st.tile / MT;
      const bool mine = lane < st.n;
      st.rs = mine ? __ldg(a.rs + st.b) : 0;
      st.mk = (MODE == kM || MODE == kA) && mine ? __ldg(a.mk + st.b) : 0;
      {  // segment lane % 4 of unit lane / 4
        const int uq = lane >> 2;
        const int bq = __shfl_sync(kFull, st.b, uq);
        const int cpos = __shfl_sync(kFull, st.s, uq) * 4 + (lane & 3);
        const int wq = __shfl_sync(kFull, wu, uq);
        st.cb = uq < st.n && cpos < wq
                    ? __ldg(a.cc + (long long)bq * a.KC + cpos)
                    : -1;
      }
      int rb = 0;  // row bytes of piece lane (lanes < 8)
      if (lane < kUnits && k > 0)
        rb = (min((sf + k) * kCols, w * kCC) - sf * kCols) * 4;
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // rows lane % 8 of pieces lane/8 + 4h
        const int pc = (lane >> 3) + 4 * h, r = lane & 7;
        const int kc = __shfl_sync(kFull, k, pc);
        const int tc = __shfl_sync(kFull, t, pc);
        const int fc = __shfl_sync(kFull, sf, pc);
        const int ec = __shfl_sync(kFull, e, pc);
        st.bytes[h] = __shfl_sync(kFull, rb, pc);
        st.src[h] = kc > 0 ? ((long long)(tc / MT) * a.MP + (tc % MT) * kRows +
                              r) * a.KP + fc * kCols
                           : -1;
        st.dst[h] = (ec * kUnitFloats + r * kc * kCols) * 4;
        // a piece of whole rows of a full-width tile is one contiguous span
        if (kc * kCols == a.KP && st.bytes[h] == a.KP * 4) {
          st.bytes[h] *= kRows;
          if (r) st.src[h] = -1;
        }
      }
      int sum = rb;
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) sum += __shfl_xor_sync(kFull, sum, d);
      st.total = kRows * sum;
      // where the next stage starts
      const int kl = __shfl_sync(kFull, k, last);
      const int ul = __shfl_sync(kFull, u, last);
      const int fl = __shfl_sync(kFull, sf, last);
      if (kl == ul) {
        T += last + 1;
        s0 = 0;
      } else {
        T += last;
        s0 = fl + kl;
      }
      return true;
    };
    // Stage j's copies: once its slot is free, lane 0 arms the full barrier
    // with the stage's bytes and every lane issues its rows.
    auto copy = [&](int j, const Stage& st) {
      mbar_wait(&empty[j % NST], ((j / NST) & 1) ^ 1);
      if (lane == 0) expect_bytes(&full[j % NST], st.total);
      __syncwarp();
      unsigned char* dst = ring + (j % NST) * kStageBytes;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (st.src[h] >= 0)
          bulk_load(dst + st.dst[h], a.vals + st.src[h], st.bytes[h],
                    &full[j % NST]);
    };
    // Stage j's tables into its slot (their loads done by now), then every
    // lane arrives.
    auto post = [&](int j, const Stage& st) {
      Slot& sl = slots[j % NST];
      if (lane < st.n) {
        sl.off[lane] = st.off;
        sl.pitch[lane] = st.pitch;
        sl.tile[lane] = st.tile;
        sl.row0[lane] = st.rs + (st.tile % MT) * kRows;
        sl.b[lane] = st.b;
        sl.s[lane] = st.s;
        sl.mk[lane] = st.mk;
      }
      sl.cb[lane] = st.cb;
      if (lane == 0) sl.n = st.n;
      mbar_arrive(&full[j % NST]);
    };
    // the copies run one stage ahead of the tables
    Stage cur, next;
    bool have = find(cur);  // true: the range is not empty
    copy(0, cur);
    int i = 0;  // stages posted
    while (have) {
      const bool more = find(next);
      if (more) copy(i + 1, next);
      post(i, cur);
      ++i;
      cur = next;
      have = more;
    }
    const int slot = i % NST;  // the end marker
    mbar_wait(&empty[slot], ((i / NST) & 1) ^ 1);
    if (lane == 0) slots[slot].n = -1;
    mbar_arrive(&full[slot]);
    return;
  }

  // consumer warps
  const float* x = a.x;
  float* y = a.y;
  const bool xal = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const bool yal = (reinterpret_cast<uintptr_t>(y) & 15) == 0;
  float* tw = tacc + warp * a.ntw * kCols + 4 * lane;  // this lane's columns
  float acc[kRows];
#pragma unroll
  for (int m = 0; m < kRows; ++m) acc[m] = 0.f;
  int cur = -1, cur_row0 = 0;  // the row tile whose sums the registers hold
  int slot_b = -1;             // the slot whose column sums tacc holds

  auto flush_rows = [&]() {  // registers -> y
    const float tot = bst::warp_rows_total(acc, lane);
    const int row = cur_row0 + ((lane >> 2) & 7);
    if ((lane & 3) == 0 && row < a.n_out) atomicAdd(y + row, tot);
#pragma unroll
    for (int m = 0; m < kRows; ++m) acc[m] = 0.f;
  };
  auto flush_cols = [&]() {  // this warp's stretches of slot slot_b -> y
    for (int i = 0; i < a.ntw; ++i) {
      const int s = warp + kConsumers * i;
      if (s * kCols >= a.KP) break;
      float4* e = reinterpret_cast<float4*>(tw + i * kCols);
      const float4 v = *e;
      if (v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f) {
        *e = make_float4(0.f, 0.f, 0.f, 0.f);
        const int c = __ldg(a.cc + (long long)slot_b * a.KC + s * 4 +
                            (lane >> 3));
        add4(y, c * kCC + 4 * (lane & 7), a.n_out, v, yal);
      }
    }
  };
  auto unit = [&](const Slot& sl, const float* stage, int j) {
    const int s = sl.s[j], row0 = sl.row0[j], pitch = sl.pitch[j];
    const int c = sl.cb[j * 4 + (lane >> 3)];
    const int cpos = s * 4 + (lane >> 3);
    const float* V = stage + sl.off[j] + 4 * lane;
    float4 v[kRows];
#pragma unroll
    for (int m = 0; m < kRows; ++m)
      v[m] = c >= 0 ? *reinterpret_cast<const float4*>(V + m * pitch)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    if constexpr (MODE != kT) {  // y[rows] += V x[columns]
      if (sl.tile[j] != cur) {
        if (cur >= 0) flush_rows();
        cur = sl.tile[j];
        cur_row0 = row0;
      }
      float xv[4] = {0.f, 0.f, 0.f, 0.f};
      if (c >= 0 && (MODE != kA || cpos < sl.mk[j])) {
        const int idx = c * kCC + 4 * (lane & 7);
        if (xal && idx + 3 < a.n_in) {
          const float4 t = __ldg(reinterpret_cast<const float4*>(x + idx));
          xv[0] = t.x, xv[1] = t.y, xv[2] = t.z, xv[3] = t.w;
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            xv[q] = idx + q < a.n_in ? __ldg(x + idx + q) : 0.f;
        }
      }
#pragma unroll
      for (int m = 0; m < kRows; ++m) acc[m] = dot4(v[m], xv, acc[m]);
    }
    if constexpr (MODE != kF) {  // y[columns] += V^T x[rows]
      if (sl.b[j] != slot_b) {
        if (slot_b >= 0) flush_cols();
        slot_b = sl.b[j];
      }
      const int xrow = row0 + (lane & 7);
      const float xl = xrow < a.n_in ? __ldg(x + xrow) : 0.f;
      float4 yt = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int m = 0; m < kRows; ++m) {
        const float xm = __shfl_sync(0xffffffffu, xl, m);
        yt.x = fmaf(v[m].x, xm, yt.x);
        yt.y = fmaf(v[m].y, xm, yt.y);
        yt.z = fmaf(v[m].z, xm, yt.z);
        yt.w = fmaf(v[m].w, xm, yt.w);
      }
      if (MODE != kM || cpos < sl.mk[j]) {
        float4* e = reinterpret_cast<float4*>(tw + (s / kConsumers) * kCols);
        float4 t = *e;
        t.x += yt.x, t.y += yt.y, t.z += yt.z, t.w += yt.w;
        *e = t;
      }
    }
  };

  for (int i = 0;; ++i) {
    const int slot = i % NST;
    mbar_wait(&full[slot], (i / NST) & 1);
    const Slot& sl = slots[slot];
    const int n = sl.n;
    if (n < 0) break;
    const float* stage =
        reinterpret_cast<const float*>(ring + slot * kStageBytes);
    if constexpr (MODE == kF) {
      if (warp < n) unit(sl, stage, warp);
    } else {
      for (int j = 0; j < n; ++j)
        if (sl.s[j] % kConsumers == warp) unit(sl, stage, j);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);
  }
  if constexpr (MODE != kT)
    if (cur >= 0) flush_rows();
  if constexpr (MODE != kF)
    if (slot_b >= 0) flush_cols();
}

// The launch geometry, as B5's (panel_ring.cuh): the most blocks per SM (at
// most kMaxPerSm) whose rings of kSmStages / blocks stages fit beside their
// tables and column accumulators, else one block with as many stages as fit;
// tpb > 0 sets the range, 0 cuts the table into one range per resident block.
struct Geometry {
  int stages, per_sm;
  long long smem, blocks, span;
};

bool geometry(long long ntiles, int ntw, int mode, long long tpb, int sms,
              Geometry* g) {
  g->per_sm = 1;
  g->stages = 0;
  for (int k = kMaxPerSm; k > 1 && !g->stages; --k)
    if (k * (smem_bytes(kSmStages / k, ntw, mode) + kBlockReserve) <=
        kSmSmem)
      g->per_sm = k, g->stages = kSmStages / k;
  if (!g->stages)
    g->stages = (int)std::min(
        (long long)kSmStages, (kSmemCap - smem_bytes(0, ntw, mode)) /
                                  (kStageBytes + (long long)sizeof(Slot) + 16));
  if (g->stages < 1) return false;
  g->smem = smem_bytes(g->stages, ntw, mode);
  const long long ranges = (long long)sms * g->per_sm;
  g->span = tpb > 0 ? tpb : (ntiles + ranges - 1) / ranges;
  g->blocks = (ntiles + g->span - 1) / g->span;
  return g->blocks < (1LL << 31);
}

int stretches_per_warp(int KP) {
  return (KP / kCols + kConsumers - 1) / kConsumers;
}

template <int MODE>
int launch_mode(const Args& a, const Geometry& g, cudaStream_t s) {
  const cudaError_t e = cudaFuncSetAttribute(
      patch_ring_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)g.smem);
  if (e != cudaSuccess) return (int)e;
  patch_ring_kernel<MODE><<<(unsigned)g.blocks, kThreads, g.smem, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// The geometry B7 launches with on the current card for `ntiles` live row
// tiles of a plan of width KP in `mode`: out = {stages, shared-memory bytes,
// blocks, tiles per block, blocks per SM}.
extern "C" int bst_patch_spmv1_geometry(long long ntiles, int KP, int mode,
                                        long long* out) {
  if (ntiles <= 0 || KP <= 0 || KP % kCols || mode < kF || mode > kA)
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  const cudaError_t e = bst_ring::current_sms(&sms);
  if (e != cudaSuccess) return (int)e;
  Geometry g;
  if (!geometry(ntiles, stretches_per_warp(KP), mode, 0, sms, &g))
    return (int)cudaErrorInvalidValue;
  out[0] = g.stages, out[1] = g.smem, out[2] = g.blocks, out[3] = g.span;
  out[4] = g.per_sm;
  return 0;
}

// y ([n_out] f32) must be zeroed; mk may be null for modes f and t; vals
// 16-byte aligned; tiles: the live row-tile table [ntiles, 2] int32.
// mode: 0 f, 1 t, 2 m, 3 a (see above).  tpb: tiles per block, 0 = the
// geometry's choice.
extern "C" int bst_patch_spmv1_f32(const float* vals, const int* cc,
                                   const int* rs, const int* mk,
                                   const int* tiles, long long ntiles,
                                   const float* x, float* y, int nb, int MP,
                                   int KP, long long n_in, long long n_out,
                                   int mode, long long tpb, void* stream) {
  if (MP <= 0 || MP % kRows != 0 || KP <= 0 || KP % kCols != 0 ||
      mode < kF || mode > kA || tpb < 0 ||
      ((mode == kM || mode == kA) && mk == nullptr) ||
      !bst_tma::aligned16(vals) || (long long)nb * MP >= (1LL << 31) ||
      n_in >= (1LL << 31) - 64 || n_out >= (1LL << 31) - 64)
    return (int)cudaErrorInvalidValue;
  if (nb <= 0 || ntiles <= 0 || n_out <= 0) return 0;
  int sms = 0;
  const cudaError_t e = bst_ring::current_sms(&sms);
  if (e != cudaSuccess) return (int)e;
  const int ntw = stretches_per_warp(KP);
  Geometry g;
  if (!geometry(ntiles, ntw, mode, tpb, sms, &g))
    return (int)cudaErrorInvalidValue;
  const Args a{vals, cc, rs, mk, tiles, x, y, ntiles, g.span, MP, KP,
               KP / kCC, MP / kRows, ntw, (int)n_in, (int)n_out, g.stages};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kF: return launch_mode<kF>(a, g, s);
    case kT: return launch_mode<kT>(a, g, s);
    case kM: return launch_mode<kM>(a, g, s);
    default: return launch_mode<kA>(a, g, s);
  }
}
