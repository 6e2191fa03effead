// The bulk-copy ring of the panel SpMV kernels: B5 (panel_spmv.cu, the v1
// plan of core/panel.py) and B10 (panel2_spmv.cu, the v2 plan of
// core/panel2.py), plus the copy and atomic primitives that B7
// (patch_spmv1.cu) shares with them.
//
// Both plans stream vals [S*TS, 8, 128] f32 with rid8 / cid8 [S*TS] (row
// chunk - b8[s], RW = padding; compact chunk, CW = padding), a segment table
// segid [S, CW*NSEG] and, for mirror plans, a target table tgt [S, CW*NSEG]:
//
//   plain   y[(b8[s] + rid8)*8 + m] += sum_k V[m, k] * x[lane k]
//   mirror  additionally y[target of lane k] += sum_m V[m, k] *
//           x[(b8[s] + rid8)*8 + m]
//
// Lane k of compact chunk c in slab s lies in segment k / SEG of the chunk
// (NSEG = 128 / SEG segments) and reads x at xbase(segid[s, c*NSEG + k/SEG])
// + k % SEG; its mirrored sum goes to ybase(tgt[...]) + k % SEG.  The two
// plans differ only in those two functions and in SEG, the geometry class
// the ring is templated on (as tile_stream.cuh is on its Geo):
//
//   V1Geo      SEG = 32; a segment id names a row of one of the shifted x32
//              grids: (id % NC32)*32 + the grid's shift; ids outside
//              [0, ngrids*NC32) (the sentinel, -1) are dropped
//   V2Geo<SEG> SEG in {8, 16, 32}; a segment id g names x[g*SEG ..]; g >= NC
//              (x) or >= n_yseg (y), the sentinels, are dropped
//
// A lane owns columns 4l .. 4l+3, which never straddle a segment (SEG >= 8),
// and 4 | SEG and 4 | every shift, so its x values are one float4.  x indices
// >= ncols read 0 and rows >= nrows are dropped, so no padded buffers are
// needed.
//
// What bounds it on the card: every value is read once for 2 flops (4 in a
// mirror plan), so it is bound by the bytes of vals; x, y and the id tables
// are small and stay in L2.  The design keeps HBM busy without making a value
// load wait on a table load:
//
//   * Persistent blocks over contiguous ranges of the [S*TS] tile stream:
//     one range per resident block, up to three blocks per SM where their
//     rings fit beside their tables, else one (the host geometry decides from
//     the card's SM count and the shared-memory sum).  A slab's padding tiles
//     (rid8 == RW) trail its live ones, so the live part of a range is a few
//     contiguous byte spans.
//   * One producer warp reads the range's rid8 / cid8 ahead, a window of
//     kWinTiles tiles at a time with coalesced loads, and cuts the live spans
//     into stages of up to eight whole tiles that never cross a slab.  Each
//     stage is one 1-D bulk copy (cp.async.bulk, completing on an mbarrier)
//     into a ring of shared-memory stages.  Padding tiles are not copied
//     (save in a block's first copy, which leaves before the ids arrive).
//   * The producer also writes each stage's tables into its ring slot before
//     it arrives: the tiles' ids, x's base of each of their NSEG segments
//     and, for mirror plans, y's.  Their loads are issued one stage ahead
//     (NSEG / 4 per lane), and each stage's copy is issued before the
//     previous stage's tables are written, so neither waits on a table load;
//     the first copy leaves before the first window of ids arrives.
//   * Eight consumer warps take one tile each per stage from the ring.  Lane
//     l owns columns 4l .. 4l+3 of a tile: one float4 of each of its 8 rows
//     from shared memory, four x values (the segment's base from the slot,
//     one float4 from L2), eight row sums in registers carried across the
//     warp's tiles of one row chunk and added into y when the row chunk
//     changes.  A mirror tile adds V^T x[its 8 rows] (lane l reads row l % 8,
//     the warp shares them) into a per-slab accumulator [CW, 128] in shared
//     memory (the plain version's scatter_add over cid8).
//
// Race-freedom: every add into y is an fp32 atomic into the zeroed output: a
// warp's row sums once per row-chunk change, and a slab's mirror sums once
// per visit of a block, when the block leaves the slab or ends its range (one
// float4 atomicAdd per nonzero group of four lanes with a target; scalar ones
// where a group runs past nrows or y is not 16-byte aligned).  Inside a
// block, the mirror sums meet in shared memory with shared-memory atomics
// (several warps may hold tiles of one compact chunk), and the consumer
// threads meet at an mbarrier before and after each flush of the
// accumulator.  The summation order varies from run to run.  The launch's
// tiles per block moves sums between the two: 1 flushes every tile on its
// own, ntiles meets every mirror sum in one block's shared memory and carries
// row sums across all its stages.
//
// Where a mirror plan's accumulator leaves room for fewer than kMinStages
// stages, the geometry takes the direct mode instead: each mirror tile adds
// its 128 column sums into y with fp32 atomics.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "tile_stream.cuh"
#include "tma_wgmma.cuh"

namespace bst_ring {

using bst_tma::mbar_arrive;
using bst_tma::mbar_init;
using bst_tma::mbar_wait;
using bst_tma::smem_u32;

constexpr int kConsumers = 8;                    // consumer warps
constexpr int kThreads = 32 * (kConsumers + 1);  // and one producer warp
constexpr int kStageTiles = kConsumers;          // one tile per consumer
constexpr int kTileBytes = bst::kTileElems * 4;  // 4 KB
constexpr int kStageBytes = kStageTiles * kTileBytes;
constexpr int kSmStages = 6;    // ring stages per SM, over its blocks
constexpr int kMaxPerSm = 3;    // blocks per SM (2 stages each)
constexpr int kMinStages = 3;   // fewer with a mirror accumulator: direct
constexpr int kWinTiles = 512;  // ids read ahead per window
constexpr int kSmemCap = 227 * 1024;  // a block's dynamic shared memory
constexpr int kSmSmem = 228 * 1024;   // an SM's shared memory
constexpr int kBlockReserve = 1024;   // reserved by the card per block

enum Mode { kPlain = 0, kMirror = 1, kMirrorDirect = 2 };

// -- primitives, shared with B7 ----------------------------------------------

// Adds `bytes` to the transactions bar's current phase waits for, without
// arriving.
__device__ __forceinline__ void expect_bytes(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// A 1-D bulk copy of `bytes` from global src to shared dst, completing on
// bar; the values are read once, so L2 keeps them as evict-first.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar)),
      "l"(policy)
      : "memory");
}

// y[idx .. idx+3] += v, entries >= limit dropped; idx % 4 == 0 and `al`
// (y 16-byte aligned) make it one vector atomic
__device__ __forceinline__ void add4(float* y, int idx, int limit, float4 v,
                                     bool al) {
  if (al && idx + 3 < limit) {
    atomicAdd(reinterpret_cast<float4*>(y + idx), v);
    return;
  }
  if (idx < limit) atomicAdd(y + idx, v.x);
  if (idx + 1 < limit) atomicAdd(y + idx + 1, v.y);
  if (idx + 2 < limit) atomicAdd(y + idx + 2, v.z);
  if (idx + 3 < limit) atomicAdd(y + idx + 3, v.w);
}

inline cudaError_t current_sms(int* sms) {
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  return e != cudaSuccess
             ? e
             : cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

// -- the panel ring ------------------------------------------------------------

struct Args {
  const float* vals;
  const int *rid8, *cid8, *segid, *tgt, *b8;
  const float* x;
  float* y;
  long long ntiles, span;  // tiles of the stream, of a block's range
  long long grids;         // V1Geo: 5 bits per used grid's shift
  int ncols, nrows, TS, CW, RW;
  int NC32, ngrids;        // V1Geo: the shifted x32 grids
  int NC, n_yseg;          // V2Geo: the x and y segment sentinels
  int stages;
};

struct V1Geo {
  static constexpr int kSeg = 32;
  __device__ __forceinline__ static int base(const Args& a, int seg) {
    if (seg < 0 || seg >= a.ngrids * a.NC32) return -1;
    const int gi = seg / a.NC32;
    return (seg % a.NC32) * 32 + (int)((a.grids >> (5 * gi)) & 31);
  }
  __device__ __forceinline__ static int xbase(const Args& a, int seg) {
    return base(a, seg);
  }
  __device__ __forceinline__ static int ybase(const Args& a, int seg) {
    return base(a, seg);
  }
};

template <int SEG>
struct V2Geo {
  static constexpr int kSeg = SEG;
  __device__ __forceinline__ static int xbase(const Args& a, int g) {
    return g >= 0 && g < a.NC ? g * SEG : -1;
  }
  __device__ __forceinline__ static int ybase(const Args& a, int t) {
    return t >= 0 && t < a.n_yseg ? t * SEG : -1;
  }
};

// A ring stage's tables, written by the producer warp before it arrives:
// for tile t of the stage its row chunk and compact chunk, x's base of each
// of its NSEG segments (-1: read 0) and, for mirror plans, y's (-1:
// dropped).
template <int NSEG>
struct Slot {
  int s, n, b8, pad;  // slab, live tiles (-1: the range is done), b8[s]
  int rid[kStageTiles], cid[kStageTiles];
  int xb[kStageTiles * NSEG], yb[kStageTiles * NSEG];
};

// A stage the producer has found, and its tables' loads in flight: lane l
// holds tile l's ids (l < nl) and the raw segid / tgt entries l + 32 i
// (segment e % NSEG of tile e / NSEG).
template <int NSEG>
struct Stage {
  long long T;
  int s, nl;
  int rid, cid, b8;
  int seg[NSEG / 4], tgt[NSEG / 4];
};

// Bytes of dynamic shared memory of a launch: the ring with its slots and
// full / empty barriers, the consumers' barrier, the id window and (mode
// kMirror) the mirror accumulator.
template <int NSEG>
long long smem_bytes(int stages, int CW, int mode) {
  return (long long)stages * (kStageBytes + sizeof(Slot<NSEG>) + 16) + 16 +
         2LL * kWinTiles * 4 +
         (mode == kMirror ? (long long)CW * bst::kTileCols * 4 : 0);
}

template <class G, int MODE>
__global__ void __launch_bounds__(kThreads, kMaxPerSm)
    panel_ring_kernel(const Args a) {
  constexpr int SEG = G::kSeg, NSEG = bst::kTileCols / SEG;
  constexpr int kConsumerThreads = 32 * kConsumers;
  using SlotT = Slot<NSEG>;
  using StageT = Stage<NSEG>;
  extern __shared__ __align__(128) unsigned char smem[];
  const float* vals = a.vals;
  const float* x = a.x;
  float* y = a.y;
  const long long T0 = (long long)blockIdx.x * a.span;
  const long long T1 = min(T0 + a.span, a.ntiles);
  if (T0 >= T1) return;
  const int NST = a.stages, CW = a.CW, RW = a.RW;
  unsigned char* ring = smem;
  SlotT* slots = reinterpret_cast<SlotT*>(ring + NST * kStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(slots + NST);
  uint64_t* empty = full + NST;
  uint64_t* cbar = empty + NST;  // the consumer threads' barrier
  int* win_rid = reinterpret_cast<int*>(cbar + 2);
  int* win_cid = win_rid + kWinTiles;
  float* macc = reinterpret_cast<float*>(win_cid + kWinTiles);  // [CW*128]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if constexpr (MODE == kMirror)
    for (int i = tid; i < CW * bst::kTileCols; i += kThreads) macc[i] = 0.f;
  if (tid == 0) {
    for (int i = 0; i < NST; ++i) {
      mbar_init(&full[i], 32);          // every producer lane arrives
      mbar_init(&empty[i], kConsumers);  // one arrival per consumer warp
    }
    mbar_init(cbar, kConsumerThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers) {  // the producer warp
    long long W0 = T0, T = T0;
    bool fresh = true;
    // The next stage from T on, its table loads issued (not waited for);
    // false at the end of the range.
    auto find = [&](StageT& st) -> bool {
      while (T < T1) {
        if (fresh || T >= W0 + kWinTiles) {  // read the next window of ids
          __syncwarp();
          W0 = T;
          const int len = (int)min((long long)kWinTiles, T1 - W0);
          for (int k = lane; k < len; k += 32) {
            win_rid[k] = __ldg(a.rid8 + W0 + k);
            win_cid[k] = __ldg(a.cid8 + W0 + k);
          }
          __syncwarp();
          fresh = false;
        }
        const int s = (int)(T / a.TS);
        const long long end =
            min(min((long long)(s + 1) * a.TS, T1), W0 + kWinTiles);
        const int n = (int)min((long long)kStageTiles, end - T);
        const int r = lane < n ? win_rid[T - W0 + lane] : RW;
        // a slab's live tiles come first: the stage's live ones are a
        // prefix
        const int nl = __popc(__ballot_sync(0xffffffffu, r < RW));
        if (nl == 0) {  // the rest of the slab is padding
          T = (long long)(s + 1) * a.TS;
          continue;
        }
        st.T = T, st.s = s, st.nl = nl;
        st.rid = r;
        st.cid = lane < nl ? win_cid[T - W0 + lane] : 0;
#pragma unroll
        for (int i = 0; i < NSEG / 4; ++i) {
          const int e = lane + 32 * i;
          const int tq = e / NSEG;  // segment e % NSEG of tile tq
          const int c = __shfl_sync(0xffffffffu, st.cid, tq);
          const long long at = ((long long)s * CW + c) * NSEG + e % NSEG;
          st.seg[i] = tq < nl ? __ldg(a.segid + at) : -1;
          st.tgt[i] = MODE != kPlain && tq < nl ? __ldg(a.tgt + at) : -1;
        }
        st.b8 = __ldg(a.b8 + s);
        T = nl < n ? (long long)(s + 1) * a.TS : T + n;
        return true;
      }
      return false;
    };
    // Stage j's copy of `tiles` tiles from T: once its slot is free, lane 0
    // arms the full barrier with the copy's bytes and issues it.
    auto copy = [&](int j, long long from, int tiles) {
      mbar_wait(&empty[j % NST], ((j / NST) & 1) ^ 1);
      if (lane == 0) {
        expect_bytes(&full[j % NST], tiles * kTileBytes);
        bulk_load(ring + (j % NST) * kStageBytes,
                  vals + from * bst::kTileElems, tiles * kTileBytes,
                  &full[j % NST]);
      }
    };
    // Stage j's tables into its slot (their loads done by now), then every
    // lane arrives.
    auto post = [&](int j, const StageT& st) {
      SlotT& sl = slots[j % NST];
      if (lane < st.nl) {
        sl.rid[lane] = st.rid;
        sl.cid[lane] = st.cid;
      }
#pragma unroll
      for (int i = 0; i < NSEG / 4; ++i) {
        sl.xb[lane + 32 * i] = G::xbase(a, st.seg[i]);
        if constexpr (MODE != kPlain)
          sl.yb[lane + 32 * i] = G::ybase(a, st.tgt[i]);
      }
      if (lane == 0) {
        sl.s = st.s;
        sl.n = st.nl;
        sl.b8 = st.b8;
      }
      mbar_arrive(&full[j % NST]);
    };
    StageT none;  // an empty stage: no live tile
    none.T = T0, none.s = -1, none.nl = 0, none.rid = none.cid = none.b8 = 0;
#pragma unroll
    for (int i = 0; i < NSEG / 4; ++i) none.seg[i] = none.tgt[i] = -1;
    // The copies run one stage ahead of the tables: stage i + 1's copy is
    // issued before stage i's tables wait for their loads.  The first copy
    // goes out before the first window of ids arrives: the range's first
    // up to eight tiles of its slab, live or not; where the first live
    // stage starts elsewhere, that stage 0 is posted empty.
    const long long first =
        min((long long)kStageTiles,
            min((T0 / a.TS + 1) * a.TS, T1) - T0);
    copy(0, T0, (int)first);
    int i = 0;  // stages posted
    StageT cur, next;
    bool have = find(cur);
    if (have && cur.T != T0) {
      post(0, none);
      i = 1;
      copy(1, cur.T, cur.nl);
    }
    while (have) {
      const bool more = find(next);
      if (more) copy(i + 1, next.T, next.nl);
      post(i, cur);
      ++i;
      cur = next;
      have = more;
    }
    if (!have && i == 0) post(i++, none);
    const int slot = i % NST;  // the end marker
    mbar_wait(&empty[slot], ((i / NST) & 1) ^ 1);
    if (lane == 0) slots[slot].n = -1;
    mbar_arrive(&full[slot]);
    return;
  }

  // consumer warps: tile `warp` of every stage; lane l's columns lie in
  // segment sidx of the tile, at offset soff
  const int sidx = (4 * lane) / SEG, soff = (4 * lane) % SEG;
  const bool xal = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const bool yal = (reinterpret_cast<uintptr_t>(y) & 15) == 0;
  float acc[bst::kTileRows];
#pragma unroll
  for (int m = 0; m < bst::kTileRows; ++m) acc[m] = 0.f;
  long long cur = -1;  // the row chunk whose sums the registers hold
  int slab = -1;
  uint32_t cphase = 0;

  auto flush_rows = [&]() {  // registers -> y
    const float tot = bst::warp_rows_total(acc, lane);
    const long long row = cur * bst::kTileRows + ((lane >> 2) & 7);
    if ((lane & 3) == 0 && row < a.nrows) atomicAdd(y + row, tot);
#pragma unroll
    for (int m = 0; m < bst::kTileRows; ++m) acc[m] = 0.f;
  };
  // kMirror: the consumer threads meet at an mbarrier (every thread
  // arrives, release; and waits, acquire) around each flush of the slab's
  // mirror accumulator into y through tgt, which zeroes it.
  auto consumers_sync = [&]() {
    mbar_arrive(cbar);
    mbar_wait(cbar, cphase);
    cphase ^= 1;
  };
  auto flush_mirror = [&]() {
    consumers_sync();  // every mirror sum of the slab is in
    // entry c*128 + j*32 + l holds lane position 4l + j of chunk c
    for (int q = tid; q < CW * 32; q += kConsumerThreads) {
      float* e = macc + (q >> 5) * bst::kTileCols + (q & 31);
      const float4 v = make_float4(e[0], e[32], e[64], e[96]);
      if (v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f) {
        e[0] = e[32] = e[64] = e[96] = 0.f;
        const int l = q & 31;
        const int tb = G::ybase(
            a, __ldg(a.tgt + ((long long)slab * CW + (q >> 5)) * NSEG +
                     (4 * l) / SEG));
        if (tb >= 0) add4(y, tb + (4 * l) % SEG, a.nrows, v, yal);
      }
    }
    consumers_sync();  // the accumulator is zero again
  };

  for (int i = 0;; ++i) {
    const int slot = i % NST;
    mbar_wait(&full[slot], (i / NST) & 1);
    const SlotT& sl = slots[slot];
    const int n = sl.n;
    if (n < 0) break;
    if constexpr (MODE == kMirror)
      if (sl.s != slab) {
        if (slab >= 0) flush_mirror();
        slab = sl.s;
      }
    if (warp < n) {
      const int rid = sl.rid[warp], cid = sl.cid[warp];
      const long long rc = (long long)sl.b8 + rid;
      if (rc != cur) {
        if (cur >= 0) flush_rows();
        cur = rc;
      }
      const float4* V = reinterpret_cast<const float4*>(
                            ring + slot * kStageBytes + warp * kTileBytes) +
                        lane;
      float4 v[bst::kTileRows];
#pragma unroll
      for (int m = 0; m < bst::kTileRows; ++m)
        v[m] = V[m * (bst::kTileCols / 4)];
      float xv[4] = {0.f, 0.f, 0.f, 0.f};
      const int base = sl.xb[warp * NSEG + sidx];
      if (base >= 0) {
        const int idx = base + soff;
        if (xal && idx + 3 < a.ncols) {
          const float4 t = __ldg(reinterpret_cast<const float4*>(x + idx));
          xv[0] = t.x, xv[1] = t.y, xv[2] = t.z, xv[3] = t.w;
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            xv[j] = idx + j < a.ncols ? __ldg(x + idx + j) : 0.f;
        }
      }
#pragma unroll
      for (int m = 0; m < bst::kTileRows; ++m) {
        float t = acc[m];
        t = fmaf(v[m].x, xv[0], t);
        t = fmaf(v[m].y, xv[1], t);
        t = fmaf(v[m].z, xv[2], t);
        t = fmaf(v[m].w, xv[3], t);
        acc[m] = t;
      }
      if constexpr (MODE != kPlain) {
        // x at the tile's 8 rows: lane l loads row l % 8, the warp shares
        const long long xrow = rc * bst::kTileRows + (lane & 7);
        const float xl = xrow < a.ncols ? __ldg(x + xrow) : 0.f;
        float yt[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int m = 0; m < bst::kTileRows; ++m) {
          const float xm = __shfl_sync(0xffffffffu, xl, m);
          yt[0] = fmaf(v[m].x, xm, yt[0]);
          yt[1] = fmaf(v[m].y, xm, yt[1]);
          yt[2] = fmaf(v[m].z, xm, yt[2]);
          yt[3] = fmaf(v[m].w, xm, yt[3]);
        }
        if constexpr (MODE == kMirror) {
          float* mc = macc + cid * bst::kTileCols + lane;
#pragma unroll
          for (int j = 0; j < 4; ++j) atomicAdd(mc + 32 * j, yt[j]);
        } else {
          const int tb = sl.yb[warp * NSEG + sidx];
          if (tb >= 0)
            add4(y, tb + soff, a.nrows,
                 make_float4(yt[0], yt[1], yt[2], yt[3]), yal);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);
  }
  if (cur >= 0) flush_rows();
  if constexpr (MODE == kMirror) flush_mirror();
}

// The launch geometry: ring stages, mode, shared memory, blocks and the
// tiles of a block's range.  The most blocks per SM (at most kMaxPerSm)
// whose rings of kSmStages / blocks stages fit in an SM's shared memory
// beside their tables: measured on B5, three blocks of two stages beat two
// of three and one of six on the plain plans.  Else one block with as many
// stages as fit, and where a mirror accumulator leaves fewer than
// kMinStages, the direct mode.  tpb > 0 sets the range; 0 cuts the stream
// into one range per resident block.
struct Geometry {
  int stages, mode, per_sm;
  long long smem, blocks, span;
};

template <int NSEG>
void fit(int CW, int mode, Geometry* g) {
  g->mode = mode;
  for (int k = kMaxPerSm; k > 1; --k)
    if (k * (smem_bytes<NSEG>(kSmStages / k, CW, mode) + kBlockReserve) <=
        kSmSmem) {
      g->per_sm = k, g->stages = kSmStages / k;
      return;
    }
  const long long per = kStageBytes + sizeof(Slot<NSEG>) + 16;
  g->per_sm = 1;
  g->stages = (int)std::min((long long)kSmStages,
                            (kSmemCap - smem_bytes<NSEG>(0, CW, mode)) / per);
}

template <int NSEG>
bool geometry(long long ntiles, int CW, int mirror, long long tpb, int sms,
              Geometry* g) {
  fit<NSEG>(CW, mirror ? kMirror : kPlain, g);
  if (mirror && g->per_sm == 1 && g->stages < kMinStages)
    fit<NSEG>(CW, kMirrorDirect, g);
  if (g->stages < 1) return false;
  g->smem = smem_bytes<NSEG>(g->stages, CW, g->mode);
  const long long ranges = (long long)sms * g->per_sm;
  g->span = tpb > 0 ? tpb : (ntiles + ranges - 1) / ranges;
  g->blocks = (ntiles + g->span - 1) / g->span;
  return g->blocks < (1LL << 31);
}

// The geometry on the current card into out = {stages, mode, shared-memory
// bytes, blocks, tiles per block, blocks per SM}.
template <int NSEG>
int query(long long ntiles, int CW, int mirror, long long* out) {
  if (ntiles <= 0 || CW <= 0) return (int)cudaErrorInvalidValue;
  int sms = 0;
  const cudaError_t e = current_sms(&sms);
  if (e != cudaSuccess) return (int)e;
  Geometry g;
  if (!geometry<NSEG>(ntiles, CW, mirror, 0, sms, &g))
    return (int)cudaErrorInvalidValue;
  out[0] = g.stages, out[1] = g.mode, out[2] = g.smem, out[3] = g.blocks;
  out[4] = g.span, out[5] = g.per_sm;
  return 0;
}

template <class G, int MODE>
int launch_mode(const Args& a, const Geometry& g, cudaStream_t s) {
  // set at every launch: the attribute is per device and cheap to set
  const cudaError_t e = cudaFuncSetAttribute(
      panel_ring_kernel<G, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)g.smem);
  if (e != cudaSuccess) return (int)e;
  panel_ring_kernel<G, MODE><<<(unsigned)g.blocks, kThreads, g.smem, s>>>(a);
  return (int)cudaGetLastError();
}

// One launch over the stream: `a` holds everything but span and stages,
// which the geometry sets; y must be zeroed.
template <class G>
int launch(Args a, int mirror, long long tpb, cudaStream_t s) {
  constexpr int NSEG = bst::kTileCols / G::kSeg;
  if (a.ntiles <= 0 || a.nrows <= 0) return 0;
  int sms = 0;
  const cudaError_t e = current_sms(&sms);
  if (e != cudaSuccess) return (int)e;
  Geometry g;
  if (!geometry<NSEG>(a.ntiles, a.CW, mirror, tpb, sms, &g))
    return (int)cudaErrorInvalidValue;
  a.span = g.span, a.stages = g.stages;
  switch (g.mode) {
    case kMirror: return launch_mode<G, kMirror>(a, g, s);
    case kMirrorDirect: return launch_mode<G, kMirrorDirect>(a, g, s);
    default: return launch_mode<G, kPlain>(a, g, s);
  }
}

}  // namespace bst_ring
