// Panel SpMV on Hopper (kernels B5 and B6 of the port).
//
// Replaces blocksparse_tpu/ops/pallas/panel_spmv.py::_pkern_plain and
// ::_pkern_mirror (launched from _launch) together with the x gather and the
// mirror map-back around them.  The operand is the panel plan of
// core/panel.py: vals [S*TS, 8, 128] in the K-merged panel space,
// rid8 / cid8 [S*TS] (row chunk - b8[s], RW = padding; compact chunk, CW =
// padding), segid [S, CW*4] and, for mirror plans, otgt [S, CW*4].
//
//   plain   y[(b8[s] + rid8)*8 + m] += sum_k V[m, k] * x[lane k]
//   mirror  additionally y[lane k] += sum_m V[m, k] * x[(b8[s] + rid8)*8 + m]
//           for lanes whose segment has a mirror target
//
// where lane k of compact chunk c in slab s reads segment
// seg = segid[s, c*4 + k/32]: x[(seg % NC32)*32 + k%32 + g(seg / NC32)]
// with g the segment grid's shift, 0 for the sentinel seg == NG*NC32 and
// for indices >= ncols (the JAX gather rolls x and wraps the last segment
// to its front; the plan holds zero values on those lanes, so reading 0
// there is the same product and never reads out of bounds).  Mirror sums
// go to the same formula with otgt in place of segid (-1 = dropped: the
// diagonal blocks' and the padding's segments), rows >= nrows dropped --
// the JAX wrapper's one-hot map-back [S*CW*4, NG*NC32] and its per-grid
// pad-left, with no one-hot on the device.
//
// What bounds it on the card: every value is read once for 2 flops (4 in a
// mirror plan), so it is bound by the bytes of vals; x, y and the id
// tables are small and stay in L2.  The design keeps HBM busy without
// making a value load wait on a table load:
//
//   * Persistent blocks over contiguous ranges of the [S*TS] tile stream:
//     one range per resident block, up to three blocks per SM where their
//     rings fit beside their tables, else one (the C entry decides from the
//     card's SM count and its own shared-memory sum).  A slab's padding tiles (rid8
//     == RW) trail its live ones, so the live part of a range is a few
//     contiguous byte spans.
//   * One producer warp reads the range's rid8 / cid8 ahead, a window of
//     kWinTiles tiles at a time with coalesced loads, and cuts the live
//     spans into stages of up to eight whole tiles that never cross a slab.
//     Each stage is one 1-D bulk copy (cp.async.bulk, completing on an
//     mbarrier) into a ring of shared-memory stages.  Padding tiles are
//     not copied (save in a block's first copy, which leaves before the
//     ids arrive).
//   * The producer also writes each stage's tables into its ring slot
//     before it arrives: the tiles' ids, x's index of each of their four
//     32-lane segments (from segid) and, for mirror plans, y's (from
//     otgt).  Their loads are issued one stage ahead, and each stage's copy
//     is issued before the previous stage's tables are written, so neither
//     waits on a table load; the first copy leaves before the first window
//     of ids arrives.
//   * Eight consumer warps take one tile each per stage from the ring.
//     Lane l owns columns 4l .. 4l+3 of a tile: one float4 of each of its 8
//     rows from shared memory, four x values (the segment's index from the
//     slot, one float4 from L2), eight row sums in registers carried across
//     the warp's tiles of one row chunk and added into y when the row chunk
//     changes.  A mirror tile adds V^T x[its 8 rows] (lane l reads row l %
//     8, the warp shares them) into a per-slab accumulator [CW, 128] in
//     shared memory (the plain version's scatter_add over cid8).
//
// Race-freedom: every add into y is an fp32 atomic into the zeroed output:
// a warp's row sums once per row-chunk change, and a slab's mirror sums
// once per visit of a block, when the block leaves the slab or ends its
// range (one float4 atomicAdd per nonzero group of four lanes of a compact
// chunk with a target; scalar ones where a group runs past nrows or y is
// not 16-byte aligned).  Inside a block, the mirror sums meet in shared
// memory with shared-memory atomics (several warps may hold tiles of one
// compact chunk), and the consumer threads meet at an mbarrier before and
// after each flush of the accumulator.  The summation order varies from
// run to run.  The launch's tiles_per_block moves sums between the two: 1
// flushes every tile on its own, ntiles meets every mirror sum in one
// block's shared memory and carries row sums across all its stages.
//
// Where a mirror plan's accumulator leaves room for fewer than kMinStages
// stages, the C entry takes the direct mode instead: each mirror tile adds
// its 128 column sums into y with fp32 atomics (the shape decides it;
// bst_panel_spmv_geometry reports it).
//
// Kernel B6, bst_panel_spmv_batched_f32, is the same product for P
// operators that share one panel plan's id tables and differ in their values
// (vals [P, S*TS, 8, 128], x [P, ncols], y [P, nrows]).  It replaces
// blocksparse_tpu/ops/pallas/panel_spmv.py::_pkern_plain_b and
// ::_pkern_mirror_b together with _launch_batched's x gather and mirror
// map-back.  It runs the tile core of tile_stream.cuh (one warp per run of
// `tpw` tiles, float4 streaming loads, every sum an fp32 atomicAdd into
// the zeroed y): blockIdx.y = p offsets the values, x and y of product p,
// products never sharing an entry of y.  On the real-size batches the
// ring above was slower (a product's stream is cut into a few blocks,
// each paying the ring's start-up).
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "tile_stream.cuh"
#include "tma_wgmma.cuh"

namespace {

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
constexpr int kWinTiles = 512;  // rid8 / cid8 read ahead per window
constexpr int kSmemCap = 227 * 1024;      // a block's dynamic shared memory
constexpr int kSmSmem = 228 * 1024;       // an SM's shared memory
constexpr int kBlockReserve = 1024;       // reserved by the card per block

enum Mode { kPlain = 0, kMirror = 1, kMirrorDirect = 2 };

// A ring stage's tables, written by the producer warp before it arrives:
// for tile t of the stage its row chunk and compact chunk, x's index of
// lane 0 of each of its four segments (-1: read 0) and, for mirror plans,
// y's (-1: dropped).
struct Slot {
  int s, n, b8, pad;  // slab, live tiles (-1: the range is done), b8[s]
  int rid[kStageTiles], cid[kStageTiles];
  int xb[kStageTiles * 4], yb[kStageTiles * 4];
};

// A stage the producer has found, and its tables' loads in flight: lane l
// holds tile l's ids (l < nl) and the raw segid / otgt entry of segment
// l % 4 of tile l / 4.
struct Stage {
  long long T;
  int s, nl;
  int rid, cid, seg, tgt, b8;
};

struct Args {
  const float* vals;
  const int *rid8, *cid8, *segid, *otgt, *b8;
  const float* x;
  float* y;
  long long ntiles, span;  // tiles of the stream, of a block's range
  long long grids;         // 5 bits per used grid's shift
  int ncols, nrows, TS, CW, RW, NC32, ngrids, stages;
};

// Bytes of dynamic shared memory of a launch: the ring with its slots and
// full / empty barriers, the consumers' barrier, the id window and (mode
// kMirror) the mirror accumulator.
long long smem_bytes(int stages, int CW, int mode) {
  return (long long)stages * (kStageBytes + sizeof(Slot) + 16) + 16 +
         2LL * kWinTiles * 4 +
         (mode == kMirror ? (long long)CW * bst::kTileCols * 4 : 0);
}

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

// x (or y) index of lane 0 of a segment, -1 for the sentinel / dropped
__device__ __forceinline__ int seg_base(const Args& a, int seg) {
  if (seg < 0 || seg >= a.ngrids * a.NC32) return -1;
  const int gi = seg / a.NC32;
  return (seg % a.NC32) * 32 + (int)((a.grids >> (5 * gi)) & 31);
}

template <int MODE>
__global__ void __launch_bounds__(kThreads, kMaxPerSm)
    panel_ring_kernel(const Args a) {
  constexpr int kConsumerThreads = 32 * kConsumers;
  extern __shared__ __align__(128) unsigned char smem[];
  const float* vals = a.vals;
  const float* x = a.x;
  float* y = a.y;
  const long long T0 = (long long)blockIdx.x * a.span;
  const long long T1 = min(T0 + a.span, a.ntiles);
  if (T0 >= T1) return;
  const int NST = a.stages, CW = a.CW, RW = a.RW;
  unsigned char* ring = smem;
  Slot* slots = reinterpret_cast<Slot*>(ring + NST * kStageBytes);
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
    auto find = [&](Stage& st) -> bool {
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
        const int tq = lane >> 2;  // segment lane % 4 of tile tq
        const int c = __shfl_sync(0xffffffffu, st.cid, tq);
        const long long e = ((long long)s * CW + c) * 4 + (lane & 3);
        st.seg = tq < nl ? __ldg(a.segid + e) : -1;
        st.tgt = MODE != kPlain && tq < nl ? __ldg(a.otgt + e) : -1;
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
    auto post = [&](int j, const Stage& st) {
      Slot& sl = slots[j % NST];
      if (lane < st.nl) {
        sl.rid[lane] = st.rid;
        sl.cid[lane] = st.cid;
      }
      sl.xb[lane] = seg_base(a, st.seg);
      if constexpr (MODE != kPlain) sl.yb[lane] = seg_base(a, st.tgt);
      if (lane == 0) {
        sl.s = st.s;
        sl.n = st.nl;
        sl.b8 = st.b8;
      }
      mbar_arrive(&full[j % NST]);
    };
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
    Stage cur, next;
    bool have = find(cur);
    if (have && cur.T != T0) {
      post(0, Stage{T0, -1, 0, 0, 0, -1, -1, 0});
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
    if (!have && i == 0) post(i++, Stage{T0, -1, 0, 0, 0, -1, -1, 0});
    const int slot = i % NST;  // the end marker
    mbar_wait(&empty[slot], ((i / NST) & 1) ^ 1);
    if (lane == 0) slots[slot].n = -1;
    mbar_arrive(&full[slot]);
    return;
  }

  // consumer warps: tile `warp` of every stage
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
  // mirror accumulator into y through otgt, which zeroes it.
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
        const int tb = seg_base(
            a, __ldg(a.otgt + ((long long)slab * CW + (q >> 5)) * 4 +
                     ((q & 31) >> 3)));
        if (tb >= 0) add4(y, tb + 4 * (q & 7), a.nrows, v, yal);
      }
    }
    consumers_sync();  // the accumulator is zero again
  };

  for (int i = 0;; ++i) {
    const int slot = i % NST;
    mbar_wait(&full[slot], (i / NST) & 1);
    const Slot& sl = slots[slot];
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
      const int base = sl.xb[warp * 4 + (lane >> 3)];
      if (base >= 0) {
        const int idx = base + 4 * (lane & 7);
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
          const int tb = sl.yb[warp * 4 + (lane >> 3)];
          if (tb >= 0)
            add4(y, tb + 4 * (lane & 7), a.nrows,
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
// beside their tables: measured, three blocks of two stages beat two of
// three and one of six on the plain plans.  Else one block with as many
// stages as fit, and where a mirror accumulator leaves fewer than
// kMinStages, the direct mode.  tpb > 0 sets the range; 0 cuts the stream
// into one range per resident block.
struct Geometry {
  int stages, mode, per_sm;
  long long smem, blocks, span;
};

void fit(int CW, int mode, Geometry* g) {
  g->mode = mode;
  for (int k = kMaxPerSm; k > 1; --k)
    if (k * (smem_bytes(kSmStages / k, CW, mode) + kBlockReserve) <= kSmSmem) {
      g->per_sm = k, g->stages = kSmStages / k;
      return;
    }
  const long long per = kStageBytes + sizeof(Slot) + 16;
  g->per_sm = 1;
  g->stages = (int)std::min((long long)kSmStages,
                            (kSmemCap - smem_bytes(0, CW, mode)) / per);
}

bool geometry(long long ntiles, int CW, int mirror, long long tpb, int sms,
              Geometry* g) {
  fit(CW, mirror ? kMirror : kPlain, g);
  if (mirror && g->per_sm == 1 && g->stages < kMinStages)
    fit(CW, kMirrorDirect, g);
  if (g->stages < 1) return false;
  g->smem = smem_bytes(g->stages, CW, g->mode);
  const long long ranges = (long long)sms * g->per_sm;
  g->span = tpb > 0 ? tpb : (ntiles + ranges - 1) / ranges;
  g->blocks = (ntiles + g->span - 1) / g->span;
  return g->blocks < (1LL << 31);
}

cudaError_t current_sms(int* sms) {
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  return e != cudaSuccess
             ? e
             : cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

template <int MODE>
int launch_mode(const Args& a, const Geometry& g, cudaStream_t s) {
  // set at every launch: the attribute is per device and cheap to set
  const cudaError_t e = cudaFuncSetAttribute(
      panel_ring_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)g.smem);
  if (e != cudaSuccess) return (int)e;
  panel_ring_kernel<MODE><<<(unsigned)g.blocks, kThreads, g.smem, s>>>(a);
  return (int)cudaGetLastError();
}

// -- kernel B6: the tile_stream.cuh core over P products ---------------------

struct PanelGeo {
  const int* rid8;
  const int* cid8;
  const int* segid;
  const int* otgt;
  const int* b8;
  long long grids;  // 5 bits per used grid's shift
  int CW, RW, NC32, ngrids;
  long long ncols, nrows;

  __device__ __forceinline__ long long row_chunk(int s, long long T) const {
    const int r = __ldg(rid8 + T);
    return r >= RW ? -1 : (long long)__ldg(b8 + s) + r;
  }
  __device__ __forceinline__ long long seg_base(int seg) const {
    const int gi = seg / NC32;
    return (long long)(seg % NC32) * 32 + ((grids >> (5 * gi)) & 31);
  }
  __device__ __forceinline__ void load_x(int s, long long T, int lane,
                                         const float* __restrict__ x,
                                         float (&xv)[4]) const {
    const int c = __ldg(cid8 + T);
    const int seg = __ldg(segid + ((long long)s * CW + c) * 4 + lane / 8);
    const long long base =
        seg < ngrids * NC32 ? seg_base(seg) + (4 * lane) % 32 : ncols;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      xv[j] = base + j < ncols ? __ldg(x + base + j) : 0.f;
  }
  __device__ __forceinline__ float mirror_weight(int, long long) const {
    return 1.f;
  }
  __device__ __forceinline__ void mirror_add(int s, long long T, int lane,
                                             const float (&yt)[4],
                                             float* __restrict__ y) const {
    const int c = __ldg(cid8 + T);
    const int tgt = __ldg(otgt + ((long long)s * CW + c) * 4 + lane / 8);
    if (tgt < 0) return;
    const long long base = seg_base(tgt) + (4 * lane) % 32;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (base + j < nrows) atomicAdd(y + base + j, yt[j]);
  }
};

template <bool MIRROR>
__global__ void __launch_bounds__(bst::kStreamThreads)
    panel_spmv_batched_kernel(const float* __restrict__ vals, PanelGeo geo,
                              const float* __restrict__ x,
                              float* __restrict__ y, long long ntiles, int TS,
                              int tpw) {
  const long long p = blockIdx.y;
  bst::stream_tiles<MIRROR>(vals + p * ntiles * bst::kTileElems, ntiles, TS,
                            geo, x + p * geo.ncols, y + p * geo.nrows,
                            geo.nrows, tpw);
}

}  // namespace

// The geometry B5 launches with on the current card, as out = {stages,
// mode (0 plain, 1 mirror in shared memory, 2 mirror direct),
// shared-memory bytes, blocks, tiles per block, blocks per SM}.
extern "C" int bst_panel_spmv_geometry(long long ntiles, int CW, int mirror,
                                       long long* out) {
  if (ntiles <= 0 || CW <= 0) return (int)cudaErrorInvalidValue;
  int sms = 0;
  const cudaError_t e = current_sms(&sms);
  if (e != cudaSuccess) return (int)e;
  Geometry g;
  if (!geometry(ntiles, CW, mirror, 0, sms, &g))
    return (int)cudaErrorInvalidValue;
  out[0] = g.stages, out[1] = g.mode, out[2] = g.smem, out[3] = g.blocks;
  out[4] = g.span, out[5] = g.per_sm;
  return 0;
}

// y must be zeroed ([nrows] f32); otgt may be null unless mirror; vals
// 16-byte aligned.  tpb: tiles per block, 0 = the geometry's choice.
extern "C" int bst_panel_spmv_f32(const float* vals, const int* rid8,
                                  const int* cid8, const int* segid,
                                  const int* otgt, const int* b8,
                                  const float* x, float* y, long long ntiles,
                                  int TS, int CW, int RW, int NC32,
                                  int ngrids, long long grids,
                                  long long ncols, long long nrows,
                                  int mirror, long long tpb, void* stream) {
  if (TS <= 0 || CW <= 0 || RW <= 0 || NC32 <= 0 || ngrids <= 0 ||
      ngrids > 8 || tpb < 0 || (mirror && otgt == nullptr) ||
      !bst_tma::aligned16(vals) || ncols >= (1LL << 31) - 64 ||
      nrows >= (1LL << 31) - 64 || (long long)NC32 * 32 + 32 >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (ntiles <= 0 || nrows <= 0) return 0;
  int sms = 0;
  const cudaError_t e = current_sms(&sms);
  if (e != cudaSuccess) return (int)e;
  Geometry g;
  if (!geometry(ntiles, CW, mirror, tpb, sms, &g))
    return (int)cudaErrorInvalidValue;
  const Args a{vals, rid8, cid8, segid, otgt, b8, x, y, ntiles, g.span,
               grids, (int)ncols, (int)nrows, TS, CW, RW, NC32, ngrids,
               g.stages};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (g.mode) {
    case kMirror: return launch_mode<kMirror>(a, g, s);
    case kMirrorDirect: return launch_mode<kMirrorDirect>(a, g, s);
    default: return launch_mode<kPlain>(a, g, s);
  }
}

// P products over one plan's tables; y must be zeroed ([P, nrows] f32).
extern "C" int bst_panel_spmv_batched_f32(
    const float* vals, const int* rid8, const int* cid8, const int* segid,
    const int* otgt, const int* b8, const float* x, float* y, int P,
    long long ntiles, int TS, int CW, int RW, int NC32, int ngrids,
    long long grids, long long ncols, long long nrows, int mirror, int tpw,
    void* stream) {
  if (TS <= 0 || CW <= 0 || RW <= 0 || NC32 <= 0 || ngrids <= 0 ||
      ngrids > 8 || tpw <= 0 || P > 65535 || (mirror && otgt == nullptr))
    return (int)cudaErrorInvalidValue;
  if (P <= 0 || ntiles <= 0 || nrows <= 0) return 0;
  const PanelGeo geo{rid8, cid8, segid, otgt, b8, grids, CW, RW, NC32,
                     ngrids, ncols, nrows};
  const long long warps = (ntiles + tpw - 1) / tpw;
  const int per_block = bst::kStreamThreads / 32;
  const dim3 grid((unsigned)((warps + per_block - 1) / per_block), P);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mirror)
    panel_spmv_batched_kernel<true><<<grid, bst::kStreamThreads, 0, s>>>(
        vals, geo, x, y, ntiles, TS, tpw);
  else
    panel_spmv_batched_kernel<false><<<grid, bst::kStreamThreads, 0, s>>>(
        vals, geo, x, y, ntiles, TS, tpw);
  return (int)cudaGetLastError();
}
