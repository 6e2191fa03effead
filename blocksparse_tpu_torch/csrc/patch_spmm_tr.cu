// Transposed merged-patch SpMM on Hopper (kernel B2's transpose): wgmma +
// TMA with A = V^T read into registers and the slot's window of X kept in
// shared memory.
//
// Replaces blocksparse_tpu/ops/patch_engine.py::_kern_tr (launched from
// _bucket_spmm_raw / patch_spmm with transpose=True; it is also the dX of
// every forward product), and the transposed mode of
// blocksparse_tpu/ops/batched.py::_kern_batched (batched_mm's dX): for every
// product p < P (grid z) and slot b of a patch bucket, with V[p, b] of shape
// [MP, KP] and its KP/32 column chunks cc[b],
//   the 32-row chunks cc[b, j] of Y[p] += V[p, b]^T @ X[p, rs[b] : rs[b] + MP]
// X is [P, x_rows, r] (given as the prologue's X^T, patch_spmm.cu) and Y
// [P, y_rows, r]; window rows past x_rows read zero, output rows past y_rows
// are dropped, and a chunk whose rows start at or past y_rows is a sentinel:
// the live chunks are compacted first (tile_mma.cuh's live_chunks), so a
// sentinel costs no load, no MMA and no add.
//
// What bounds it on the card: 2 r flops per stored value at the tier's
// tensor-core rate (3xTF32: 165 TFLOP/s for "highest"/"high"), or at
// precision=None (495 TFLOP/s) the bytes of V.
//
// The design.  In wgmma terms M = the slot's chunk columns (a 64-row A tile
// is a pair of live chunks), K = the window rows, N = TR columns of X:
//   - B = X's window: the K-major boxes X^T[c0 : c0 + TR, rs[b] + 32 i : +32]
//     (hi, and lo at tier 1) under the 128-byte swizzle, one 3-D tensor map
//     {x_rows, r, P} so that each product gets its own zero fill.  A block
//     loads the whole window once (ceil(MP / 32) boxes, each on its own
//     mbarrier) and keeps it for every 64-row tile it computes: the tiles of
//     one slot all multiply the same window.
//   - A = V^T from registers at both tiers: TF32 wgmma takes a shared-memory
//     operand only K-major, and V^T is MN-major in V's storage, but a
//     register fragment may be gathered in any order.  TMA brings V by live
//     chunk, a box [KB rows x 32 columns] of vals viewed [P*nb*MP, KP] (KB =
//     MP up to 32, else 32, or 16 where MP % 32 != 0): one 128-byte swizzle
//     span per row.  Each consumer thread reads its m64 x k8 fragment
//     elements (m' = chunk column, k' = window row) from the box; with the
//     swizzle a warp's 32 scalar reads of one fragment register fall in 16
//     banks, a 2-way conflict.  The values are never copied: no transposed V
//     exists.
//   - Exactly MP / 8 k8 steps per tile: the last window box of a slot whose
//     MP is not a multiple of 32 holds rows of other slots (or past n),
//     which no wgmma reads; A is not zeroed to mask them (0 * inf is NaN).
//   - Tier 0 (precision=None): A rounded to TF32 (cvt.rna), one wgmma per
//     k8, accumulating in registers, software-pipelined: a stage's
//     fragments are read while the previous stage's wgmmas run (two
//     fragment buffers, wgmma.wait_group 1).  Tier 1 (3xTF32): A split into
//     big = tf32(a) and small = a - big, small*hi + big*lo + big*hi per k8
//     in that order, each stage's products in a fresh accumulator added
//     into the tile's sums with IEEE fp32 adds (the tensor core's sums round
//     toward zero), as in the forward.  A stage's k8 count is a template
//     constant, so its wgmmas are one straight run and ptxas fences none of
//     them.
//   - Warp roles: two consumer warpgroups take alternate 64-row tiles of the
//     block's share, so one's epilogue overlaps the other's wgmma; each is
//     fed by its own producer warp through its own ring of stages (two
//     chunk boxes each; four stages at tier 0, two at tier 1, whose stages
//     hold three times the products).  A ring stage is free as soon as its
//     fragments are in registers, before the wgmma runs.
//   - Epilogue: a tile's 64 x TR sums leave through the TMA unit.  The
//     warpgroup writes them into its staging boxes (32 x 32 floats under the
//     128-byte swizzle, so the fragment writes do not conflict) and one
//     thread reduce-adds each box into Y's chunk rows
//     (cp.reduce.async.bulk.tensor ... add): the adds happen in the L2, a
//     box at a time, instead of as 16-byte atomics from every thread.  Where
//     r % 4 != 0 (Y's rows are not 16-byte strides) scalar atomicAdds.
//   - Grid: one block per (product, slot, group of 64-row tiles, column tile
//     TR in {64, 128}); the entry point (geometry() below, the one place
//     that decides it) sizes the groups so the grid fills the card, each
//     group reloading the window, and picks TR so the block's shared memory
//     fits: the window is MP * TR * 4 bytes per part, so TR = 64 where
//     MP > 128 at tier 1.
//
// Race-freedom: slots share output chunks and blocks run in no order, so
// every write to Y is an add into the zeroed output the wrapper allocates,
// element-wise atomic: the TMA reduce-add (each element's add in the L2 is
// atomic) or atomicAdd (tile_mma.cuh's AddY): one add per live chunk row,
// column and slot.  Products never share a row of Y.  The summation order
// varies from run to run.
//
// A shape the kernel does not take returns cudaErrorInvalidValue; there is
// no fallback.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_mma.cuh"
#include "tma_wgmma.cuh"

using namespace bst_tma;

namespace {

constexpr int kCC = 32;          // column chunk width of the patch plan
constexpr int kStage = 8192;     // two chunk boxes of up to 32 x 32 floats
constexpr int kHalf = kStage / 2;
constexpr int kMaxWin = 8;       // 32-row window boxes: MP <= 256
constexpr int kThreads = 2 * 128 + 2 * 32;
constexpr int kSmemCap = 227 * 1024;  // dynamic shared memory a block may use

// Shared memory: the window (ceil(MP / 32) boxes of WBOX), each warpgroup's
// ring of RING stages, each warpgroup's output staging (two chunks x TR / 32
// boxes of 32 x 32 floats under the 128-byte swizzle), alignment slack.
template <int TR, int TIER>
struct Tr {
  static constexpr int BOX = TR * 128;             // one X^T box [TR x 32]
  static constexpr int WBOX = BOX * (TIER + 1);    // hi (+ lo)
  static constexpr int ND = TR / 2;                // accumulator floats
  static constexpr int RING = TIER ? 2 : 4;        // 12 or 4 wgmmas a stage
  static constexpr int RING_BYTES = 2 * RING * kStage;
  static constexpr int OBOXES = TR / 32;           // output boxes per chunk
  static constexpr int STG = 2 * OBOXES * 4096;    // per warpgroup
  static int smem(int MP) {
    return (MP + 31) / 32 * WBOX + RING_BYTES + 2 * STG + 1024;
  }
};

// the compiler may not move a fragment's conversion past the wgmma fence:
// registers written after it would make ptxas fence every wgmma
template <int NK>
__device__ __forceinline__ void pin(uint32_t (&a)[NK][4]) {
#pragma unroll
  for (int k = 0; k < NK; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[k][i]));
}

// A consumer warpgroup's side of its ring and of the block's window.
struct Feed {
  const unsigned char* ring;  // this warpgroup's first stage
  uint64_t* full;             // its ring's barriers
  uint64_t* empty;
  int depth;                  // stages in the ring
  const unsigned char* win;   // the window's boxes
  int wbox;                   // bytes per window box
  uint64_t* wbar;             // one barrier per window box
  int KB;                     // window rows per stage
  int h, col, tig, lane;      // the thread's chunk, column and fragment lane
  bool mine;                  // this warp's chunk exists (warp-uniform)
};

// Ring stage s: the thread's A fragments of its NK k8 steps from its
// chunk's box (logical (m', k') = (col + 8 (q & 1), 8 ks + tig + 4 (q >> 1))
// is V's row k', column m'; A = 0 where this warp's chunk is absent), split
// for the tier; the slot is released once they are in registers.
template <int NK, int TIER>
__device__ __forceinline__ void take(const Feed& f, int s,
                                     uint32_t (&big)[NK][4],
                                     uint32_t (&small)[NK][4]) {
  const int slot = s % f.depth;
  mbar_wait(&f.full[slot], (s / f.depth) & 1);
  const unsigned char* st = f.ring + slot * kStage + f.h * kHalf;
#pragma unroll
  for (int ks = 0; ks < NK; ++ks)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float v = 0.f;
      if (f.mine)
        v = *reinterpret_cast<const float*>(
            st + sw128_offset(8 * ks + f.tig + 4 * (q >> 1),
                              f.col + 8 * (q & 1)));
      bst_mma::split<TIER>(v, big[ks][q], small[ks][q]);
    }
  pin(big);
  if constexpr (TIER == 1) pin(small);
  __syncwarp();
  if (f.lane == 0) mbar_arrive(&f.empty[slot]);
}

// The window box holding stage kb's rows: its shared address and the first
// k8 step of the stage inside it (waiting for the box to arrive).
__device__ __forceinline__ uint32_t window(const Feed& f, int kb, int& k0) {
  const int krow = kb * f.KB;
  mbar_wait(&f.wbar[krow / 32], 0);
  k0 = (krow % 32) / 8;
  return smem_u32(f.win + (krow / 32) * f.wbox);
}

// One 64-row tile at tier 0 (one TF32 pass) over its KS stages into acc,
// software-pipelined: stage kb + 1's fragments are read while stage kb's
// wgmmas run (two fragment buffers; a buffer is refilled once the group
// that read it has completed).
template <int TR, int NK>
__device__ __forceinline__ void tile_tf32(float (&acc)[TR / 2], const Feed& f,
                                          int& s, int KS) {
  uint32_t a0[NK][4], a1[NK][4], unused[NK][4];
#pragma unroll
  for (int k = 0; k < NK; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) a1[k][i] = 0u;
  auto run = [&](uint32_t(&a)[NK][4], int kb) {
    int k0;
    const uint32_t hb = window(f, kb, k0);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < NK; ++ks)
      Wgmma<TR>::rs(acc, a[ks], sw128_desc(hb + 32 * (k0 + ks)), 1);
    wg_commit();
  };
  fence_regs(acc);
  take<NK, 0>(f, s++, a0, unused);
  for (int kb = 0; kb < KS; kb += 2) {
    run(a0, kb);
    wg_wait1();
    pin(a1);  // the group that read a1 is done
    if (kb + 1 >= KS) break;
    take<NK, 0>(f, s++, a1, unused);
    run(a1, kb + 1);
    wg_wait1();
    pin(a0);
    if (kb + 2 < KS) take<NK, 0>(f, s++, a0, unused);
  }
  wg_wait0();
  pin(a0);
  pin(a1);
  fence_regs(acc);
}

// One 64-row tile at tier 1 (3xTF32) over its KS stages: each stage's
// products in a fresh accumulator, added into acc with IEEE fp32 adds.
template <int TR, int NK>
__device__ __forceinline__ void tile_3xtf32(float (&acc)[TR / 2],
                                            const Feed& f, int& s, int KS) {
  constexpr int BOX = TR * 128;  // the hi part of a window box; lo follows
  for (int kb = 0; kb < KS; ++kb) {
    uint32_t big[NK][4], small[NK][4];
    take<NK, 1>(f, s++, big, small);
    int k0;
    const uint32_t hb = window(f, kb, k0);
    float part[TR / 2];
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < NK; ++ks) {
      const uint64_t dh = sw128_desc(hb + 32 * (k0 + ks));
      const uint64_t dl = sw128_desc(hb + BOX + 32 * (k0 + ks));
      Wgmma<TR>::rs(part, small[ks], dh, ks > 0);  // ks 0: part = product
      Wgmma<TR>::rs(part, big[ks], dl, 1);
      Wgmma<TR>::rs(part, big[ks], dh, 1);
    }
    wg_commit();
    wg_wait0();
    fence_regs(part);
#pragma unroll
    for (int i = 0; i < TR / 2; ++i) acc[i] += part[i];
  }
}

template <int TR, int TIER, int NK>
__device__ __forceinline__ void tile(float (&acc)[TR / 2], const Feed& f,
                                     int& s, int KS) {
  if constexpr (TIER == 0)
    tile_tf32<TR, NK>(acc, f, s, KS);
  else
    tile_3xtf32<TR, NK>(acc, f, s, KS);
}

template <int TR, int TIER>
__global__ void __launch_bounds__(kThreads, 1)
    patch_tr_kernel(const __grid_constant__ CUtensorMap vmap,
                    const __grid_constant__ CUtensorMap hmap,
                    const __grid_constant__ CUtensorMap lmap,
                    const __grid_constant__ CUtensorMap ymap,
                    const int* __restrict__ cc, const int* __restrict__ rs,
                    float* __restrict__ y, int nb, int MP, int KP, int r,
                    long long y_rows, int KB, int group, int ngroups,
                    int ctiles, int reduce) {
  using T = Tr<TR, TIER>;
  constexpr int kRing = T::RING;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[2][kRing], empty[2][kRing];
  __shared__ __align__(8) uint64_t wbar[kMaxWin];
  __shared__ int chunk[bst_mma::kMaxKC], kpos[bst_mma::kMaxKC];
  __shared__ int counts[bst_mma::kMaxKC / 32];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int p = blockIdx.z;
  const int ct = blockIdx.x % ctiles, item = blockIdx.x / ctiles;
  const int b = item / ngroups, g = item % ngroups;
  const int c0 = ct * TR;
  const int KC = KP / kCC;
  const int nst = bst_mma::live_chunks(cc + (long long)b * KC, KC, y_rows,
                                       chunk, kpos, counts);
  const int t0 = g * group, t1 = min((nst + 1) / 2, t0 + group);
  if (t0 >= t1) return;
  const int nwin = (MP + 31) / 32, KS = MP / KB;  // window boxes, stages/tile
  if (threadIdx.x == 0) {
    for (int w = 0; w < 2; ++w)
      for (int s = 0; s < kRing; ++s) {
        mbar_init(&full[w][s], 1);
        mbar_init(&empty[w][s], 4);  // one arrival per consumer warp
      }
    for (int i = 0; i < nwin; ++i) mbar_init(&wbar[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned char* win = smem;  // nwin boxes of T::WBOX: hi, then lo
  unsigned char* ring = smem + nwin * T::WBOX;
  unsigned char* stg_all = ring + T::RING_BYTES;  // two warpgroups' staging
  const int w0 = __ldg(rs + b);  // the window's first row

  if (warp >= 8) {  // producer warps: 8 feeds warpgroup 0 and loads the window
    const int wg = warp - 8;
    if (lane == 0) {
      if (wg == 0)
        for (int i = 0; i < nwin; ++i) {
          unsigned char* dst = win + i * T::WBOX;
          mbar_expect_tx(&wbar[i], T::WBOX);
          tma_load3(dst, &hmap, &wbar[i], w0 + 32 * i, c0, p);
          if constexpr (TIER == 1)
            tma_load3(dst + T::BOX, &lmap, &wbar[i], w0 + 32 * i, c0, p);
        }
      const int vrow = (p * nb + b) * MP;
      int s = 0;
      for (int t = t0 + wg; t < t1; t += 2) {
        const bool two = 2 * t + 1 < nst;
        for (int kb = 0; kb < KS; ++kb, ++s) {
          const int slot = s % kRing;
          mbar_wait(&empty[wg][slot], ((s / kRing) & 1) ^ 1);
          unsigned char* st = ring + (wg * kRing + slot) * kStage;
          mbar_expect_tx(&full[wg][slot], (two ? 2 : 1) * KB * 128);
          tma_load(st, &vmap, &full[wg][slot], kpos[2 * t], vrow + kb * KB);
          if (two)
            tma_load(st + kHalf, &vmap, &full[wg][slot], kpos[2 * t + 1],
                     vrow + kb * KB);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: tiles t0 + wg, t0 + wg + 2, ... of the block
  const int wg = warp >> 2, lw = warp & 3, gid = lane >> 2, tig = lane & 3;
  const int h = lw >> 1;                 // this warp's chunk of the pair
  const int col = (lw & 1) * 16 + gid;   // its fragment rows' chunk column
  const int nk = KB / 8;                 // k8 steps per stage
  const bool odd = tig & 1;
  const bst_mma::AddY add{y + (long long)p * y_rows * r, y_rows, r, c0,
                          false};
  unsigned char* stg = stg_all + wg * T::STG;
  const bool leader = lw == 0 && lane == 0;  // starts the warpgroup's reduces
  int s = 0;
  for (int t = t0 + wg; t < t1; t += 2) {
    const bool mine = 2 * t + h < nst;  // warp-uniform
    const Feed f{ring + wg * kRing * kStage, full[wg], empty[wg], kRing, win,
                 T::WBOX, wbar, KB, h, col, tig, lane, mine};
    float acc[T::ND];
#pragma unroll
    for (int i = 0; i < T::ND; ++i) acc[i] = 0.f;
    switch (nk) {  // uniform: KB is the launch's
      case 4: tile<TR, TIER, 4>(acc, f, s, KS); break;
      case 3: tile<TR, TIER, 3>(acc, f, s, KS); break;
      case 2: tile<TR, TIER, 2>(acc, f, s, KS); break;
      default: tile<TR, TIER, 1>(acc, f, s, KS);
    }
    if (reduce) {
      // The tile to Y through the TMA unit: each warp writes its fragments
      // (rows gid, gid + 8 of its 16 at columns 8 j + 2 tig, + 1) into its
      // chunk's staging boxes, then the leader reduce-adds the boxes into
      // Y's chunk rows.  The staging is free again once the warpgroup's
      // previous reduces have read it.
      if (leader) bulk_wait_read();
      named_bar(1 + wg, 128);
      if (mine) {
        unsigned char* sb = stg + h * T::OBOXES * 4096;
        const int crow = (lw & 1) * 16 + gid;
#pragma unroll
        for (int j = 0; j < TR / 8; ++j) {
          const int c = 8 * j + 2 * tig;
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
            *reinterpret_cast<float2*>(
                sb + (c >> 5) * 4096 + sw128_offset(crow + 8 * hf, c & 31)) =
                make_float2(acc[4 * j + 2 * hf], acc[4 * j + 2 * hf + 1]);
        }
      }
      fence_proxy_async();
      named_bar(1 + wg, 128);
      if (leader) {
        for (int hh = 0; hh < 2 && 2 * t + hh < nst; ++hh)
          for (int q = 0; q < T::OBOXES && c0 + 32 * q < r; ++q)
            tma_reduce_add3(&ymap, stg + (hh * T::OBOXES + q) * 4096,
                            c0 + 32 * q, chunk[2 * t + hh] * kCC, p);
        bulk_commit();
      }
    } else if (mine) {
      // Lane (gid, tig) holds rows gid and gid + 8 of its warp's 16 at
      // columns 8 j + 2 tig (+ 1): an even lane takes row gid and an odd
      // lane row gid + 8 of the four columns 8 j + 4 (tig / 2) .. + 3,
      // trading halves; scalar atomics, columns past r dropped.
      const long long row = (long long)chunk[2 * t + h] * kCC + (lw & 1) * 16 +
                            (odd ? gid + 8 : gid);
#pragma unroll
      for (int j = 0; j < TR / 8; ++j) {
        const float* v = acc + 4 * j;
        const float r0 = __shfl_xor_sync(0xffffffffu, odd ? v[0] : v[2], 1);
        const float r1 = __shfl_xor_sync(0xffffffffu, odd ? v[1] : v[3], 1);
        add(row, 8 * j + (tig & 2) * 2,
            odd ? make_float4(r0, r1, v[2], v[3])
                : make_float4(v[0], v[1], r0, r1));
      }
    }
  }
  if (reduce && leader) bulk_wait();  // the staging outlives the reduces
}

struct Args {
  CUtensorMap v, h, l, ym;
  const int *cc, *rs;
  float* y;
  int P, nb, MP, KP, r;
  long long y_rows;
  int KB, group, ngroups, ctiles, reduce;
};

template <int TR, int TIER>
int launch(const Args& a, cudaStream_t s) {
  using T = Tr<TR, TIER>;
  const int smem = T::smem(a.MP);
  if (smem > kSmemCap) return (int)cudaErrorInvalidValue;
  static int sized = 0;  // the dynamic shared memory granted so far
  if (smem > sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        patch_tr_kernel<TR, TIER>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    sized = smem;
  }
  const long long blocks = (long long)a.nb * a.ngroups * a.ctiles;
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, 1, a.P);
  patch_tr_kernel<TR, TIER><<<grid, kThreads, smem, s>>>(
      a.v, a.h, a.l, a.ym, a.cc, a.rs, a.y, a.nb, a.MP, a.KP, a.r, a.y_rows,
      a.KB, a.group, a.ngroups, a.ctiles, a.reduce);
  return (int)cudaGetLastError();
}

template <int TR>
int launch_tier(int tier, const Args& a, cudaStream_t s) {
  return tier ? launch<TR, 1>(a, s) : launch<TR, 0>(a, s);
}

// The launch geometry on a card of `sms` multiprocessors (one block each).
// tr, the column tile: 128 where r > 64 and the block's shared memory fits,
// else 64.  group: the 64-row tiles (pairs of live chunks) a block computes,
// the one that minimises waves x (group + 1/2) -- a block's window load
// costs about half a tile -- ties to the larger group.  blocks: the grid's
// size, P included.
struct Geometry {
  int tr, ctiles, group, ngroups;
  long long blocks;
};

Geometry geometry(int P, int nb, int MP, int KP, int r, int tier, int sms) {
  Geometry g{};
  const int wide = tier ? Tr<128, 1>::smem(MP) : Tr<128, 0>::smem(MP);
  g.tr = r > 64 && wide <= kSmemCap ? 128 : 64;
  g.ctiles = (r + g.tr - 1) / g.tr;
  const int mtiles = (KP / kCC + 1) / 2;
  long long best = -1;
  for (int group = 1; group <= mtiles; ++group) {
    const int ngroups = (mtiles + group - 1) / group;
    const long long blocks = (long long)P * nb * ngroups * g.ctiles;
    const long long cost = (blocks + sms - 1) / sms * (2 * group + 1);
    if (best < 0 || cost <= best)
      best = cost, g.group = group, g.ngroups = ngroups, g.blocks = blocks;
  }
  return g;
}

}  // namespace

// The geometry the transposed product launches with, as out = {tr, group,
// blocks}, for a card of `sms` multiprocessors.
extern "C" int bst_patch_tr_geometry(int P, int nb, int MP, int KP, int r,
                                     int tier, int sms, long long* out) {
  if (P <= 0 || nb <= 0 || MP <= 0 || MP > 32 * kMaxWin || KP <= 0 ||
      KP % kCC != 0 || r <= 0 || tier < 0 || tier > 1 || sms <= 0)
    return (int)cudaErrorInvalidValue;
  const Geometry g = geometry(P, nb, MP, KP, r, tier, sms);
  out[0] = g.tr, out[1] = g.group, out[2] = g.blocks;
  return 0;
}

// The transposed product: y [P, y_rows, r] (zeroed) += the bucket's
// transpose applied to X [P, x_rows, r], given as the prologue's hi / lo
// [P, r, ld] (lo read at tier 1 only).  tier: 0 one TF32 pass, 1 3xTF32.
// vals [P, nb, MP, KP] 16-byte aligned, MP % 8 == 0.
extern "C" int bst_patch_spmm_tr_f32(const float* vals, const int* cc,
                                     const int* rs, const float* xt_hi,
                                     const float* xt_lo, float* y, int P,
                                     int nb, int MP, int KP, int r,
                                     long long x_rows, long long ld,
                                     long long y_rows, int tier,
                                     void* stream) {
  if (KP % kCC != 0 || KP / kCC > bst_mma::kMaxKC || MP % 8 != 0 ||
      MP > 32 * kMaxWin || tier < 0 || tier > 1 ||
      P > 65535 || !aligned16(vals) || !aligned16(xt_hi) ||
      (tier == 1 && (xt_lo == nullptr || !aligned16(xt_lo))) || ld % 4 != 0 ||
      ld < x_rows || x_rows >= (1LL << 31) || y_rows >= (1LL << 31) ||
      (long long)P * nb * MP >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (P <= 0 || nb <= 0 || r <= 0 || MP <= 0 || KP <= 0 || x_rows <= 0 ||
      y_rows <= 0)
    return 0;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const Geometry g = geometry(P, nb, MP, KP, r, tier, sms);
  EncodeTiled enc;
  e = encoder(&enc);
  if (e != cudaSuccess) return (int)e;
  Args a;
  const long long xdims[3] = {x_rows, r, P}, xstrides[2] = {ld, r * ld};
  const int xbox[3] = {32, g.tr, 1};
  const int KB = MP <= 32 ? MP : MP % 32 == 0 ? 32 : MP % 16 == 0 ? 16 : 8;
  if (!tensor_map(enc, &a.v, vals, KP, (long long)P * nb * MP, KP, KB) ||
      !tensor_map_nd(enc, &a.h, xt_hi, 3, xdims, xstrides, xbox) ||
      !tensor_map_nd(enc, &a.l, tier == 1 ? xt_lo : xt_hi, 3, xdims, xstrides,
                     xbox))
    return (int)cudaErrorInvalidValue;
  // Y [P, y_rows, r] in 32 x 32 boxes for the TMA reduce (r % 4 == 0: the
  // row stride a multiple of 16 bytes); else atomics, the map unused
  a.reduce = r % 4 == 0 && aligned16(y);
  const long long ydims[3] = {r, y_rows, P}, ystrides[2] = {r, y_rows * r};
  const int ybox[3] = {32, 32, 1};
  if (a.reduce ? !tensor_map_nd(enc, &a.ym, y, 3, ydims, ystrides, ybox)
               : !tensor_map_nd(enc, &a.ym, xt_hi, 3, xdims, xstrides, xbox))
    return (int)cudaErrorInvalidValue;
  a.cc = cc, a.rs = rs, a.y = y;
  a.P = P, a.nb = nb, a.MP = MP, a.KP = KP, a.r = r, a.y_rows = y_rows;
  a.KB = KB, a.group = g.group, a.ngroups = g.ngroups, a.ctiles = g.ctiles;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return g.tr == 64 ? launch_tier<64>(tier, a, s)
                    : launch_tier<128>(tier, a, s);
}
