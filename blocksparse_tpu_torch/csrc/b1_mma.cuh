// Tensor-core instances of kernel B1 at r > 1: the work numbering, the
// cp.async ring and the launch that complex_mma.cu (complex64: 3xTF32),
// dmma.cu (float64 and complex128: f64 mma.sync) and bf16_mma.cu (bf16
// values with a float32 operand: three bf16 passes) share.  Each of those
// files supplies a policy, a class template P<WN, TRANS, CONJ> (WN: the n8
// tiles of a warp; TRANS: A = V^T; CONJ: read conj(V)) that holds a block's
// accumulators and knows its stage layout and copies (load), its fragments
// and MMAs (compute) and the epilogue that adds its tile into y (store).
//
// Work: one thread block of P::kThreads (four warps, or eight) per (stored
// block, 64-row output tile, column tile), the work items numbered through
// the bucket table as B1's (tile_core.cuh::BucketDesc, locate): grid.x
// runs over the items, grid.y over the column tiles.
// The contraction runs in stages of P::KC rows of the block through a
// kStages-deep ring of cp.async copies issued kStages - 1 stages ahead of
// the MMAs that read them.  The modes are B1's: 0 forward, 1 transpose, 2
// symmetric (the forward items, then the transposed ones), plus bst::kConj
// (4) for conj(V) on a complex policy (a real one has no conjugate
// instance; the bit changes nothing there).
//
// Race-freedom: thread blocks share output rows, so every write to y is an
// atomicAdd into the output the wrapper zeroed or the partial sum of the
// launches before it; the summation order varies from run to run.
#pragma once

#include <stdint.h>

#include "tile_core.cuh"
#include "tile_mma.cuh"

namespace bst_b1mma {

constexpr int kThreads = 128;    // four warps: a policy's default
constexpr int kRows = bst::kMT;  // output rows per work item (64)
constexpr int kStages = 3;

// BYTES (4, 8 or 16) from global src into shared dst; !full zero-fills
// dst and reads nothing (src any valid address)
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(full ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
                 "l"(src), "n"(BYTES), "r"(full ? BYTES : 0));
}

struct Args {
  bst::DescTable tab;
  const void* x;  // [x_rows, r] of the compute type
  void* y;        // [y_rows, r], added into
  int r;
  long long x_rows, y_rows;
};

// The work item a thread block runs, as its policy reads it: block b of
// its bucket (values V, row stride kp), output rows m0 .. m0 + 63 of M (y's
// rows through out_row), contraction K (x's rows through in_row), and the
// first column c0 of its tile, in x's columns.  A policy keeps a copy: one
// held by reference stayed in local memory and cost 2-3% of the time.
struct Item {
  const Args& a;
  const void* V;
  bst::ChunkMap out_row, in_row;
  int b, m0, M, K, kp, c0;
  __device__ __forceinline__ int live_rows() const {
    return M - m0 < kRows ? M - m0 : kRows;
  }
};

template <template <int, bool, bool> class P, int WN, bool TRANS, bool CONJ>
__device__ __forceinline__ void item_product(const Args& a, long long g,
                                             int ct, unsigned char* smem) {
  using T = P<WN, TRANS, CONJ>;
  long long item;
  const bst::BucketDesc d = bst::locate(a.tab, g, TRANS ? 1 : 0, item);
  const int mp = (int)d.mp, kp = (int)d.kp, C = (int)d.C;
  const int M = TRANS ? kp : mp, K = TRANS ? mp : kp;
  const int mtiles = (M + kRows - 1) / kRows;
  const int b = (int)(item / mtiles);
  const Item it{a,
                static_cast<const unsigned char*>(d.vals) +
                    (long long)b * mp * kp * T::kVBytes,
                bst::ChunkMap(TRANS ? d.col_tab : d.row_tab, M, C),
                bst::ChunkMap(TRANS ? d.row_tab : d.col_tab, K, C),
                b,
                (int)(item % mtiles) * kRows,
                M,
                K,
                kp,
                ct * T::TC};
  T t(it);
  const int nst = (K + T::KC - 1) / T::KC;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nst) t.load(s, smem + s * T::STAGE);
    bst_mma::cp_async_commit();
  }
  for (int s = 0; s < nst; ++s) {
    bst_mma::cp_async_wait<kStages - 2>();
    __syncthreads();
    // the buffer of stage s - 1, which every thread has finished reading
    const int nx = s + kStages - 1;
    if (nx < nst) t.load(nx, smem + (nx % kStages) * T::STAGE);
    bst_mma::cp_async_commit();
    t.compute(smem + (s % kStages) * T::STAGE);
  }
  bst_mma::cp_async_wait<0>();
  t.store();
}

// grid (work items, column tiles)
template <template <int, bool, bool> class P, int WN, bool CONJ>
__global__ void __launch_bounds__(P<WN, false, CONJ>::kThreads,
                                  P<WN, false, CONJ>::kBlocks)
    mma_kernel(const Args a, long long items_f, int mode) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long g = blockIdx.x;
  const int ct = (int)blockIdx.y;
  if (mode == 0 || (mode == 2 && g < items_f))
    item_product<P, WN, false, CONJ>(a, g, ct, smem);
  else
    item_product<P, WN, true, CONJ>(a, mode == 2 ? g - items_f : g, ct, smem);
}

template <template <int, bool, bool> class P, int WN, bool CONJ>
int launch(const Args& a, long long items_f, long long items, int mode,
           cudaStream_t s) {
  using T = P<WN, false, CONJ>;
  static_assert(T::STAGE == P<WN, true, CONJ>::STAGE && T::STAGE % 16 == 0,
                "one stage size for both layouts, in 16-byte units");
  constexpr int smem = kStages * T::STAGE;
  // above 48 KB of dynamic shared memory, once per kernel and device
  static unsigned sized = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 32) return (int)cudaErrorInvalidDevice;
  if (!(sized & (1u << dev))) {
    e = cudaFuncSetAttribute(mma_kernel<P, WN, CONJ>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return (int)e;
    sized |= 1u << dev;
  }
  const dim3 grid((unsigned)items, (unsigned)((a.r + T::TC - 1) / T::TC));
  mma_kernel<P, WN, CONJ><<<grid, T::kThreads, smem, s>>>(a, items_f, mode);
  return (int)cudaGetLastError();
}

// the policy's column tile for r: WN = 1, 2 or 4
template <template <int, bool, bool> class P, bool CONJ>
int launch_width(const Args& a, long long items_f, long long items, int mode,
                 cudaStream_t s) {
  const int wn = P<1, false, CONJ>::width(a.r);
  if (wn == 1) return launch<P, 1, CONJ>(a, items_f, items, mode, s);
  if (wn == 2) return launch<P, 2, CONJ>(a, items_f, items, mode, s);
  return launch<P, 4, CONJ>(a, items_f, items, mode, s);
}

// The body of every tensor-core entry: table, n descriptors of chunked
// buckets (int64 [n, 9], tile_core.cuh::BucketDesc); items_f / items_t: the
// table's work items in the forward and the transposed numbering; x
// [x_rows, r], y [y_rows, r] of the compute type, y added into; mode 0
// forward, 1 transpose, 2 symmetric (x_rows == y_rows), plus bst::kConj.
template <template <int, bool, bool> class P>
int run(const void* table, int n, long long items_f, long long items_t,
        const void* x, void* y, int r, long long x_rows, long long y_rows,
        int mode, void* stream) {
  const bool conj = (mode & bst::kConj) != 0;
  mode &= ~bst::kConj;
  const long long items =
      mode == 0 ? items_f : (mode == 1 ? items_t : items_f + items_t);
  if (n <= 0 || mode < 0 || mode > 2 || items_f < 0 || items_t < 0 ||
      items > 0x7fffffffLL || (mode == 2 && x_rows != y_rows))
    return (int)cudaErrorInvalidValue;
  if (items == 0 || r <= 0 || y_rows == 0) return 0;
  const Args a{bst::DescTable{static_cast<const bst::BucketDesc*>(table), n,
                              {}},
               x, y, r, x_rows, y_rows};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (P<1, false, false>::kComplex) {
    if (conj) return launch_width<P, true>(a, items_f, items, mode, s);
  }
  return launch_width<P, false>(a, items_f, items, mode, s);
}

}  // namespace bst_b1mma
