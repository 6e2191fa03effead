// Batched merged-patch SpMM on Hopper tensor cores (kernel B4 of the port).
//
// Replaces the forward mode of blocksparse_tpu/ops/batched.py::_kern_batched
// (launched from _batched_raw under batched_mm): P same-structure patch
// SpMMs in one launch.  The P operators share one patch plan's tables -- cc
// [nb, KP/32] and rs [nb] -- and differ only in their values, stacked [P,
// nb, MP, KP].  For every product p and slot b:
//   Y[p, rs[b] : rs[b] + MP] += V[p, b] @ concat_j X[p, cc[b, j]*32 : +32]
// X is [P, x_rows, r] and Y [P, y_rows, r]; rows past X's end read zero and
// rows past Y's end are dropped, so the JAX wrapper's padding of X and Y to
// the plan's padded row counts is not needed.  A chunk id whose rows start
// past X's end is a sentinel.  The transposed mode (the backward's dX) is
// kernel B2's transposed product with its product axis (patch_spmm_tr.cu).
//
// The design: one block per (product p = blockIdx.z, slot b and 128-row
// tile, column tile of 64 or 128), on tile_mma.cuh's tensor-core loop: a
// full 128 x 128 output tile at MP = 128, r = 128, the slot's live chunks
// (sentinels skipped: no loads, no MMAs) staged 32 deep through the
// cp.async ring.  tier 0 is one TF32 pass (precision=None),
// tier 1 3xTF32 ("high", "highest").  The TPU kernel prefetched product
// p+1's slabs under product p's compute in an in-order grid; here the
// products' blocks run side by side.
//
// What bounds it on the card: 2 r flops per stored value of every product,
// at the 3xTF32 rate (165 TFLOP/s) for tier 1; at tier 0 the bytes of the P
// value stacks.
//
// Race-freedom: slots of one product may share output rows and blocks run
// in no order, so every write to Y is an atomicAdd(float4*) into the zeroed
// output the wrapper allocates; products never share a row of Y.  The
// summation order across blocks varies from run to run.
#include "tile_mma.cuh"

namespace {

using bst_mma::Tile;
constexpr int kCC = 32;  // column chunk width of the patch plan

struct BatchArgs {
  const float* vals;
  const int* cc;
  const int* rs;
  const float* x;
  float* y;
  int nb, MP, KP, r;
  long long x_rows, y_rows;
  int vec, rtiles;
};

// Forward stage s: A = V[m0 : m0 + 128, kpos[s] : +32], B = the chunk's X rows.
template <class T>
struct ForwardStages {
  const float* V;
  int KP, m0, mrows;
  const float* x;
  long long x_rows;
  int r, c0;
  bool vec;
  const int* chunk;  // shared memory
  const int* kpos;
  __device__ __forceinline__ bool live(int) const { return true; }
  __device__ __forceinline__ void load(int s, float* As, float* Bs) const {
    const float* Vk = V + kpos[s];
    bst_mma::copy_tile<T::ROWS, T::KT>(
        As, T::A_LD,
        [&](int q) -> const float* {
          return q < mrows ? Vk + (long long)(m0 + q) * KP : nullptr;
        },
        bst_mma::AllCols{}, true, V);
    const long long base = (long long)chunk[s] * kCC;
    bst_mma::copy_tile<T::KT, T::TR>(
        Bs, T::B_LD,
        [&](int q) -> const float* {
          return base + q < x_rows ? x + (base + q) * r + c0 : nullptr;
        },
        bst_mma::ColsBelow{r - c0}, vec, x);
  }
};

// 128 x TRW tiles.  The 3xTF32 instance holds the stage's split B
// fragments beside a 64-value accumulator: one block per SM, a deeper ring.
template <int TRW, int TIER>
struct Kern {
  static constexpr bool kWide = TIER == 1;
  using T = Tile<false, 2, 4, TRW / 32, 32, kWide ? 5 : 3>;
  static_assert(T::TR == TRW && T::ROWS == 128, "tile");
};

template <int TRW, int TIER>
__global__ void __launch_bounds__(bst_mma::kThreads,
                                  Kern<TRW, TIER>::kWide ? 1 : 2)
    batched_spmm_kernel(BatchArgs a) {
  using T = typename Kern<TRW, TIER>::T;
  extern __shared__ __align__(16) float smem[];
  const long long p = blockIdx.z;
  const float* V = a.vals + (p * a.nb + blockIdx.x / a.rtiles) *
                                (long long)a.MP * a.KP;
  const float* X = a.x + p * a.x_rows * a.r;
  const int b = blockIdx.x / a.rtiles, tile = blockIdx.x % a.rtiles;
  const int c0 = blockIdx.y * TRW;
  const int KC = a.KP / kCC;
  const int* cc_row = a.cc + (long long)b * KC;
  const bst_mma::AddY add{a.y + p * a.y_rows * a.r, a.y_rows, a.r, c0,
                          a.vec != 0};
  __shared__ int chunk[bst_mma::kMaxKC], kpos[bst_mma::kMaxKC];
  __shared__ int counts[bst_mma::kMaxKC / 32];
  const int nst = bst_mma::live_chunks(cc_row, KC, a.x_rows, chunk, kpos,
                                       counts);
  if (nst == 0) return;
  const int m0 = tile * T::ROWS, mrows = min(T::ROWS, a.MP - m0);
  const long long row0 = (long long)__ldg(a.rs + b) + m0;
  const ForwardStages<T> st{V, a.KP, m0, mrows, X, a.x_rows, a.r, c0,
                            a.vec != 0, chunk, kpos};
  bst_mma::tile_gemm<T, TIER>(
      st, nst, (mrows + 15) / 16,
      [&](int row, int col, float4 v) {
        if (row < mrows) add(row0 + row, col, v);
      },
      smem);
}

template <int TRW, int TIER>
int launch(const BatchArgs& a, dim3 grid, cudaStream_t s) {
  constexpr int smem = Kern<TRW, TIER>::T::SMEM;
  static bool sized = false;  // above 48 KB once per kernel instance
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        batched_spmm_kernel<TRW, TIER>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  batched_spmm_kernel<TRW, TIER><<<grid, bst_mma::kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// y must be zeroed ([P, y_rows, r] f32).  tier: 0 one TF32 pass, 1
// 3xTF32.  vals must be 16-byte aligned.
extern "C" int bst_batched_spmm_f32(const float* vals, const int* cc,
                                    const int* rs, const float* x, float* y,
                                    int P, int nb, int MP, int KP, int r,
                                    long long x_rows, long long y_rows,
                                    int tier, void* stream) {
  if (KP % kCC != 0 || KP / kCC > bst_mma::kMaxKC || P > 65535 || tier < 0 ||
      tier > 1 || reinterpret_cast<uintptr_t>(vals) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (P <= 0 || nb <= 0 || r <= 0 || MP <= 0 || y_rows <= 0) return 0;
  const bool vec = r % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const int trw = r <= 64 ? 64 : 128;
  const int rtiles = (MP + 127) / 128;
  const BatchArgs a{vals, cc, rs, x, y, nb, MP, KP, r, x_rows, y_rows,
                    vec ? 1 : 0, rtiles};
  const dim3 grid(nb * rtiles, (r + trw - 1) / trw, P);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (trw == 64)
    return tier ? launch<64, 1>(a, grid, s) : launch<64, 0>(a, grid, s);
  return tier ? launch<128, 1>(a, grid, s) : launch<128, 0>(a, grid, s);
}
