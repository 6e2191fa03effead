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
// x indices at or past len(x) read 0 and y indices at or past len(y) are
// dropped, so no padded buffers are needed (as B2).  A slot's column chunks
// that lie wholly past the column side (the sentinels) hold zero values:
// their lanes skip the value loads.  Unlike the TPU kernel, which blocked
// slots G at a time for Mosaic (G % 8 == 0), any slot count is taken.
//
// What bounds it on the card: each value is read once for 2 flops (4 in
// modes m and a), so the plan's value bytes bound it.  Design: one warp per
// [8 x KP] row tile of a slot in mode f -- lane l owns columns 4l..4l+3 of
// every 128-column stretch, reads one float4 per row with streaming loads
// (each warp request is one coalesced 512-byte row), keeps eight row sums in
// registers across the whole row tile and reduces them once
// (tile_stream.cuh's butterfly); one warp per [MP x 128] column stretch of a
// slot in modes t, m and a -- the column sums of the stretch stay in
// registers across all MP rows and leave in one atomic per column, and the
// forward sums (m, a) are reduced per [8, 128] tile.
//
// Race-freedom: slots run concurrently and may share output rows and
// columns, so every write to y is an fp32 atomicAdd into the zeroed output
// the wrapper allocated; the summation order varies between runs.  The TPU
// kernel wrote per-slot vectors and left the scatter-add to XLA.
#include <cuda_runtime.h>

#include "tile_stream.cuh"

namespace {

constexpr int kCC = 32;  // column chunk width of the patch plan
constexpr int kRows = bst::kTileRows;
constexpr int kCols = bst::kTileCols;

enum Mode { kF = 0, kT = 1, kM = 2, kA = 3 };

__device__ __forceinline__ float4 load_or_zero(const float* p, bool live) {
  return live ? __ldcs(reinterpret_cast<const float4*>(p))
              : make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ float dot4(float4 v, const float (&xv)[4],
                                      float acc) {
  acc = fmaf(v.x, xv[0], acc);
  acc = fmaf(v.y, xv[1], acc);
  acc = fmaf(v.z, xv[2], acc);
  return fmaf(v.w, xv[3], acc);
}

__device__ __forceinline__ void load_x4(const float* __restrict__ x,
                                        long long i, long long n, bool live,
                                        float (&xv)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e)
    xv[e] = live && i + e < n ? __ldg(x + i + e) : 0.f;
}

// Mode f: warp w = (slot b, row tile mi); walks the slot's KP columns.
__global__ void __launch_bounds__(bst::kStreamThreads)
    patch_spmv1_rows(const float* __restrict__ vals, const int* __restrict__ cc,
                     const int* __restrict__ rs, const float* __restrict__ x,
                     float* __restrict__ y, int nb, int MP, int KP,
                     long long n_in, long long n_out) {
  const int lane = threadIdx.x & 31;
  const long long w = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int MT = MP / kRows, KC = KP / kCC;
  if (w >= (long long)nb * MT) return;
  const long long b = w / MT;
  const int mi = (int)(w % MT);
  const float* V = vals + (b * MP + (long long)mi * kRows) * KP;
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
  for (int k0 = 0; k0 < KP; k0 += kCols) {
    const int k = k0 + 4 * lane;
    const long long xi = (long long)__ldg(cc + b * KC + k / kCC) * kCC + k % kCC;
    const bool live = xi < n_in;
    float xv[4];
    load_x4(x, xi, n_in, live, xv);
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      acc[r] = dot4(load_or_zero(V + (long long)r * KP + k, live), xv, acc[r]);
  }
  const float tot = bst::warp_rows_total(acc, lane);
  const long long row = __ldg(rs + b) + (long long)mi * kRows + ((lane >> 2) & 7);
  if ((lane & 3) == 0 && row < n_out) atomicAdd(y + row, tot);
}

// Modes t, m, a: warp w = (slot b, 128-column stretch kj); walks MP rows.
template <int MODE>
__global__ void __launch_bounds__(bst::kStreamThreads)
    patch_spmv1_cols(const float* __restrict__ vals, const int* __restrict__ cc,
                     const int* __restrict__ rs, const int* __restrict__ mk,
                     const float* __restrict__ x, float* __restrict__ y,
                     int nb, int MP, int KP, long long n_in, long long n_out) {
  constexpr bool kFwd = MODE == kM || MODE == kA;
  const int lane = threadIdx.x & 31;
  const long long w = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int KT = KP / kCols, KC = KP / kCC;
  if (w >= (long long)nb * KT) return;
  const long long b = w / KT;
  const int k = (int)(w % KT) * kCols + 4 * lane;
  const int j = k / kCC;
  // the column side: y in mode t, x and y alike in the square modes m, a
  const long long ncol = MODE == kT ? n_out : n_in;
  const long long ci = (long long)__ldg(cc + b * KC + j) * kCC + k % kCC;
  const bool live = ci < ncol;
  const bool in_mirror = MODE == kT || j < __ldg(mk + b);
  float xv[4];
  if constexpr (kFwd) load_x4(x, ci, n_in, live && (MODE == kM || in_mirror), xv);
  const long long r0 = __ldg(rs + b);
  const float* V = vals + b * MP * KP + k;
  float yt[4] = {0.f, 0.f, 0.f, 0.f};
  for (int m0 = 0; m0 < MP; m0 += kRows) {
    float4 v[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      v[r] = load_or_zero(V + (long long)(m0 + r) * KP, live);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const long long row = r0 + m0 + r;
      const float xr = row < n_in ? __ldg(x + row) : 0.f;
      yt[0] = fmaf(v[r].x, xr, yt[0]);
      yt[1] = fmaf(v[r].y, xr, yt[1]);
      yt[2] = fmaf(v[r].z, xr, yt[2]);
      yt[3] = fmaf(v[r].w, xr, yt[3]);
    }
    if constexpr (kFwd) {
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = dot4(v[r], xv, 0.f);
      const float tot = bst::warp_rows_total(acc, lane);
      const long long row = r0 + m0 + ((lane >> 2) & 7);
      if ((lane & 3) == 0 && row < n_out) atomicAdd(y + row, tot);
    }
  }
  // mode m mirrors only the stored off-diagonal chunks; t and a every chunk
  if (live && (MODE != kM || in_mirror)) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (ci + e < n_out) atomicAdd(y + ci + e, yt[e]);
  }
}

}  // namespace

// y ([n_out] f32) must be zeroed; mk may be null for modes f and t.
// mode: 0 f, 1 t, 2 m, 3 a (see above).
extern "C" int bst_patch_spmv1_f32(const float* vals, const int* cc,
                                   const int* rs, const int* mk,
                                   const float* x, float* y, int nb, int MP,
                                   int KP, long long n_in, long long n_out,
                                   int mode, void* stream) {
  if (MP <= 0 || MP % kRows != 0 || KP <= 0 || KP % kCols != 0 || mode < kF ||
      mode > kA || ((mode == kM || mode == kA) && mk == nullptr))
    return (int)cudaErrorInvalidValue;
  if (nb <= 0 || n_out <= 0) return 0;
  const long long warps =
      (long long)nb * (mode == kF ? MP / kRows : KP / kCols);
  const int per_block = bst::kStreamThreads / 32;
  const unsigned blocks = (unsigned)((warps + per_block - 1) / per_block);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kF:
      patch_spmv1_rows<<<blocks, bst::kStreamThreads, 0, s>>>(
          vals, cc, rs, x, y, nb, MP, KP, n_in, n_out);
      break;
    case kT:
      patch_spmv1_cols<kT><<<blocks, bst::kStreamThreads, 0, s>>>(
          vals, cc, rs, mk, x, y, nb, MP, KP, n_in, n_out);
      break;
    case kM:
      patch_spmv1_cols<kM><<<blocks, bst::kStreamThreads, 0, s>>>(
          vals, cc, rs, mk, x, y, nb, MP, KP, n_in, n_out);
      break;
    default:
      patch_spmv1_cols<kA><<<blocks, bst::kStreamThreads, 0, s>>>(
          vals, cc, rs, mk, x, y, nb, MP, KP, n_in, n_out);
      break;
  }
  return (int)cudaGetLastError();
}
