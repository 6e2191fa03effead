// Merged-patch SpMM on Hopper (kernel B2 of the port).
//
// Replaces blocksparse_tpu/ops/patch_engine.py::_kern_fwd and ::_kern_tr
// (launched from _bucket_spmm_raw / patch_spmm).  For every slot b of a
// patch bucket, with V_b of shape [MP, KP] and its KP/32 column chunks cc[b]:
//   forward    Y[rs[b] : rs[b] + MP] += V_b @ Xg,  Xg = concat_j X[cc[b,j]*32 : +32]
//   transpose  the 32-row chunks cc[b, j] of Y  += (V_b^T @ X[rs[b] : rs[b] + MP])
// Sentinel column chunks (id NC) point past X's last row and read zero;
// padded slots (zero values, rs = 0) add zeros.
//
// What bounds it on the card: at r = 64-128 each value feeds r FMAs, so the
// kernel sits between the bytes of vals and the CUDA-core FMA rate.  The
// design (tile_core.cuh): one thread block per (slot, 64-row output tile,
// RHS tile of up to 128 columns); the block reads its own cc / rs entries, stages the
// V tile and the gathered X rows in shared memory, and adds its tile into Y
// with atomics.  The TPU kernel kept Y resident and relied on an in-order
// grid; here every write to Y is an atomicAdd into the zeroed output, so
// the summation order varies between runs.  Any r is taken directly, with
// no RHS slicing.  The plan is f32-only, so the kernel is f32.
#include "tile_core.cuh"

namespace {

constexpr int kCC = 32;  // column chunk width of the patch plan

template <int TR, bool TRANS>
__global__ void __launch_bounds__(bst::kThreads)
    patch_spmm_kernel(const float* __restrict__ vals, const int* __restrict__ cc,
                      const int* __restrict__ rs, const float* __restrict__ x,
                      float* __restrict__ y, int MP, int KP, int r,
                      long long x_rows, long long y_rows) {
  const bst::WindowMap window{rs};
  const bst::ChunkMap chunks{cc, KP / kCC, kCC};
  if constexpr (TRANS)
    bst::tile_product<float, TR, true, false>(vals, MP, KP, chunks, window, x,
                                              x_rows, y, y_rows, r);
  else
    bst::tile_product<float, TR, false, false>(vals, MP, KP, window, chunks,
                                               x, x_rows, y, y_rows, r);
}

template <int TR>
void launch(dim3 grid, cudaStream_t s, bool transpose, const float* vals,
            const int* cc, const int* rs, const float* x, float* y, int MP,
            int KP, int r, long long x_rows, long long y_rows) {
  if (transpose)
    patch_spmm_kernel<TR, true><<<grid, bst::kThreads, 0, s>>>(
        vals, cc, rs, x, y, MP, KP, r, x_rows, y_rows);
  else
    patch_spmm_kernel<TR, false><<<grid, bst::kThreads, 0, s>>>(
        vals, cc, rs, x, y, MP, KP, r, x_rows, y_rows);
}

}  // namespace

// y must be zeroed.  transpose: 0 forward, 1 transpose.
extern "C" int bst_patch_spmm_f32(const float* vals, const int* cc,
                                  const int* rs, const float* x, float* y,
                                  int nb, int MP, int KP, int r,
                                  long long x_rows, long long y_rows,
                                  int transpose, void* stream) {
  if (KP % kCC != 0) return (int)cudaErrorInvalidValue;
  if (nb <= 0 || r <= 0 || MP <= 0 || KP <= 0) return 0;
  const int M = transpose ? KP : MP;
  const int tr = bst::column_tile(r, false);
  const dim3 grid(nb * ((M + bst::kMT - 1) / bst::kMT), (r + tr - 1) / tr);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BST_LAUNCH(TRV) \
  launch<TRV>(grid, s, transpose != 0, vals, cc, rs, x, y, MP, KP, r, x_rows, y_rows)
  switch (tr) {
    case 1: BST_LAUNCH(1); break;
    case 32: BST_LAUNCH(32); break;
    case 64: BST_LAUNCH(64); break;
    default: BST_LAUNCH(128); break;
  }
#undef BST_LAUNCH
  return (int)cudaGetLastError();
}
