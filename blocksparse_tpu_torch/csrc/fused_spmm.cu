// Chunk-table block product on Hopper (kernel B1 of the port).
//
// Replaces blocksparse_tpu/ops/pallas/fused_spmm.py::_kernel (launched from
// chunked_block_apply).  For every stored block b of a chunked bucket:
//   forward    y[out_chunks(b)] += V_b   @ x[in_chunks(b)]
//   transpose  y[out_chunks(b)] += V_b^T @ x[in_chunks(b)]   (tables swapped
//              by the caller: out = column chunks, in = row chunks)
//   symmetric  forward, plus y[col chunks] += V_b^T @ x[row chunks] from the
//              same shared-memory tile of V_b (one read of the values)
// where a chunk table row lists C-aligned chunks of x / y.
//
// What bounds it on the card: SpMV (r = 1) streams each value once and does
// two flops per 4 or 8 bytes, so it is bound by the bytes of vals; at
// r = 64-128 each value feeds r FMAs and the CUDA-core FMA rate and the
// bytes of vals both matter.  The design (tile_core.cuh): one thread block
// per (block, 64-row output tile, RHS tile of 1, 32, 64 or 128 columns; an
// 8 x up-to-4 register tile per thread), the block loads its
// own chunk-table entries (the TPU kernel had them scalar-prefetched), stages
// V and the gathered x in shared memory, and adds its tile into y with
// atomics.  The TPU kernel's read-modify-write of y was race-free only
// because its grid ran in order; here every write to y is an atomicAdd into
// the zeroed output, so the summation order varies between runs.  Any r is
// taken directly, with no RHS slicing and no on-chip memory budget.
#include "tile_core.cuh"

namespace {

template <typename T, int TR, bool TRANS, bool MIRROR>
__global__ void __launch_bounds__(bst::kThreads)
    fused_spmm_kernel(const T* __restrict__ vals, const int* __restrict__ out_tab,
                      const int* __restrict__ in_tab, const T* __restrict__ x,
                      T* __restrict__ y, int mp, int kp, int C, int r,
                      long long x_rows, long long y_rows) {
  const int M = TRANS ? kp : mp;
  const int K = TRANS ? mp : kp;
  const bst::ChunkMap out_map{out_tab, M / C, C};
  const bst::ChunkMap in_map{in_tab, K / C, C};
  bst::tile_product<T, TR, TRANS, MIRROR>(vals, mp, kp, out_map, in_map, x,
                                          x_rows, y, y_rows, r);
}

// The mirror pass exists for column tiles <= 32 only: a symmetric launch
// with a wider tile is refused, not silently skipped.
template <typename T, int TR>
cudaError_t launch(dim3 grid, cudaStream_t s, int mode, const T* vals,
                   const int* out_tab, const int* in_tab, const T* x, T* y,
                   int mp, int kp, int C, int r, long long x_rows,
                   long long y_rows) {
  if (mode == 0)
    fused_spmm_kernel<T, TR, false, false><<<grid, bst::kThreads, 0, s>>>(
        vals, out_tab, in_tab, x, y, mp, kp, C, r, x_rows, y_rows);
  else if (mode == 1)
    fused_spmm_kernel<T, TR, true, false><<<grid, bst::kThreads, 0, s>>>(
        vals, out_tab, in_tab, x, y, mp, kp, C, r, x_rows, y_rows);
  else if constexpr (TR <= 32)
    fused_spmm_kernel<T, TR, false, true><<<grid, bst::kThreads, 0, s>>>(
        vals, out_tab, in_tab, x, y, mp, kp, C, r, x_rows, y_rows);
  else
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// mode: 0 forward, 1 transpose, 2 symmetric.  y must be zeroed.
template <typename T>
int run(const T* vals, const int* out_tab, const int* in_tab, const T* x,
        T* y, int nb, int mp, int kp, int C, int r, long long x_rows,
        long long y_rows, int mode, void* stream) {
  if (C <= 0 || mp % C != 0 || kp % C != 0 || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  if (nb <= 0 || r <= 0 || mp <= 0 || kp <= 0) return 0;
  const int M = mode == 1 ? kp : mp;
  const int tr = bst::column_tile(r, mode == 2);
  const dim3 grid(nb * ((M + bst::kMT - 1) / bst::kMT), (r + tr - 1) / tr);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
#define BST_LAUNCH(TRV)                                                   \
  err = launch<T, TRV>(grid, s, mode, vals, out_tab, in_tab, x, y, mp, kp, \
                       C, r, x_rows, y_rows)
  switch (tr) {
    case 1: BST_LAUNCH(1); break;
    case 32: BST_LAUNCH(32); break;
    case 64: BST_LAUNCH(64); break;
    default: BST_LAUNCH(128); break;
  }
#undef BST_LAUNCH
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int bst_fused_spmm_f32(const float* vals, const int* out_tab,
                                  const int* in_tab, const float* x, float* y,
                                  int nb, int mp, int kp, int C, int r,
                                  long long x_rows, long long y_rows, int mode,
                                  void* stream) {
  return run<float>(vals, out_tab, in_tab, x, y, nb, mp, kp, C, r, x_rows,
                    y_rows, mode, stream);
}

extern "C" int bst_fused_spmm_f64(const double* vals, const int* out_tab,
                                  const int* in_tab, const double* x,
                                  double* y, int nb, int mp, int kp, int C,
                                  int r, long long x_rows, long long y_rows,
                                  int mode, void* stream) {
  return run<double>(vals, out_tab, in_tab, x, y, nb, mp, kp, C, r, x_rows,
                     y_rows, mode, stream);
}

extern "C" const char* bst_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
