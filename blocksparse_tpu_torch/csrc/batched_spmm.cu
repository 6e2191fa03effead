// Batched merged-patch SpMM on Hopper (kernel B4 of the port).
//
// Replaces blocksparse_tpu/ops/batched.py::_kern_batched (launched from
// _batched_raw under batched_mm): P same-structure patch SpMMs in one
// launch.  The P operators share one patch plan's tables -- cc [nb, KP/32]
// and rs [nb] -- and differ only in their values, stacked [P, nb, MP, KP].
// For every product p and slot b:
//   forward    Y[p, rs[b] : rs[b] + MP] += V[p, b] @ concat_j X[p, cc[b, j]*32 : +32]
//   transpose  the 32-row chunks cc[b, j] of Y[p] += V[p, b]^T @ X[p, rs[b] : +MP]
// (the transpose mode is the backward's dX).  X is [P, x_rows, r] and Y
// [P, y_rows, r]; rows past X's end read zero and rows past Y's end are
// dropped, so the JAX wrapper's padding of X and Y to the plan's padded row
// counts is not needed.
//
// What bounds it on the card: as kernel B2 (patch_spmm.cu), each value feeds
// r FMAs, so at r = 64-128 it sits between the bytes of the P value stacks
// and the CUDA-core fp32 FMA rate.  The design: B2's tile core
// (tile_core.cuh) with a third grid dimension, blockIdx.z = p, that offsets
// the values, X and Y of product p; one launch covers all P products, so
// the card is filled P times wider than by one product and P - 1 launches
// of host overhead go away.  The TPU kernel prefetched product p+1's slabs
// under product p's compute in an in-order grid; here the products' blocks
// simply run side by side.
//
// Race-freedom: slots of one product may share output rows and blocks run
// in no order, so every write to Y is an fp32 atomicAdd into the zeroed
// output the wrapper allocates, as in B2; products never share a row of Y.
// The summation order varies from run to run.
#include "tile_core.cuh"

namespace {

constexpr int kCC = 32;  // column chunk width of the patch plan

template <int TR, bool TRANS>
__global__ void __launch_bounds__(bst::kThreads)
    batched_spmm_kernel(const float* __restrict__ vals,
                        const int* __restrict__ cc, const int* __restrict__ rs,
                        const float* __restrict__ x, float* __restrict__ y,
                        int nb, int MP, int KP, int r, long long x_rows,
                        long long y_rows) {
  const long long p = blockIdx.z;
  const float* V = vals + p * nb * MP * KP;
  const float* X = x + p * x_rows * r;
  float* Y = y + p * y_rows * r;
  const bst::WindowMap window{rs};
  const bst::ChunkMap chunks{cc, KP / kCC, kCC};
  if constexpr (TRANS)
    bst::tile_product<float, TR, true, false>(V, MP, KP, chunks, window, X,
                                              x_rows, Y, y_rows, r);
  else
    bst::tile_product<float, TR, false, false>(V, MP, KP, window, chunks, X,
                                               x_rows, Y, y_rows, r);
}

template <int TR>
void launch(dim3 grid, cudaStream_t s, bool transpose, const float* vals,
            const int* cc, const int* rs, const float* x, float* y, int nb,
            int MP, int KP, int r, long long x_rows, long long y_rows) {
  if (transpose)
    batched_spmm_kernel<TR, true><<<grid, bst::kThreads, 0, s>>>(
        vals, cc, rs, x, y, nb, MP, KP, r, x_rows, y_rows);
  else
    batched_spmm_kernel<TR, false><<<grid, bst::kThreads, 0, s>>>(
        vals, cc, rs, x, y, nb, MP, KP, r, x_rows, y_rows);
}

}  // namespace

// y must be zeroed ([P, y_rows, r] f32).  transpose: 0 forward, 1 transpose.
extern "C" int bst_batched_spmm_f32(const float* vals, const int* cc,
                                    const int* rs, const float* x, float* y,
                                    int P, int nb, int MP, int KP, int r,
                                    long long x_rows, long long y_rows,
                                    int transpose, void* stream) {
  if (KP % kCC != 0 || P > 65535) return (int)cudaErrorInvalidValue;
  if (P <= 0 || nb <= 0 || r <= 0 || MP <= 0 || KP <= 0 || y_rows <= 0)
    return 0;
  const int M = transpose ? KP : MP;
  const int tr = bst::column_tile(r, false);
  const dim3 grid(nb * ((M + bst::kMT - 1) / bst::kMT), (r + tr - 1) / tr, P);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BST_LAUNCH(TRV)                                                    \
  launch<TRV>(grid, s, transpose != 0, vals, cc, rs, x, y, nb, MP, KP, r, \
              x_rows, y_rows)
  switch (tr) {
    case 1: BST_LAUNCH(1); break;
    case 32: BST_LAUNCH(32); break;
    case 64: BST_LAUNCH(64); break;
    default: BST_LAUNCH(128); break;
  }
#undef BST_LAUNCH
  return (int)cudaGetLastError();
}
