// Symmetric merged-patch SpMM on Hopper (kernel B3 of the port).
//
// Replaces blocksparse_tpu/ops/patch_engine.py::_kern_mir (launched from
// _bucket_spmm_raw / patch_spmm for a symmetric plan).  A symmetric plan
// holds S = D + O + O^T with each stored off-diagonal block once; for every
// slot b, with V_b of shape [MP, KP], its KP/32 column chunks cc[b] and
// mk[b] leading chunks that hold off-diagonal blocks:
//   symmetric  Y[rs[b] : rs[b] + MP]  += V_b @ concat_j X[cc[b,j]*32 : +32]
//              Y[cc[b,j]*32 : +32]    += (V_b^T @ X[rs[b] : rs[b] + MP])[j*32 : +32]
//                                        for j < mk[b] only
//   adjoint    the transpose of that map (the backward pass's dX):
//              Y[cc[b,j]*32 : +32]    += (V_b^T @ X[rs[b] : rs[b] + MP])[j*32 : +32]
//              Y[rs[b] : rs[b] + MP]  += V_b @ concat_{j < mk[b]} X[cc[b,j]*32 : +32]
// Both products of a slot come from one shared-memory tile of V_b, so the
// values are read once for the two.  Chunks j >= mk[b] hold diagonal blocks:
// the mirrored product skips them (tile_core.cuh's ChunkPrefix predicate),
// else every diagonal block sharing a slot would add a spurious D^T.
// X and Y have the operand's n rows; sentinel chunks (id NC) read zero and
// their adds are dropped, as in patch_spmm.cu.
//
// What bounds it on the card: each value feeds 2r FMAs.  The mirror pass
// takes column tiles of 32 (tile_core.cuh), so V is read once per 32
// columns of X; at r = 64-128 the kernel sits between the CUDA-core FMA
// rate and those repeated reads of V.  A simple kernel first: plain fp32
// FMA, no TF32, no tensor cores.
//
// Race-freedom: slots run concurrently, and the row window of one slot may
// be the mirrored chunks of another, so every write to Y is an fp32
// atomicAdd into the zeroed output the wrapper allocated; the summation
// order varies between runs.  The TPU kernel kept Y resident and relied on
// an in-order grid.
#include "tile_core.cuh"

namespace {

constexpr int kCC = 32;  // column chunk width of the patch plan

template <int TR, bool ADJOINT>
__global__ void __launch_bounds__(bst::kThreads)
    patch_sym_kernel(const float* __restrict__ vals, const int* __restrict__ cc,
                     const int* __restrict__ rs, const int* __restrict__ mk,
                     const float* __restrict__ x, float* __restrict__ y,
                     int MP, int KP, int r, long long n) {
  const bst::WindowMap window{rs};
  const bst::ChunkMap chunks{cc, KP / kCC, kCC};
  const bst::ChunkPrefix mirrored{mk, kCC};
  if constexpr (ADJOINT)  // A = V^T: out rows are the chunks, in rows the window
    bst::tile_product<float, TR, true, true>(vals, MP, KP, chunks, window, x,
                                             n, y, n, r, bst::AllRows{},
                                             mirrored);
  else
    bst::tile_product<float, TR, false, true>(vals, MP, KP, window, chunks, x,
                                              n, y, n, r, mirrored,
                                              bst::AllRows{});
}

template <int TR>
void launch(dim3 grid, cudaStream_t s, bool adjoint, const float* vals,
            const int* cc, const int* rs, const int* mk, const float* x,
            float* y, int MP, int KP, int r, long long n) {
  if (adjoint)
    patch_sym_kernel<TR, true><<<grid, bst::kThreads, 0, s>>>(
        vals, cc, rs, mk, x, y, MP, KP, r, n);
  else
    patch_sym_kernel<TR, false><<<grid, bst::kThreads, 0, s>>>(
        vals, cc, rs, mk, x, y, MP, KP, r, n);
}

}  // namespace

// y ([n, r]) must be zeroed.  adjoint: 0 symmetric, 1 its transpose.
extern "C" int bst_patch_sym_f32(const float* vals, const int* cc,
                                 const int* rs, const int* mk, const float* x,
                                 float* y, int nb, int MP, int KP, int r,
                                 long long n, int adjoint, void* stream) {
  if (KP % kCC != 0) return (int)cudaErrorInvalidValue;
  if (nb <= 0 || r <= 0 || MP <= 0 || KP <= 0 || n <= 0) return 0;
  const int M = adjoint ? KP : MP;
  const int tr = bst::column_tile(r, true);
  const dim3 grid(nb * ((M + bst::kMT - 1) / bst::kMT), (r + tr - 1) / tr);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tr) {  // the mirror pass exists for column tiles of 1 and 32 only
    case 1: launch<1>(grid, s, adjoint != 0, vals, cc, rs, mk, x, y, MP, KP, r, n); break;
    case 32: launch<32>(grid, s, adjoint != 0, vals, cc, rs, mk, x, y, MP, KP, r, n); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
