// Slab SpMV on Hopper (kernel B8 of the port).
//
// Replaces blocksparse_tpu/ops/pallas/slab_spmv.py::_kernel_plain,
// ::_kernel_mirror and their core-split variants ::_kernel_plain_mc,
// ::_kernel_mirror_mc (the same function with the slabs split across TPU
// cores).  The operand is the slab plan of core/strip.py: vals
// [S*TS, 8, 128] in real column coordinates; the wrapper turns the plan's
// one-hots rs [S, RW, TS] and cs [S, TS, NC] into per-tile ids once, at
// staging: rid8 [S*TS] (row chunk - b8[s], RW = padding) and cid [S*TS]
// (column chunk), with flag [S*TS] the mirror flag.
//
//   plain   y[(b8[s] + rid8)*8 + m] += sum_k V[m, k] * x[cid*128 + k]
//   mirror  additionally y[cid*128 + k] += flag * sum_m V[m, k] *
//           x[(b8[s] + rid8)*8 + m]
//
// with x read as 0 past ncols and y rows >= nrows dropped (the JAX wrapper
// pads x to NC*128 and n8p*8 and cuts y to nrows).  The TPU kernels formed
// the gather and scatter as one-hot matrix products per slab; here each
// tile reads its own ids, so no one-hot reaches the device.
//
// What bounds it on the card: the bytes of vals, read once (2 flops per
// value, 4 in a mirror plan).  The TPU's core split kept a private output
// copy per core; Hopper's reading of it would be a private copy per thread
// block summed afterwards.  This kernel takes the simpler route of
// tile_stream.cuh instead: row sums in registers per run of tiles and fp32
// atomicAdd into a zeroed y.
#include <cuda_runtime.h>

#include "tile_stream.cuh"

namespace {

struct SlabGeo {
  const int* rid8;
  const int* cid;
  const float* flag;
  const int* b8;
  int RW;
  long long ncols, nrows;

  __device__ __forceinline__ long long row_chunk(int s, long long T) const {
    const int r = __ldg(rid8 + T);
    return r >= RW ? -1 : (long long)__ldg(b8 + s) + r;
  }
  __device__ __forceinline__ void load_x(int, long long T, int lane,
                                         const float* __restrict__ x,
                                         float (&xv)[4]) const {
    const long long base = (long long)__ldg(cid + T) * 128 + 4 * lane;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      xv[j] = base + j < ncols ? __ldg(x + base + j) : 0.f;
  }
  __device__ __forceinline__ float mirror_weight(int, long long T) const {
    return __ldg(flag + T);
  }
  __device__ __forceinline__ void mirror_add(int, long long T, int lane,
                                             const float (&yt)[4],
                                             float* __restrict__ y) const {
    const long long base = (long long)__ldg(cid + T) * 128 + 4 * lane;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (base + j < nrows) atomicAdd(y + base + j, yt[j]);
  }
};

template <bool MIRROR>
__global__ void __launch_bounds__(bst::kStreamThreads)
    slab_spmv_kernel(const float* __restrict__ vals, SlabGeo geo,
                     const float* __restrict__ x, float* __restrict__ y,
                     long long ntiles, int TS, int tpw) {
  bst::stream_tiles<MIRROR>(vals, ntiles, TS, geo, x, y, geo.nrows, tpw);
}

}  // namespace

// y must be zeroed ([nrows] f32); flag may be null unless mirror.
extern "C" int bst_slab_spmv_f32(const float* vals, const int* rid8,
                                 const int* cid, const float* flag,
                                 const int* b8, const float* x, float* y,
                                 long long ntiles, int TS, int RW,
                                 long long ncols, long long nrows, int mirror,
                                 int tpw, void* stream) {
  if (TS <= 0 || RW <= 0 || tpw <= 0 || (mirror && flag == nullptr))
    return (int)cudaErrorInvalidValue;
  if (ntiles <= 0 || nrows <= 0) return 0;
  const SlabGeo geo{rid8, cid, flag, b8, RW, ncols, nrows};
  const long long warps = (ntiles + tpw - 1) / tpw;
  const int per_block = bst::kStreamThreads / 32;
  const unsigned blocks = (unsigned)((warps + per_block - 1) / per_block);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mirror)
    slab_spmv_kernel<true><<<blocks, bst::kStreamThreads, 0, s>>>(
        vals, geo, x, y, ntiles, TS, tpw);
  else
    slab_spmv_kernel<false><<<blocks, bst::kStreamThreads, 0, s>>>(
        vals, geo, x, y, ntiles, TS, tpw);
  return (int)cudaGetLastError();
}
