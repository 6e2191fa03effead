// Panel v2 SpMV on Hopper (kernel B10 of the port).
//
// Replaces blocksparse_tpu/ops/pallas/panel2_spmv.py::_k_fwd and ::_k_sym
// (launched from _launch) together with _gather_xs2's x gather and the
// map-back of the mirrored sums.  The operand is the v2 panel plan of
// core/panel2.py: vals [S*TS, 8, 128], rid8 / cid8 [S*TS] (row chunk - b8[s],
// RW = padding; compact chunk, CW = padding), segid [S, CW*NSEG] and, for
// mirror plans, tgt [S, CW*NSEG], with NSEG = 128 / seg, seg in {8, 16, 32}:
//
//   forward  y[(b8[s] + rid8)*8 + m] += sum_k V[m, k] * x[lane k]
//   mirror   y[target of lane k] += sum_m V[m, k] * x[(b8[s] + rid8)*8 + m]
//
// where lane k of compact chunk c in slab s reads segment
// g = segid[s, c*NSEG + k/seg] at x[g*seg + k%seg] (g = NC, the sentinel,
// and indices >= ncols read 0) and sends its mirrored sum to
// y[t*seg + k%seg] with t = tgt[s, c*NSEG + k/seg] (t = n_yseg, the
// sentinel, and indices >= nrows are dropped).  The pinned covers make every
// segment one plain run of x, so the gather needs no shifted grids; the
// TPU's [S, NSEG, CW] relayout of tgt and its in-kernel iota one-hots have
// no counterpart here.
//
// What bounds it on the card: every value is read once for 2 flops (4 in a
// mirror plan), so the plan's value bytes bound it; x and the id tables are
// small and stay in L2.  The design is B5's (tile_stream.cuh): one warp per
// run of tiles, float4 streaming loads, row sums carried in registers
// across the tiles of one row chunk; this file adds only its geometry.
//
// Race-freedom: as B5, every write to y is an fp32 atomicAdd into the zeroed
// output the wrapper allocates (warps run in no order, slabs overlap at
// their row-window edges, mirrored sums land anywhere); the summation order
// varies from run to run.
#include <cuda_runtime.h>

#include "tile_stream.cuh"

namespace {

struct Panel2Geo {
  const int* rid8;
  const int* cid8;
  const int* segid;
  const int* tgt;
  const int* b8;
  int CW, RW, nseg, seg_log2, NC, n_yseg;
  long long ncols, nrows;

  __device__ __forceinline__ long long row_chunk(int s, long long T) const {
    const int r = __ldg(rid8 + T);
    return r >= RW ? -1 : (long long)__ldg(b8 + s) + r;
  }
  // table entry of this lane's segment in slab s; lane owns lanes 4l..4l+3
  // of the tile, which never straddle a segment (seg >= 8)
  __device__ __forceinline__ long long entry(int s, long long T,
                                             int lane) const {
    const int c = __ldg(cid8 + T);
    return ((long long)s * CW + c) * nseg + ((4 * lane) >> seg_log2);
  }
  __device__ __forceinline__ int offset(int lane) const {
    return (4 * lane) & ((1 << seg_log2) - 1);
  }
  __device__ __forceinline__ void load_x(int s, long long T, int lane,
                                         const float* __restrict__ x,
                                         float (&xv)[4]) const {
    const int g = __ldg(segid + entry(s, T, lane));
    const long long base =
        g < NC ? ((long long)g << seg_log2) + offset(lane) : ncols;
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
    const int t = __ldg(tgt + entry(s, T, lane));
    if (t >= n_yseg) return;
    const long long base = ((long long)t << seg_log2) + offset(lane);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (base + j < nrows) atomicAdd(y + base + j, yt[j]);
  }
};

template <bool MIRROR>
__global__ void __launch_bounds__(bst::kStreamThreads)
    panel2_spmv_kernel(const float* __restrict__ vals, Panel2Geo geo,
                       const float* __restrict__ x, float* __restrict__ y,
                       long long ntiles, int TS, int tpw) {
  bst::stream_tiles<MIRROR>(vals, ntiles, TS, geo, x, y, geo.nrows, tpw);
}

}  // namespace

// y must be zeroed ([nrows] f32); tgt may be null unless mirror.
extern "C" int bst_panel2_spmv_f32(const float* vals, const int* rid8,
                                   const int* cid8, const int* segid,
                                   const int* tgt, const int* b8,
                                   const float* x, float* y, long long ntiles,
                                   int TS, int CW, int RW, int seg, int NC,
                                   long long ncols, long long nrows,
                                   int mirror, int tpw, void* stream) {
  int seg_log2 = 0;
  while ((1 << seg_log2) < seg) ++seg_log2;
  if (TS <= 0 || CW <= 0 || RW <= 0 || NC < 0 || tpw <= 0 ||
      (seg != 8 && seg != 16 && seg != 32) || (mirror && tgt == nullptr))
    return (int)cudaErrorInvalidValue;
  if (ntiles <= 0 || nrows <= 0) return 0;
  const int nseg = bst::kTileCols / seg;
  const int n_yseg = (int)((nrows + seg - 1) / seg);
  const Panel2Geo geo{rid8, cid8, segid, tgt, b8, CW, RW, nseg, seg_log2,
                      NC, n_yseg, ncols, nrows};
  const long long warps = (ntiles + tpw - 1) / tpw;
  const int per_block = bst::kStreamThreads / 32;
  const unsigned blocks = (unsigned)((warps + per_block - 1) / per_block);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mirror)
    panel2_spmv_kernel<true><<<blocks, bst::kStreamThreads, 0, s>>>(
        vals, geo, x, y, ntiles, TS, tpw);
  else
    panel2_spmv_kernel<false><<<blocks, bst::kStreamThreads, 0, s>>>(
        vals, geo, x, y, ntiles, TS, tpw);
  return (int)cudaGetLastError();
}
