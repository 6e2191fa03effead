// Panel SpMV on Hopper (kernels B5 and B6 of the port).
//
// Replaces blocksparse_tpu/ops/pallas/panel_spmv.py::_pkern_plain and
// ::_pkern_mirror (launched from _launch) together with the x gather and the
// mirror map-back around them.  The operand is the panel plan of
// core/panel.py: vals [S*TS, 8, 128] in the K-merged panel space,
// rid8 / cid8 [S*TS] (row chunk - b8[s], RW = padding; compact chunk, CW =
// padding), segid [S, CW*4] and, for mirror plans, otgt [S, CW*4].
//
//   plain   y[(b8[s] + rid8)*8 + m] += sum_k V[m, k] * x[lane k]
//   mirror  additionally y[lane k] += sum_m V[m, k] * x[(b8[s] + rid8)*8 + m]
//           for lanes whose segment has a mirror target
//
// where lane k of compact chunk c in slab s reads segment
// seg = segid[s, c*4 + k/32]: x[(seg % NC32)*32 + k%32 + g(seg / NC32)]
// with g the segment grid's shift, 0 for the sentinel seg == NG*NC32 and
// for indices >= ncols (the JAX gather rolls x and wraps the last segment
// to its front; the plan holds zero values on those lanes, so reading 0
// there is the same product and never reads out of bounds).  Mirror sums
// go to the same formula with otgt in place of segid (-1 = dropped: the
// diagonal blocks' and the padding's segments), rows >= nrows dropped --
// the JAX wrapper's one-hot map-back [S*CW*4, NG*NC32] and its per-grid
// pad-left, with no one-hot on the device.
//
// The kernel is the bulk-copy ring of panel_ring.cuh on V1Geo (segments of
// 32 lanes on the shifted grids; mirror targets from otgt), where its design,
// its race-freedom and its modes are described: persistent blocks over
// ranges of the tile stream, one producer warp feeding 1-D bulk copies of the
// live tiles and each stage's tables (read a stage ahead) into an mbarrier
// ring, eight consumer warps with row sums in registers, and a slab's mirror
// sums in shared memory (or, where CW leaves fewer than three stages, direct
// atomics; bst_panel_spmv_geometry reports the launch).  Kernel B10
// (panel2_spmv.cu) runs the same ring on the v2 plan.
//
// Kernel B6, bst_panel_spmv_batched_f32, is the same product for P
// operators that share one panel plan's id tables and differ in their values
// (vals [P, S*TS, 8, 128], x [P, ncols], y [P, nrows]).  It replaces
// blocksparse_tpu/ops/pallas/panel_spmv.py::_pkern_plain_b and
// ::_pkern_mirror_b together with _launch_batched's x gather and mirror
// map-back.  It runs the tile core of tile_stream.cuh (one warp per run of
// `tpw` tiles, float4 streaming loads, every sum an fp32 atomicAdd into
// the zeroed y): blockIdx.y = p offsets the values, x and y of product p,
// products never sharing an entry of y.  On the real-size batches the
// ring was slower (a product's stream is cut into a few blocks,
// each paying the ring's start-up).
#include <cuda_runtime.h>

#include "panel_ring.cuh"
#include "tile_stream.cuh"

namespace {

// -- kernel B6: the tile_stream.cuh core over P products ---------------------

struct PanelGeo {
  const int* rid8;
  const int* cid8;
  const int* segid;
  const int* otgt;
  const int* b8;
  long long grids;  // 5 bits per used grid's shift
  int CW, RW, NC32, ngrids;
  long long ncols, nrows;

  __device__ __forceinline__ long long row_chunk(int s, long long T) const {
    const int r = __ldg(rid8 + T);
    return r >= RW ? -1 : (long long)__ldg(b8 + s) + r;
  }
  __device__ __forceinline__ long long seg_base(int seg) const {
    const int gi = seg / NC32;
    return (long long)(seg % NC32) * 32 + ((grids >> (5 * gi)) & 31);
  }
  __device__ __forceinline__ void load_x(int s, long long T, int lane,
                                         const float* __restrict__ x,
                                         float (&xv)[4]) const {
    const int c = __ldg(cid8 + T);
    const int seg = __ldg(segid + ((long long)s * CW + c) * 4 + lane / 8);
    const long long base =
        seg < ngrids * NC32 ? seg_base(seg) + (4 * lane) % 32 : ncols;
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
    const int c = __ldg(cid8 + T);
    const int tgt = __ldg(otgt + ((long long)s * CW + c) * 4 + lane / 8);
    if (tgt < 0) return;
    const long long base = seg_base(tgt) + (4 * lane) % 32;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (base + j < nrows) atomicAdd(y + base + j, yt[j]);
  }
};

template <bool MIRROR>
__global__ void __launch_bounds__(bst::kStreamThreads)
    panel_spmv_batched_kernel(const float* __restrict__ vals, PanelGeo geo,
                              const float* __restrict__ x,
                              float* __restrict__ y, long long ntiles, int TS,
                              int tpw) {
  const long long p = blockIdx.y;
  bst::stream_tiles<MIRROR>(vals + p * ntiles * bst::kTileElems, ntiles, TS,
                            geo, x + p * geo.ncols, y + p * geo.nrows,
                            geo.nrows, tpw);
}

}  // namespace

// The geometry B5 launches with on the current card, as out = {stages,
// mode (0 plain, 1 mirror in shared memory, 2 mirror direct),
// shared-memory bytes, blocks, tiles per block, blocks per SM}.
extern "C" int bst_panel_spmv_geometry(long long ntiles, int CW, int mirror,
                                       long long* out) {
  return bst_ring::query<4>(ntiles, CW, mirror, out);
}

// y must be zeroed ([nrows] f32); otgt may be null unless mirror; vals
// 16-byte aligned.  tpb: tiles per block, 0 = the geometry's choice.
extern "C" int bst_panel_spmv_f32(const float* vals, const int* rid8,
                                  const int* cid8, const int* segid,
                                  const int* otgt, const int* b8,
                                  const float* x, float* y, long long ntiles,
                                  int TS, int CW, int RW, int NC32,
                                  int ngrids, long long grids,
                                  long long ncols, long long nrows,
                                  int mirror, long long tpb, void* stream) {
  if (TS <= 0 || CW <= 0 || RW <= 0 || NC32 <= 0 || ngrids <= 0 ||
      ngrids > 8 || tpb < 0 || (mirror && otgt == nullptr) ||
      !bst_tma::aligned16(vals) || ncols >= (1LL << 31) - 64 ||
      nrows >= (1LL << 31) - 64 || (long long)NC32 * 32 + 32 >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  bst_ring::Args a{};
  a.vals = vals, a.rid8 = rid8, a.cid8 = cid8, a.segid = segid;
  a.tgt = otgt, a.b8 = b8, a.x = x, a.y = y, a.ntiles = ntiles;
  a.grids = grids, a.ncols = (int)ncols, a.nrows = (int)nrows;
  a.TS = TS, a.CW = CW, a.RW = RW, a.NC32 = NC32, a.ngrids = ngrids;
  return bst_ring::launch<bst_ring::V1Geo>(a, mirror, tpb,
                                           static_cast<cudaStream_t>(stream));
}

// P products over one plan's tables; y must be zeroed ([P, nrows] f32).
extern "C" int bst_panel_spmv_batched_f32(
    const float* vals, const int* rid8, const int* cid8, const int* segid,
    const int* otgt, const int* b8, const float* x, float* y, int P,
    long long ntiles, int TS, int CW, int RW, int NC32, int ngrids,
    long long grids, long long ncols, long long nrows, int mirror, int tpw,
    void* stream) {
  if (TS <= 0 || CW <= 0 || RW <= 0 || NC32 <= 0 || ngrids <= 0 ||
      ngrids > 8 || tpw <= 0 || P > 65535 || (mirror && otgt == nullptr))
    return (int)cudaErrorInvalidValue;
  if (P <= 0 || ntiles <= 0 || nrows <= 0) return 0;
  const PanelGeo geo{rid8, cid8, segid, otgt, b8, grids, CW, RW, NC32,
                     ngrids, ncols, nrows};
  const long long warps = (ntiles + tpw - 1) / tpw;
  const int per_block = bst::kStreamThreads / 32;
  const dim3 grid((unsigned)((warps + per_block - 1) / per_block), P);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mirror)
    panel_spmv_batched_kernel<true><<<grid, bst::kStreamThreads, 0, s>>>(
        vals, geo, x, y, ntiles, TS, tpw);
  else
    panel_spmv_batched_kernel<false><<<grid, bst::kStreamThreads, 0, s>>>(
        vals, geo, x, y, ntiles, TS, tpw);
  return (int)cudaGetLastError();
}
