// Shared tile core of the port's two one-launch SpMV kernels (panel_spmv.cu,
// kernel B5; slab_spmv.cu, kernel B8): the whole operand streams once as
// [8, 128] f32 tiles, each tile adds V @ x[its 128 lanes] into 8 rows of y
// and, in a mirror plan, V^T @ x[its 8 rows] into the y entries of its
// lanes.  The two kernels differ only in their geometry functor: how a
// tile's lanes map to x (and the mirrored sums back to y) and how its row
// chunk is found.
//
// Work split: one warp per run of `tpw` consecutive tiles of the flattened
// [S * TS] stream.  Lane l owns columns 4l .. 4l+3 of every tile: it reads
// one float4 from each of the tile's 8 rows (the warp reads each 512-byte
// row with one coalesced request; the values are streamed with evict-first
// loads) and four x values, and keeps eight per-row partial sums in
// registers.  The plans sort tiles by row chunk inside a slab, so the sums
// carry over consecutive tiles of one row chunk and the warp flushes them
// only when the row chunk changes: a transposing butterfly (9 shuffles)
// leaves row (lane >> 2) & 7's total in lanes with lane % 4 == 0.
//
// Race-freedom: the TPU kernels accumulated into one output in grid order.
// Here warps run in no order, slabs overlap at their row-window edges, runs
// of one row chunk may span warps, and mirrored sums land anywhere, so
// every write to y is an fp32 atomicAdd into the zeroed output the wrapper
// allocates; the summation order varies from run to run.  `tpw` changes
// which sums meet in registers and which in atomics (tpw = 1 flushes every
// tile), which the on-card duality check uses.
//
// Padding tiles (the geometry returns row chunk -1) are skipped without
// reading their values; rows >= nrows and x/y indices outside [0, n) are
// dropped or read 0, so no padded buffers are needed.
#pragma once

#include <cuda_runtime.h>

namespace bst {

constexpr int kTileRows = 8;
constexpr int kTileCols = 128;
constexpr int kTileElems = kTileRows * kTileCols;
constexpr int kStreamThreads = 256;  // 8 warps per block

// Reduce a[0..7] across the warp; returns row ((lane >> 2) & 7)'s total in
// the lanes with lane % 4 == 0 (partial sums elsewhere).
__device__ __forceinline__ float warp_rows_total(const float (&a)[kTileRows],
                                                 int lane) {
  const unsigned full = 0xffffffffu;
  const bool u16 = lane & 16, u8 = lane & 8, u4 = lane & 4;
  float b[4], c[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float send = u16 ? a[i] : a[i + 4];
    const float keep = u16 ? a[i + 4] : a[i];
    b[i] = keep + __shfl_xor_sync(full, send, 16);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float send = u8 ? b[i] : b[i + 2];
    const float keep = u8 ? b[i + 2] : b[i];
    c[i] = keep + __shfl_xor_sync(full, send, 8);
  }
  float d = (u4 ? c[1] : c[0]) + __shfl_xor_sync(full, u4 ? c[0] : c[1], 4);
  d += __shfl_xor_sync(full, d, 2);
  d += __shfl_xor_sync(full, d, 1);
  return d;
}

// Geo provides, for flattened tile T of slab s:
//   long long row_chunk(int s, long long T)        -1 for a padding tile
//   void load_x(int s, long long T, int lane, const float* x, float (&xv)[4])
//   float mirror_weight(int s, long long T)         0 skips the mirror
//   void mirror_add(int s, long long T, int lane, const float (&yt)[4],
//                   float* y)
template <bool MIRROR, class Geo>
__device__ __forceinline__ void stream_tiles(const float* __restrict__ vals,
                                             long long ntiles, int TS,
                                             const Geo& geo,
                                             const float* __restrict__ x,
                                             float* __restrict__ y,
                                             long long nrows, int tpw) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long T0 = warp * tpw;
  if (T0 >= ntiles) return;
  const long long T1 = T0 + tpw < ntiles ? T0 + tpw : ntiles;

  float acc[kTileRows];
#pragma unroll
  for (int m = 0; m < kTileRows; ++m) acc[m] = 0.f;
  long long cur = -1;
  auto flush = [&]() {
    const float tot = warp_rows_total(acc, lane);
    const long long row = cur * kTileRows + ((lane >> 2) & 7);
    if ((lane & 3) == 0 && row < nrows) atomicAdd(y + row, tot);
#pragma unroll
    for (int m = 0; m < kTileRows; ++m) acc[m] = 0.f;
  };

  for (long long T = T0; T < T1; ++T) {
    const int s = (int)(T / TS);
    const long long rc = geo.row_chunk(s, T);
    if (rc < 0) continue;  // padding tile: uniform across the warp
    if (rc != cur) {
      if (cur >= 0) flush();
      cur = rc;
    }
    const float4* V =
        reinterpret_cast<const float4*>(vals + T * kTileElems) + lane;
    float4 v[kTileRows];
#pragma unroll
    for (int m = 0; m < kTileRows; ++m) v[m] = __ldcs(V + m * (kTileCols / 4));
    float xv[4];
    geo.load_x(s, T, lane, x, xv);
#pragma unroll
    for (int m = 0; m < kTileRows; ++m) {
      float t = acc[m];
      t = fmaf(v[m].x, xv[0], t);
      t = fmaf(v[m].y, xv[1], t);
      t = fmaf(v[m].z, xv[2], t);
      t = fmaf(v[m].w, xv[3], t);
      acc[m] = t;
    }
    if constexpr (MIRROR) {
      const float w = geo.mirror_weight(s, T);
      if (w != 0.f) {
        float yt[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int m = 0; m < kTileRows; ++m) {
          const long long row = rc * kTileRows + m;
          const float xr = row < nrows ? __ldg(x + row) * w : 0.f;
          yt[0] = fmaf(v[m].x, xr, yt[0]);
          yt[1] = fmaf(v[m].y, xr, yt[1]);
          yt[2] = fmaf(v[m].z, xr, yt[2]);
          yt[3] = fmaf(v[m].w, xr, yt[3]);
        }
        geo.mirror_add(s, T, lane, yt, y);
      }
    }
  }
  if (cur >= 0) flush();
}

}  // namespace bst
