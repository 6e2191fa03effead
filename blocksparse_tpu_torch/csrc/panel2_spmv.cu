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
// The kernel is B5's bulk-copy ring (panel_ring.cuh, where its design, its
// race-freedom and its modes are described) on V2Geo<seg>: persistent
// blocks over ranges of the tile stream, one producer warp feeding 1-D bulk
// copies of the live tiles (a slab's padding tiles trail its live ones, as
// in the v1 plan) and each stage's tables into an mbarrier ring -- here
// NSEG x and y bases per tile, loaded a stage ahead -- eight consumer warps
// with row sums in registers, and a slab's mirror sums in a [CW, 128]
// shared-memory accumulator flushed through tgt once per slab visit (or,
// where CW leaves fewer than three stages, direct atomics).  What bounds it:
// every value is read once for 2 flops (4 in a mirror plan), so the plan's
// live value bytes.  Every add into y is an fp32 atomic into the zeroed
// output the wrapper allocates; the summation order varies from run to run.
#include <cuda_runtime.h>

#include "panel_ring.cuh"

namespace {

int nseg_of(int seg) {
  return seg == 8 || seg == 16 || seg == 32 ? 128 / seg : 0;
}

}  // namespace

// The geometry B10 launches with on the current card for a plan of `seg`,
// as bst_panel_spmv_geometry reports B5's: out = {stages, mode, shared-memory
// bytes, blocks, tiles per block, blocks per SM}.
extern "C" int bst_panel2_spmv_geometry(long long ntiles, int CW, int seg,
                                        int mirror, long long* out) {
  switch (nseg_of(seg)) {
    case 16: return bst_ring::query<16>(ntiles, CW, mirror, out);
    case 8: return bst_ring::query<8>(ntiles, CW, mirror, out);
    case 4: return bst_ring::query<4>(ntiles, CW, mirror, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

// y must be zeroed ([nrows] f32); tgt may be null unless mirror; vals
// 16-byte aligned.  tpb: tiles per block, 0 = the geometry's choice.
extern "C" int bst_panel2_spmv_f32(const float* vals, const int* rid8,
                                   const int* cid8, const int* segid,
                                   const int* tgt, const int* b8,
                                   const float* x, float* y, long long ntiles,
                                   int TS, int CW, int RW, int seg, int NC,
                                   long long ncols, long long nrows,
                                   int mirror, long long tpb, void* stream) {
  if (TS <= 0 || CW <= 0 || RW <= 0 || NC < 0 || tpb < 0 || !nseg_of(seg) ||
      (mirror && tgt == nullptr) || !bst_tma::aligned16(vals) ||
      ncols >= (1LL << 31) - 64 || nrows >= (1LL << 31) - 64 ||
      (long long)NC * seg >= (1LL << 31) - 64)
    return (int)cudaErrorInvalidValue;
  bst_ring::Args a{};
  a.vals = vals, a.rid8 = rid8, a.cid8 = cid8, a.segid = segid, a.tgt = tgt;
  a.b8 = b8, a.x = x, a.y = y, a.ntiles = ntiles;
  a.ncols = (int)ncols, a.nrows = (int)nrows, a.TS = TS, a.CW = CW, a.RW = RW;
  a.NC = NC, a.n_yseg = (int)((nrows + seg - 1) / seg);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (seg) {
    case 8: return bst_ring::launch<bst_ring::V2Geo<8>>(a, mirror, tpb, s);
    case 16: return bst_ring::launch<bst_ring::V2Geo<16>>(a, mirror, tpb, s);
    default: return bst_ring::launch<bst_ring::V2Geo<32>>(a, mirror, tpb, s);
  }
}
