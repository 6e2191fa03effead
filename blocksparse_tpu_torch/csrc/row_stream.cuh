// Row-stream body of kernel B1 (fused_spmm.cu) and of B9's element pass
// (mask_select.cu) at r = 1, one right-hand side, on Hopper.
//
// Replaces, for one column, the tile core (tile_core.cuh, TR == 1) that
// ports blocksparse_tpu/ops/pallas/fused_spmm.py::_kernel (B1, over a
// layout's chunked buckets) and blocksparse_tpu/ops/pallas/mask_select.py::
// _gather_kernel / _scatter_kernel (B9's element pass, over its element
// buckets).  It reads the same descriptor tables (BucketDesc) and computes
// the same three modes, with CONJ and every stored / compute pair:
//   forward    y[rows(b)] += V_b   x[cols(b)]
//   transpose  y[cols(b)] += V_b^T x[rows(b)]
//   symmetric  both, from one read of V_b
//
// What bounds it: at r = 1 each value is read once and feeds one
// multiply-add (four FMAs for a complex one), so the bytes of V are the
// whole cost.  The tile core staged V transposed through registers into a
// 64 x KT shared tile for an r > 1 register tile, then reduced four ways
// and added its rows, with no load in flight in that tail; at 16-byte
// compute types only one 256-thread block fit on an SM.  This body streams
// V in its stored row-major order in every mode and keeps the values in
// registers from load to FMA:
//
// - Work item: (stored block b, 64 stored rows m0 .. m0 + 63), numbered by
//   the forward numbering of the table (first[0]) in every mode: a
//   contiguous run of R x kp values (R = min(64, mp - m0)).  Persistent
//   blocks of 256 threads (8 warps), as many as the card holds at once
//   (three an SM at 4-byte compute types, else two: the __launch_bounds__
//   minimum, whose register cap holds a lane's eight loads, its row sums
//   and the next item's place), each walking items g, g + grid, ...  The
//   first loads of the next item are issued as soon as this item's FMAs
//   are done, so they fly while this item reduces and adds into y and
//   while the next item gathers x.
// - Lanes: a row of kp values is W load slots of 16 bytes (N elements
//   each), read by G lanes (G the power of two >= W, at most 32); a warp
//   reads 32 / G rows at a time, and lane (slot, c) of warp w reads slot
//   c (+ G, + 2G, ...) of rows w + 8 (slot + (32 / G) s): up to eight
//   16-byte loads in flight per lane, neighbouring lanes on neighbouring
//   16 bytes, each slot's 16 bytes held as raw bits and decoded where the
//   FMAs read them.  A run whose rows are not a multiple of 16 bytes or
//   whose values are not 16-byte aligned (bf16 blocks of odd kp, a column
//   of one) is read element by element into the same slots, zeros past
//   kp.
// - Gathered x: the forward reads x[cols(b)] from shared memory, staged
//   once per item (in chunks of kColChunk columns for deep blocks); the
//   transpose reads x[rows(b)] staged once per item, one value per lane
//   row.  The mapped indices are staged beside them, rows by the last two
//   warps while the others gather the columns, and the atomics read them
//   from shared memory.
// - Reductions: a forward row's partial sums are added across its G lanes
//   with warp shuffles and added into y once, by one lane.  A transposed
//   column's partial sums are added across the slots of a warp with
//   shuffles, then across the 8 warps through shared memory (one barrier
//   per G loads of a row, double-buffered), and added into y once per
//   column, as the tile core did.
//
// Race-freedom: blocks of a bucket share rows and columns, so every write
// to y is an atomic add (atomic_add: a complex value as two scalar
// atomics, each exact on its own part) into the output the wrapper zeroed
// or the partial sum of the launches before it; no kernel reads y.  The
// summation order varies from run to run, as the tile core's did.  Index
// rows outside [0, x_rows) read zero and rows outside [0, y_rows) are
// dropped (sentinels), as in the tile core.
#pragma once

#include <stdint.h>
#include <string.h>

#include "tile_core.cuh"

namespace bst {

constexpr int kRowWarps = kThreads / 32;    // 8
constexpr int kLaneRows = kMT / kRowWarps;  // an item's rows per lane, at most
constexpr int kColChunk = 1024;             // columns of x staged at once

// elements of the stored type in one 16-byte load
template <typename VS>
constexpr int kRowVec = 16 / (int)sizeof(VS);

__device__ __forceinline__ float shfl_xor(float v, int m) {
  return __shfl_xor_sync(0xffffffffu, v, m);
}
__device__ __forceinline__ double shfl_xor(double v, int m) {
  return __shfl_xor_sync(0xffffffffu, v, m);
}
template <typename R>
__device__ __forceinline__ cplx<R> shfl_xor(cplx<R> v, int m) {
  return cplx<R>(shfl_xor(v.re, m), shfl_xor(v.im, m));
}

// A load slot holds 16 bytes of V as raw bits, decoded element by element
// where the FMAs read them (no array of the stored type lives across the
// loads, so the slots stay in registers).  unpack: element e of a slot.
__device__ __forceinline__ unsigned word(const uint4& q, int i) {
  return i == 0 ? q.x : i == 1 ? q.y : i == 2 ? q.z : q.w;
}
template <typename VS>
__device__ __forceinline__ VS unpack(const uint4& q, int e);
template <>
__device__ __forceinline__ float unpack<float>(const uint4& q, int e) {
  return __uint_as_float(word(q, e));
}
template <>
__device__ __forceinline__ double unpack<double>(const uint4& q, int e) {
  return __hiloint2double((int)word(q, 2 * e + 1), (int)word(q, 2 * e));
}
template <>
__device__ __forceinline__ cplx<float> unpack<cplx<float>>(const uint4& q,
                                                          int e) {
  return cplx<float>(__uint_as_float(word(q, 2 * e)),
                     __uint_as_float(word(q, 2 * e + 1)));
}
template <>
__device__ __forceinline__ cplx<double> unpack<cplx<double>>(const uint4& q,
                                                            int) {
  return cplx<double>(__hiloint2double((int)q.y, (int)q.x),
                      __hiloint2double((int)q.w, (int)q.z));
}
template <>
__device__ __forceinline__ __nv_bfloat16 unpack<__nv_bfloat16>(const uint4& q,
                                                               int e) {
  return __ushort_as_bfloat16(
      (unsigned short)(word(q, e / 2) >> (16 * (e % 2))));
}

// The 16 bytes of one slot at p: one load that allocates no L1 line (each
// value is read once) where the run allows it (vec), else element by
// element (every element's bits at its place in the slot), zeros past the
// row's last column (n_live of the slot's elements lie in the row).  The L2
// keeps its default policy: an operator that fits in it stays there from
// one product to the next (an evict-first load lost that on a 2 MB
// block-Jacobi operator).
template <typename VS>
__device__ __forceinline__ uint4 load_slot(const VS* p, bool vec,
                                           int n_live) {
  if (vec) {
    uint4 q;
    asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
        : "=r"(q.x), "=r"(q.y), "=r"(q.z), "=r"(q.w)
        : "l"(p));
    return q;
  }
  constexpr int N = kRowVec<VS>;
  constexpr int WPE = 4 / N > 0 ? 4 / N : 1;  // words per element
  unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < N; ++e) {
    if (e >= n_live) continue;
    if constexpr (sizeof(VS) == 2) {
      w[e / 2] |= (unsigned)__bfloat16_as_ushort(p[e]) << (16 * (e % 2));
    } else {
      unsigned bits[4];
      memcpy(bits, p + e, sizeof(VS));
#pragma unroll
      for (int j = 0; j < WPE; ++j) w[e * WPE + j] = bits[j];
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// A lane's place in an item of rows of kp values: a row is W load slots,
// read by G lanes (the power of two >= W, at most 32); lane (slot, c) of
// warp w reads slot c (+ G, ...) of rows w + 8 (slot + NG s), NG = 32 / G.
struct RowLanes {
  int G, NG, slot, c;
  __device__ __forceinline__ RowLanes(int kp, int N, int lane) {
    const int W = (kp + N - 1) / N;
    G = 1;
    while (G < W && G < 32) G <<= 1;
    NG = 32 / G;
    slot = lane / G;
    c = lane % G;
  }
  __device__ __forceinline__ int row(int w, int s) const {
    return w + kRowWarps * (slot + NG * s);
  }
};

// A work item of a launch: rows m0 .. m0 + R - 1 of block b of a bucket,
// the run V of R x kp values (row stride kp); vec: 16-byte loads (kp a
// multiple of a slot's elements and the values aligned); live false past
// the launch's last item.
template <typename VS>
struct RowItem {
  const VS* V;
  const int* rtab;
  const int* ctab;
  int mp, kp, C, b, m0, R;
  bool vec, live;
};

template <typename VS>
__device__ __forceinline__ RowItem<VS> row_item_of(const DescTable& tab,
                                                   long long g,
                                                   long long items) {
  RowItem<VS> it{};
  it.live = g < items;
  if (!it.live) return it;
  long long item;
  const BucketDesc d = locate(tab, g, 0, item);
  it.mp = (int)d.mp;
  it.kp = (int)d.kp;
  it.C = (int)d.C;
  const int mtiles = (it.mp + kMT - 1) / kMT;
  it.b = (int)(item / mtiles);
  it.m0 = (int)(item % mtiles) * kMT;
  it.R = it.mp - it.m0 < kMT ? it.mp - it.m0 : kMT;
  it.rtab = d.row_tab;
  it.ctab = d.col_tab;
  it.V = static_cast<const VS*>(d.vals) +
         ((long long)it.b * it.mp + it.m0) * it.kp;
  it.vec = it.kp % kRowVec<VS> == 0 &&
           (reinterpret_cast<uintptr_t>(d.vals) & 15) == 0;
  return it;
}

// One step's loads of an item: slot u0 + c of each of the lane's rows in
// the column chunk from k0 (zeros past the item).
template <typename VS>
__device__ __forceinline__ void issue_slots(uint4 (&q)[kLaneRows],
                                            const RowItem<VS>& it,
                                            const RowLanes& L, int w, int k0,
                                            int u0) {
  constexpr int N = kRowVec<VS>;
  const int col = k0 + (u0 + L.c) * N;
  const bool live =
      col < k0 + (it.kp - k0 < kColChunk ? it.kp - k0 : kColChunk);
#pragma unroll
  for (int s = 0; s < kLaneRows; ++s) {
    const int i = L.row(w, s);
    q[s] = (live && i < it.R)
               ? load_slot<VS>(it.V + (long long)i * it.kp + col, it.vec,
                               it.kp - col)
               : make_uint4(0u, 0u, 0u, 0u);
  }
}

namespace {  // one copy per translation unit: B1 and B9 each instantiate it

// Persistent blocks over the table's work items (its forward numbering,
// first[0]): block j runs items j, j + gridDim.x, ...  MODE 0 forward, 1
// transpose, 2 symmetric.  Map: ChunkMap (B1) or ElemMap (B9's element
// pass).  FWD: the forward half (rows(b) += V x[cols(b)]); TRN: the
// transposed half (cols(b) += V^T x[rows(b)]).
template <typename VS, typename T, int MODE, bool CONJ, class Map>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 3 : 2)
    row_kernel(const DescTable tab, long long items, const T* __restrict__ x,
               T* __restrict__ y, long long x_rows, long long y_rows) {
  constexpr bool FWD = MODE != 1, TRN = MODE != 0;
  constexpr int N = kRowVec<VS>;
  __shared__ __align__(16) T xs[FWD ? kColChunk : 1];  // x[cols(b)], a chunk
  __shared__ T xr[TRN ? kMT : 1];                      // x[rows(b)]
  __shared__ T red[TRN ? 2 * kRowWarps * 32 * N : 1];  // column partials
  __shared__ int ri[kMT];                  // rows(b) of the item's rows
  __shared__ int ci[TRN ? kColChunk : 1];  // cols(b) of the chunk
  const int t = threadIdx.x, w = t >> 5, lane = t & 31;
  // a mapped index as staged: -1 (outside x and y) where it does not fit
  // an int, as no x or y of a launch is that long
  auto index = [](long long row) -> int {
    return (row >= 0 && row < 0x7fffffffLL) ? (int)row : -1;
  };
  auto load_x = [&](int row) -> T {
    return (row >= 0 && row < x_rows) ? x[row] : T(0);
  };
  auto add_y = [&](int row, T v) {
    if (row >= 0 && row < y_rows) atomic_add(&y[row], v);
  };
  uint4 q[kLaneRows];  // the lane's load slots of one step
  RowItem<VS> it = row_item_of<VS>(tab, blockIdx.x, items);
  issue_slots<VS>(q, it, RowLanes(it.kp, N, lane), w, 0, 0);
  for (long long g = blockIdx.x; g < items; g += gridDim.x) {
    // the first step of each item was issued during the item before
    const RowItem<VS> nx = row_item_of<VS>(tab, g + gridDim.x, items);
    const int kp = it.kp, b = it.b, m0 = it.m0, R = it.R;
    const Map rmap(it.rtab, it.mp, it.C), cmap(it.ctab, kp, it.C);
    const RowLanes L(kp, N, lane);
    __syncthreads();  // the last item's reads of the shared arrays are done
    // the item's rows: their indices (the forward adds into them) and x at
    // them (the transposed half), by the last two warps while the others
    // gather the columns
    if (const int i = t - (kThreads - kMT); i >= 0 && i < R) {
      ri[i] = index(rmap(b, m0 + i));
      if constexpr (TRN) xr[i] = load_x(ri[i]);
    }
    T racc[kLaneRows];
#pragma unroll
    for (int s = 0; s < kLaneRows; ++s) racc[s] = T(0);
    for (int k0 = 0; k0 < kp; k0 += kColChunk) {
      const int kc = kp - k0 < kColChunk ? kp - k0 : kColChunk;
      const int Wc = (kc + N - 1) / N;
      if (k0 > 0) __syncthreads();  // the last chunk's reads are done
      // the chunk's columns: x at them (the forward half) and their
      // indices (the transposed half adds into them)
      for (int k = t; k < Wc * N; k += kThreads) {
        const int col = k < kc ? index(cmap(b, k0 + k)) : -1;
        if constexpr (TRN) ci[k] = col;
        if constexpr (FWD) xs[k] = load_x(col);
      }
      __syncthreads();
      for (int u0 = 0; u0 < Wc; u0 += L.G) {
        if (k0 > 0 || u0 > 0) issue_slots<VS>(q, it, L, w, k0, u0);
        const int cv = u0 + L.c;
        T xv[N], cacc[N];
#pragma unroll
        for (int e = 0; e < N; ++e) {
          cacc[e] = T(0);
          if constexpr (FWD) xv[e] = xs[cv < Wc ? cv * N + e : 0];
        }
#pragma unroll
        for (int s = 0; s < kLaneRows; ++s) {
          const int i = L.row(w, s);
          T xl = T(0);
          if constexpr (TRN) xl = i < R ? xr[i] : T(0);
#pragma unroll
          for (int e = 0; e < N; ++e) {
            const T a = conj_if<CONJ>(Widen<T, VS>::of(unpack<VS>(q[s], e)));
            if constexpr (FWD) racc[s] = mac(a, xv[e], racc[s]);
            if constexpr (TRN) cacc[e] = mac(a, xl, cacc[e]);
          }
        }
        // the item's last step: the next item's loads fly during this
        // item's reductions and the next one's gathers
        if (nx.live && u0 + L.G >= Wc && k0 + kColChunk >= kp)
          issue_slots<VS>(q, nx, RowLanes(nx.kp, N, lane), w, 0, 0);
        if constexpr (TRN) {
          // the warp's slots, then its 8 warps: one sum per column
          for (int m = 16; m >= L.G; m >>= 1) {
#pragma unroll
            for (int e = 0; e < N; ++e)
              cacc[e] = cacc[e] + shfl_xor(cacc[e], m);
          }
          T* rw = red + ((u0 / L.G) & 1) * (kRowWarps * 32 * N);
          if (L.slot == 0) {
#pragma unroll
            for (int e = 0; e < N; ++e) rw[w * 32 * N + L.c * N + e] = cacc[e];
          }
          __syncthreads();
          if (t < L.G * N) {
            T tot = T(0);
#pragma unroll
            for (int ww = 0; ww < kRowWarps; ++ww)
              tot = tot + rw[ww * 32 * N + t];
            if (u0 * N + t < kc) add_y(ci[u0 * N + t], tot);
          }
        }
      }
    }
    if constexpr (FWD) {
#pragma unroll
      for (int s = 0; s < kLaneRows; ++s) {
        T sum = racc[s];
        for (int m = L.G >> 1; m >= 1; m >>= 1) sum = sum + shfl_xor(sum, m);
        const int i = L.row(w, s);
        if (L.c == 0 && i < R) add_y(ri[i], sum);
      }
    }
    it = nx;
  }
}

// The persistent grid of an instance: as many blocks as the card holds at
// once (its SMs times the blocks an SM holds of this kernel), at most one
// per item; asked once per instance.
template <typename VS, typename T, int MODE, bool CONJ, class Map>
int row_grid(long long items) {
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per, row_kernel<VS, T, MODE, CONJ, Map>, kThreads, 0);
    resident = sms * (per > 0 ? per : 1);
  }
  return (int)(items < resident ? items : resident);
}

template <typename VS, typename T, bool CONJ, class Map>
void launch_row_mode(int mode, long long items, cudaStream_t s,
                     const DescTable& tab, const T* x, T* y, long long x_rows,
                     long long y_rows) {
  if (mode == 0)
    row_kernel<VS, T, 0, CONJ, Map>
        <<<row_grid<VS, T, 0, CONJ, Map>(items), kThreads, 0, s>>>(
            tab, items, x, y, x_rows, y_rows);
  else if (mode == 1)
    row_kernel<VS, T, 1, CONJ, Map>
        <<<row_grid<VS, T, 1, CONJ, Map>(items), kThreads, 0, s>>>(
            tab, items, x, y, x_rows, y_rows);
  else
    row_kernel<VS, T, 2, CONJ, Map>
        <<<row_grid<VS, T, 2, CONJ, Map>(items), kThreads, 0, s>>>(
            tab, items, x, y, x_rows, y_rows);
}

// mode: 0 forward, 1 transpose, 2 symmetric (needs x_rows == y_rows), plus
// kConj to read conj(V) (complex T); items: the table's forward work items
// (first[0] numbering) in every mode; r must be 1, x_rows and y_rows below
// 2^31 (indices are staged as int).  y is added into.
template <typename VS, typename T, class Map>
int launch_row_stream(const DescTable& tab, long long items, const T* x,
                      T* y, int r, long long x_rows, long long y_rows,
                      int mode, void* stream) {
  const bool conj = kComplex<T> && (mode & kConj) != 0;
  mode &= ~kConj;
  if (mode < 0 || mode > 2 || r != 1 || items < 0 || items > 0x7fffffffLL ||
      x_rows < 0 || x_rows > 0x7fffffffLL || y_rows < 0 ||
      y_rows > 0x7fffffffLL || (mode == 2 && x_rows != y_rows))
    return (int)cudaErrorInvalidValue;
  if (items == 0 || y_rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // a real T has no CONJ instance: both branches are the plain one
  if (conj)
    launch_row_mode<VS, T, kComplex<T>, Map>(mode, items, s, tab, x, y,
                                             x_rows, y_rows);
  else
    launch_row_mode<VS, T, false, Map>(mode, items, s, tab, x, y, x_rows,
                                       y_rows);
  return (int)cudaGetLastError();
}

}  // namespace

}  // namespace bst
