// Tile core of kernel B1 (fused_spmm.cu) and of B9's element pass
// (mask_select.cu): gather -> per-block GEMM tile -> atomic scatter-add, in
// IEEE fp32 / fp64 FMA at every precision tier.  (B2 runs wgmma + TMA in
// patch_spmm.cu; B3 and B4 the tensor-core core, tile_mma.cuh.)
//
// Element types: float, double, and the complex cplx<float> / cplx<double>
// (complex64 / complex128): interleaved {re, im} pairs, the layout of
// torch.view_as_real, so a complex tensor is passed as it is.  A complex
// multiply-add is four IEEE FMAs (mac).  CONJ (complex only) makes the
// kernel read conj(V): with the transpose mode it applies V^H, with the
// mirror mode conj(V) to both halves.  The launch carries it as bit kConj
// of the mode; for a real T that bit changes nothing.
//
// Stored and compute types: the values are read in their stored type V and
// widened to the compute type T once, in registers, while a stage is
// written to shared memory (Widen); x, y, the shared tiles and the sums are
// T.  V == T is the plain instance; the mixed ones are bf16 -> float and
// bf16 -> double (bf16 storage), float -> double and complex64 ->
// complex128 (a wider operand: the product is computed in the promoted
// type without a widened copy of the values in device memory).  The stage
// registers hold V, so a mixed instance holds no more of them than the
// plain instance of its stored type.
//
// Multi-bucket launches: one launch covers every bucket of a layout.  The
// wrapper passes a table of bucket descriptors (BucketDesc: the bucket's
// values, its row and column tables, its shape, chunk, block count and the
// number of its first work item); a work item is one (stored block, 64-row
// output tile), numbered bucket after bucket, and grid.x runs over all of
// them.  A thread block finds its bucket by a binary search over the first
// items (locate), then runs the per-block body below on the block and tile
// of its item.  A single-bucket launch passes its one descriptor by value
// (DescTable::one), so it needs no table in device memory.
//
// One thread block owns one (stored block b, 64-row output tile, column tile
// of TR right-hand-side columns).  It walks the contraction in stages of KT:
// each stage stages a [64, KT] tile of the block's operator (V or V^T),
// stored transposed so a thread's eight output rows are contiguous, and the
// gathered [KT, TR] rows of x in shared memory, then accumulates with IEEE
// fma in T (float, double or their complex pairs; no TF32 anywhere).  The next stage's global
// loads are issued into registers before the current stage computes, so
// their latency overlaps the FMAs.  For TR >= 32 each thread
// holds an 8 x TR/32 register tile.  The finished tile is added into y with
// atomicAdd: thread blocks run concurrently, and blocks of a population may
// share output rows, so every write to y is an atomic add into the zeroed
// output the wrapper allocated.  The summation order across blocks
// therefore varies from run to run.  A complex value is added as two scalar
// atomics, one on its real and one on its imaginary part: each part is a
// sum of its own, exact per component, so the argument holds unchanged (a
// reader between the two may see one part updated, but no kernel reads y).
//
// Row mapping is a functor per side: ChunkMap (B1: row i of block b lives at
// tab[b, i / C] * C + i % C) or ElemMap (B9: at tab[b, i]).  A gathered row
// outside [0, x_rows) reads zero and a scattered row outside [0, y_rows) is
// dropped: sentinel and padded lanes need no padded buffers, and a bad table
// cannot write outside y.
//
// MIRROR (TR <= 32, B1's symmetric mode) adds the transposed contribution
// of the same shared-memory tile (y[in rows] += A^T x[out rows]) for every
// row, one read of V feeding two products.
//
// STORE (B9's owner mode, owner_pass.cu) writes each finished row instead of
// adding it: the output is a scratch of one row per (block, row) (FlatMap),
// so every entry has exactly one writer and needs no atomic.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace bst {

constexpr int kThreads = 256;  // threads per block
constexpr int kMT = 64;        // output rows per block
constexpr int kPad = 4;        // row padding of the transposed A tile
constexpr int kConj = 4;       // mode bit: read conj(V)

// complex element: {re, im}, as torch.view_as_real lays it out
template <typename R>
struct __align__(2 * sizeof(R)) cplx {
  R re, im;
  cplx() = default;
  __host__ __device__ constexpr cplx(R r) : re(r), im(R(0)) {}
  __host__ __device__ constexpr cplx(R r, R i) : re(r), im(i) {}
  template <typename S>  // complex64 -> complex128
  __host__ __device__ constexpr explicit cplx(cplx<S> o)
      : re(R(o.re)), im(R(o.im)) {}
};

template <typename T>
constexpr bool kComplex = false;
template <typename R>
constexpr bool kComplex<cplx<R>> = true;

template <typename R>
__device__ __forceinline__ cplx<R> operator+(cplx<R> a, cplx<R> b) {
  return cplx<R>(a.re + b.re, a.im + b.im);
}

// acc + a * b: one IEEE FMA for a real T, four for a complex one
__device__ __forceinline__ float mac(float a, float b, float acc) {
  return fmaf(a, b, acc);
}
__device__ __forceinline__ double mac(double a, double b, double acc) {
  return fma(a, b, acc);
}
template <typename R>
__device__ __forceinline__ cplx<R> mac(cplx<R> a, cplx<R> b, cplx<R> acc) {
  return cplx<R>(mac(a.re, b.re, mac(-a.im, b.im, acc.re)),
                 mac(a.re, b.im, mac(a.im, b.re, acc.im)));
}

template <bool CONJ>
__device__ __forceinline__ float conj_if(float v) { return v; }
template <bool CONJ>
__device__ __forceinline__ double conj_if(double v) { return v; }
template <bool CONJ, typename R>
__device__ __forceinline__ cplx<R> conj_if(cplx<R> v) {
  return CONJ ? cplx<R>(v.re, -v.im) : v;
}

// a stored value V in the compute type T: exact for every pair the kernels
// instantiate (a bf16 or a float is a float or a double exactly)
template <typename T, typename V>
struct Widen {
  __device__ __forceinline__ static T of(V v) { return T(v); }
};
template <typename T>
struct Widen<T, __nv_bfloat16> {
  __device__ __forceinline__ static T of(__nv_bfloat16 v) {
    return T(__bfloat162float(v));
  }
};

template <typename V>
__device__ __forceinline__ V zero() { return V(0); }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __ushort_as_bfloat16(0);
}

// y += v: a complex value as two scalar atomics (see the header comment)
__device__ __forceinline__ void atomic_add(float* y, float v) { atomicAdd(y, v); }
__device__ __forceinline__ void atomic_add(double* y, double v) { atomicAdd(y, v); }
template <typename R>
__device__ __forceinline__ void atomic_add(cplx<R>* y, cplx<R> v) {
  atomicAdd(&y->re, v.re);
  atomicAdd(&y->im, v.im);
}

// Contraction depth per shared-memory stage, by element type and column-tile
// width.  The tiles are static shared memory (at most 48 KB): at 16-byte
// elements (complex128) the stages are shallower, so the A tile, the x stage
// and the mirror's x rows (64 x TR) fit: 44,544 bytes at TR = 1 and 45,568
// at TR = 32 in the mirror mode, where depth 64 / 32 would need 79,872 and
// 83,968.
template <typename T, int TR>
__host__ __device__ constexpr int stage_depth() {
  if (sizeof(T) >= 16) return TR == 1 ? 32 : 8;
  return TR == 1 ? 64 : (TR == 32 ? 32 : 16);
}

// Column-tile width for r right-hand-side columns of elem_bytes each.  At 16
// bytes the tile stops at 64 columns: a thread then holds 8 x 2 complex128
// accumulators (64 registers), where 128 columns would need 128.
inline int column_tile(int r, bool mirror, int elem_bytes) {
  if (r == 1) return 1;
  if (r <= 32 || mirror) return 32;
  return (r <= 64 || elem_bytes >= 16) ? 64 : 128;
}

// extent: rows of a block on this side; tab: [nblocks, extent / C]
struct ChunkMap {
  const int* tab;
  int per;  // chunks per block (row stride of the table)
  int C;
  __device__ __forceinline__ ChunkMap(const int* t, int extent, int c)
      : tab(t), per(extent / c), C(c) {}
  __device__ __forceinline__ long long operator()(int b, int i) const {
    return (long long)tab[(long long)b * per + i / C] * C + i % C;
  }
};

// tab: [nblocks, extent] element indices (the chunk argument is 1)
struct ElemMap {
  const int* tab;
  int per;
  __device__ __forceinline__ ElemMap(const int* t, int extent, int)
      : tab(t), per(extent) {}
  __device__ __forceinline__ long long operator()(int b, int i) const {
    return tab[(long long)b * per + i];
  }
};

// B9's owner products: row i of block b of a bucket at row base + b * M + i
// of a scratch that holds every (block, row) of every bucket in this
// direction (base: the bucket's first row; M: mp forward, kp transposed)
struct FlatMap {
  long long base;
  int M;
  __device__ __forceinline__ long long operator()(int b, int i) const {
    return base + (long long)b * M + i;
  }
};

// One bucket of a launch; the wrapper writes these as rows of an int64
// tensor [n, 9] (ops/kernels/fused_spmm.py::BucketTable).  first[0] numbers
// the work items of the forward and symmetric modes (M = mp), first[1]
// those of the transpose mode (M = kp).
struct BucketDesc {
  const void* vals;     // [nb, mp, kp] of the stored type V
  const int* row_tab;   // [nb, mp / C]
  const int* col_tab;   // [nb, kp / C]
  long long first[2];
  long long mp, kp, C, nb;
};
static_assert(sizeof(BucketDesc) == 72, "descriptor rows are 9 int64");

struct DescTable {
  const BucketDesc* dev;  // n descriptors in item order, or null: use one
  int n;
  BucketDesc one;
};

// The index of the bucket that owns work item g of a device table: the last
// whose first item is <= g.
__device__ __forceinline__ int locate_index(const DescTable& t, long long g,
                                            int side) {
  int lo = 0, hi = t.n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (t.dev[mid].first[side] <= g)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

// The bucket that owns work item g and the item's number inside it.
__device__ __forceinline__ BucketDesc locate(const DescTable& t, long long g,
                                             int side, long long& item) {
  if (t.dev == nullptr) {
    item = g;
    return t.one;
  }
  const BucketDesc d = t.dev[locate_index(t, g, side)];
  item = g - d.first[side];
  return d;
}

// A = V (TRANS false, [mp, kp]) or V^T (TRANS true, [kp, mp]) of block b;
// item = b * ceil(M / kMT) + (output tile).  grid: y = ceil(r / TR); block:
// kThreads.  VS: the stored type of the values, T the compute type.  STORE:
// write each output entry instead of adding it (see the header).
template <typename VS, typename T, int TR, bool TRANS, bool MIRROR, bool CONJ,
          class OutMap, class InMap, bool STORE = false>
__device__ __forceinline__ void tile_product(
    const VS* __restrict__ vals, int mp, int kp, OutMap out_row,
    InMap in_row, const T* __restrict__ x, long long x_rows,
    T* __restrict__ y, long long y_rows, int r, long long item) {
  static_assert(TR == 1 || TR == 32 || TR == 64 || TR == 128,
                "column tile is 1, 32, 64 or 128");
  static_assert(!MIRROR || TR <= 32, "mirror pass takes column tiles <= 32");
  static_assert(!(MIRROR && STORE), "a stored tile has one writer per entry");
  constexpr int KT = stage_depth<T, TR>();
  const int M = TRANS ? kp : mp;  // output extent of A
  const int K = TRANS ? mp : kp;  // contraction extent
  const int mtiles = (M + kMT - 1) / kMT;
  const int b = (int)(item / mtiles);
  const int m0 = (int)(item % mtiles) * kMT;
  const int c0 = blockIdx.y * TR;
  const int t = threadIdx.x;
  const VS* V = vals + (long long)b * mp * kp;

  __shared__ __align__(16) T At[KT][kMT + kPad];  // At[k][m] = A[m0 + m][k0 + k]
  __shared__ T Xs[KT][TR];
  __shared__ T Xr[MIRROR ? kMT : 1][TR];

  auto load_x = [&](long long row, int c) -> T {
    return (row >= 0 && row < x_rows && c0 + c < r) ? x[row * r + c0 + c]
                                                    : T(0);
  };
  auto add_y = [&](long long row, int c, T v) {
    if (row < 0 || row >= y_rows || c0 + c >= r) return;
    if constexpr (STORE)
      y[row * r + c0 + c] = v;
    else
      atomic_add(&y[row * r + c0 + c], v);
  };

  if constexpr (MIRROR) {
    for (int idx = t; idx < kMT * TR; idx += kThreads) {
      const int mi = idx / TR, c = idx % TR;
      Xr[mi][c] = m0 + mi < M ? load_x(out_row(b, m0 + mi), c) : T(0);
    }
  }

  // TR >= 32: thread (lane cl, row group rg) owns rows rg*8 .. rg*8+7 and
  // columns cl + 32 j
  constexpr int CJ = TR >= 32 ? TR / 32 : 1;
  constexpr int RI = 8;
  const int cl = t % 32, rg = t / 32;
  T acc[TR == 1 ? 1 : RI][CJ];
#pragma unroll
  for (int i = 0; i < (TR == 1 ? 1 : RI); ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc[i][j] = T(0);

  // Stage A[m0:m0+kMT, k0:k0+KT] and the gathered x rows through registers:
  // element idx of the A tile is (a_m, a_k), chosen so neighbouring threads
  // read neighbouring addresses of V in both orientations.
  constexpr int NA = kMT * KT / kThreads;
  constexpr int NX = (KT * TR + kThreads - 1) / kThreads;
  static_assert(NA * kThreads == kMT * KT, "A tile must split evenly");
  auto a_m = [](int idx) { return TRANS ? idx % kMT : idx / KT; };
  auto a_k = [](int idx) { return TRANS ? idx / kMT : idx % KT; };
  VS ra[NA];  // the stored type: widened when the stage is written
  T rx[NX];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int q = 0; q < NA; ++q) {
      const int idx = t + q * kThreads;
      const int m = m0 + a_m(idx), k = k0 + a_k(idx);
      // 32-bit offsets inside one block's tile (mp * kp < 2^31): fewer
      // registers, so more blocks per SM
      ra[q] = (m < M && k < K) ? V[TRANS ? k * kp + m : m * kp + k]
                                : zero<VS>();
    }
#pragma unroll
    for (int q = 0; q < NX; ++q) {
      const int idx = t + q * kThreads;
      const int k = k0 + idx / TR;
      rx[q] = (idx < KT * TR && k < K) ? load_x(in_row(b, k), idx % TR) : T(0);
    }
  };
  fetch(0);

  for (int k0 = 0; k0 < K; k0 += KT) {
#pragma unroll
    for (int q = 0; q < NA; ++q) {
      const int idx = t + q * kThreads;
      At[a_k(idx)][a_m(idx)] = conj_if<CONJ>(Widen<T, VS>::of(ra[q]));
    }
#pragma unroll
    for (int q = 0; q < NX; ++q) {
      const int idx = t + q * kThreads;
      if (idx < KT * TR) Xs[idx / TR][idx % TR] = rx[q];
    }
    __syncthreads();
    // issue the next stage's global loads; they land while this stage computes
    if (k0 + KT < K) fetch(k0 + KT);

    if constexpr (TR == 1) {
      const int mi = t % kMT, kq = t / kMT;  // four quarters of the stage
#pragma unroll
      for (int j = 0; j < KT / 4; ++j) {
        const int kj = kq * (KT / 4) + j;
        acc[0][0] = mac(At[kj][mi], Xs[kj][0], acc[0][0]);
      }
    } else {
#pragma unroll 4
      for (int kj = 0; kj < KT; ++kj) {
        T a[RI], bx[CJ];
#pragma unroll
        for (int i = 0; i < RI; ++i) a[i] = At[kj][rg * RI + i];
#pragma unroll
        for (int j = 0; j < CJ; ++j) bx[j] = Xs[kj][cl + 32 * j];
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < CJ; ++j) acc[i][j] = mac(a[i], bx[j], acc[i][j]);
      }
    }

    if constexpr (MIRROR) {
      // this stage's transposed contribution: yt[kj] = sum_mi A[mi][kj] xr[mi]
      if constexpr (TR == 1) {
        constexpr int G = kThreads / KT;  // row groups
        constexpr int ROWS = kMT / G;
        __shared__ T Red[G][KT];
        const int kj = t % KT, g = t / KT;
        T s = T(0);
#pragma unroll
        for (int j = 0; j < ROWS; ++j)
          s = mac(At[kj][g * ROWS + j], Xr[g * ROWS + j][0], s);
        Red[g][kj] = s;
        __syncthreads();
        if (t < KT && k0 + t < K) {
          T tot = T(0);
#pragma unroll
          for (int gg = 0; gg < G; ++gg) tot = tot + Red[gg][t];
          add_y(in_row(b, k0 + t), 0, tot);
        }
      } else {
        constexpr int RG = kThreads / TR;
        const int c = t % TR, kg = t / TR;
#pragma unroll
        for (int i = 0; i < KT / RG; ++i) {
          const int kj = kg + RG * i;
          T s = T(0);
          for (int mi = 0; mi < kMT; ++mi) s = mac(At[kj][mi], Xr[mi][c], s);
          if (k0 + kj < K) add_y(in_row(b, k0 + kj), c, s);
        }
      }
    }
    __syncthreads();
  }

  if constexpr (TR == 1) {
    __shared__ T Part[4][kMT];
    const int mi = t % kMT, kq = t / kMT;
    Part[kq][mi] = acc[0][0];
    __syncthreads();
    if (t < kMT && m0 + t < M) {
      const T s = Part[0][t] + Part[1][t] + Part[2][t] + Part[3][t];
      add_y(out_row(b, m0 + t), 0, s);
    }
  } else {
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int m = m0 + rg * RI + i;
      if (m < M) {
        const long long row = out_row(b, m);
#pragma unroll
        for (int j = 0; j < CJ; ++j) add_y(row, cl + 32 * j, acc[i][j]);
      }
    }
  }
}

namespace {  // one copy per translation unit: B1 and B9 each instantiate it

// Every work item of the table's buckets (grid.x) x column tiles (grid.y);
// Map is ChunkMap (B1) or ElemMap (B9's element pass).  At r = 1 in fp32
// the kernel streams V with one stage of loads in flight per block, so it
// asks for three blocks per SM (at most 80 registers a thread) to keep
// enough bytes in flight for HBM.
template <typename VS, typename T, int TR, bool TRANS, bool MIRROR, bool CONJ,
          class Map>
__global__ void __launch_bounds__(kThreads,
                                  TR == 1 && sizeof(T) == 4 ? 3 : 1)
    bucket_kernel(const DescTable tab, const T* __restrict__ x,
                  T* __restrict__ y, int r, long long x_rows,
                  long long y_rows) {
  long long item;
  const BucketDesc d = locate(tab, blockIdx.x, TRANS ? 1 : 0, item);
  const int mp = (int)d.mp, kp = (int)d.kp, C = (int)d.C;
  const Map out_map(TRANS ? d.col_tab : d.row_tab, TRANS ? kp : mp, C);
  const Map in_map(TRANS ? d.row_tab : d.col_tab, TRANS ? mp : kp, C);
  tile_product<VS, T, TR, TRANS, MIRROR, CONJ>(
      static_cast<const VS*>(d.vals), mp, kp, out_map, in_map, x, x_rows, y,
      y_rows, r, item);
}

// The mirror pass exists for column tiles <= 32 only: a symmetric launch
// with a wider tile is refused, not silently skipped.
template <typename VS, typename T, int TR, bool CONJ, class Map>
cudaError_t launch_tile(dim3 grid, cudaStream_t s, int mode,
                        const DescTable& tab, const T* x, T* y, int r,
                        long long x_rows, long long y_rows) {
  if (mode == 0)
    bucket_kernel<VS, T, TR, false, false, CONJ, Map>
        <<<grid, kThreads, 0, s>>>(tab, x, y, r, x_rows, y_rows);
  else if (mode == 1)
    bucket_kernel<VS, T, TR, true, false, CONJ, Map>
        <<<grid, kThreads, 0, s>>>(tab, x, y, r, x_rows, y_rows);
  else if constexpr (TR <= 32)
    bucket_kernel<VS, T, TR, false, true, CONJ, Map>
        <<<grid, kThreads, 0, s>>>(tab, x, y, r, x_rows, y_rows);
  else
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// The instance of column tile tr; a 16-byte T has no 128-column instance
// (column_tile never picks it).
template <typename VS, typename T, bool CONJ, class Map>
cudaError_t launch_width(int tr, dim3 grid, cudaStream_t s, int mode,
                         const DescTable& tab, const T* x, T* y, int r,
                         long long x_rows, long long y_rows) {
  switch (tr) {
    case 1: return launch_tile<VS, T, 1, CONJ, Map>(grid, s, mode, tab, x, y, r, x_rows, y_rows);
    case 32: return launch_tile<VS, T, 32, CONJ, Map>(grid, s, mode, tab, x, y, r, x_rows, y_rows);
    case 64: return launch_tile<VS, T, 64, CONJ, Map>(grid, s, mode, tab, x, y, r, x_rows, y_rows);
    default:
      if constexpr (sizeof(T) < 16)
        return launch_tile<VS, T, 128, CONJ, Map>(grid, s, mode, tab, x, y, r, x_rows, y_rows);
      else
        return cudaErrorInvalidValue;
  }
}

// mode: 0 forward, 1 transpose, 2 symmetric (needs x_rows == y_rows), plus
// kConj to read conj(V) (complex T; nothing changes for a real one);
// items: the table's work items in that mode's numbering.  y must be zeroed
// or hold a partial sum: the kernel adds into it.  The values are of the
// stored type VS (every descriptor of the table), x and y of T.
template <typename VS, typename T, class Map>
int launch_buckets(const DescTable& tab, long long items, const T* x, T* y,
                   int r, long long x_rows, long long y_rows, int mode,
                   void* stream) {
  const bool conj = kComplex<T> && (mode & kConj) != 0;
  mode &= ~kConj;
  if (mode < 0 || mode > 2 || items < 0 || items > 0x7fffffffLL ||
      (mode == 2 && x_rows != y_rows))
    return (int)cudaErrorInvalidValue;
  if (items == 0 || r <= 0 || y_rows == 0) return 0;
  const int tr = column_tile(r, mode == 2, (int)sizeof(T));
  const dim3 grid((unsigned)items, (r + tr - 1) / tr);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // a real T has no CONJ instance: both branches are the plain one
  const cudaError_t err =
      conj ? launch_width<VS, T, kComplex<T>, Map>(tr, grid, s, mode, tab, x,
                                                   y, r, x_rows, y_rows)
           : launch_width<VS, T, false, Map>(tr, grid, s, mode, tab, x, y, r,
                                             x_rows, y_rows);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

}  // namespace bst
