// B9's colored rounds: every color round of a colored plan summed in one
// launch, on Hopper.
//
// Replaces, with a products pass, the colored element chain of the JAX
// engine (blocksparse_tpu/ops/xla_spmv.py: one mask-select gather per
// bucket, blocksparse_tpu/ops/pallas/mask_select.py::_gather_kernel, an
// einsum per bucket, a concatenation, then one dense gather and one add
// per color; its backward ran ::_scatter_kernel), dispatched at
// blocksparse_tpu/ops/dispatch.py.  The colored route of the port is two
// launches per pass (at r > 1 three on the symmetric pass):
//
//   products  P[f, :] for every flat contribution row f of the plan's order
//             (ops/colored.py::plan_tables: the forward parts bucket by
//             bucket, nb * mp rows each, nb * kp in a transposed pass; on
//             the symmetric pass the mirror parts V^T @ x[row_idx] after
//             them): at r = 1 by this file's products kernel, both parts
//             from one read of V (below); at r > 1 by
//             bst_element_owner_products_<pair> (owner_pass.cu, the tile
//             core) in its STORE mode, one launch per direction;
//   rounds    y[row, c] += sum over colors k, in color order, of
//             (src_k[row] in [0, total) ? P[src_k[row], c] : 0),
//             here.
//
// Race-freedom without atomics: within a color no two contributions share
// an output row (the coloring), so each table maps a row to at most one
// contribution, and this kernel gives every (row, column) of y one thread
// that sums its colors in order from zero in registers and writes y once.
// Every entry of P has one writer.  So the product of a pass is the same
// bits on every run, and a wrong coloring (two contributions of one row in
// one color) loses a contribution and gives a wrong product, as it did in
// the chain.
//
// What bounds it: the tables (ncolors x out_len int32, read once, coalesced:
// neighbouring threads take neighbouring rows), the rows of P the tables
// name (ncolors x out_len x r entries at most, from L2 where P fits there)
// and y read and written once.  Each P load depends on its table load, so a
// thread loads the table entries of a batch of colors first and then their
// rows of P, keeping a batch's loads in flight together.
//
// At r = 1 the products come from this file's own products kernel
// (bst_colored_products_r1_<pair>) in place of owner_pass.cu's: one thread
// block per (stored block, 64-row tile), each value read once in stored
// row order, both parts of the symmetric pass from that one read.  Warp w
// takes the tile's rows w, w + 8, ... (the next row's loads issued before
// this row's sums); lane l its 16-byte slots of a chunk of 256 columns.  The
// forward product of a row is the warp's sum (a fixed shuffle tree, then
// the chunks in order, added by the row's one owner thread into its
// scratch row); a tile's mirror product of column k is the sum over its
// rows of each warp's lane partial, then over the 8 warps in order through
// shared memory.  A block of one tile writes it into its scratch row; a
// block of several tiles writes each tile's partial into a workspace, and
// the block's last tile to finish (an atomic counter per block, zeroed by
// the wrapper) adds the partials in tile order into the scratch row.  So
// every scratch row has one writer and a fixed summation order, as in
// owner_pass.cu, without its two reads of V on the symmetric pass.
// Measured on the H100 (the real-size cell's symmetric products alone):
// one thread block per whole stored block lost (its 512 x 512 and 1024 x
// 1024 blocks ran on one SM each: 0.3725 ms against the tile core's
// 0.2887); 64-row tiles 0.19 ms, 128-row tiles no faster and slower on
// small operands; two rows of loads in flight, or four rows at a time,
// slower than one.

// Layout: thread e of the flat numbering owns entry (e / r, e % r) of y
// (columns across lanes at r > 1, one thread per row at r = 1).  Four rows
// a thread at r = 1, each color's four table entries as one 16-byte load,
// measured slower on the H100 (0.0197 against 0.0165 ms on 32768 rows and
// 33 colors, 0.0122 against 0.0118 on 4096 rows and 11 colors).  An index
// outside [0, total) (the plan's sentinel is total) reads 0, so no appended
// zero row of P is needed.
#include "row_stream.cuh"

namespace {

constexpr int kThreads = 256;

// colors whose loads a thread keeps in flight together
template <typename T>
__host__ __device__ constexpr int batch() {
  return sizeof(T) >= 16 ? 4 : 8;
}

template <typename T>
__device__ __forceinline__ T pick(const T* __restrict__ P, int src,
                                  long long total, long long at) {
  return (src >= 0 && src < total) ? P[at] : T(0);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rounds_kernel(const int* __restrict__ tab, int ncolors, long long out_len,
                  long long total, const T* __restrict__ P, T* __restrict__ y,
                  int r) {
  constexpr int B = batch<T>();
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= out_len * r) return;
  const long long row = e / r;
  const int c = (int)(e - row * r);
  T acc = T(0);
  for (int k0 = 0; k0 < ncolors; k0 += B) {
    int src[B];
#pragma unroll
    for (int j = 0; j < B; ++j)
      src[j] = k0 + j < ncolors ? __ldg(tab + (long long)(k0 + j) * out_len +
                                        row)
                                : -1;
    T v[B];
#pragma unroll
    for (int j = 0; j < B; ++j)
      v[j] = pick(P, src[j], total, (long long)src[j] * r + c);
#pragma unroll
    for (int j = 0; j < B; ++j)
      if (k0 + j < ncolors) acc = acc + v[j];
  }
  y[e] = y[e] + acc;
}

constexpr int kWarps = kThreads / 32;
constexpr int kJ = 8;                // columns of a lane in a chunk
constexpr int kChunk = 32 * kJ;      // columns of a chunk
constexpr int kTileRows = 64;        // rows of a work item

template <typename T>
__device__ __forceinline__ T gathered(const T* __restrict__ x,
                                      long long x_rows, int i) {
  return (i >= 0 && i < x_rows) ? x[i] : T(0);
}

// a load that bypasses L1: other SMs wrote the partials it reads
__device__ __forceinline__ float load_cg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ double load_cg(const double* p) {
  return __ldcg(p);
}
template <typename R>
__device__ __forceinline__ bst::cplx<R> load_cg(const bst::cplx<R>* p) {
  return bst::cplx<R>(__ldcg(&p->re), __ldcg(&p->im));
}

// One work item per (stored block b, 64-row tile t) of every bucket,
// bucket after bucket: owner[g] is item g's bucket, ifirst[q] bucket q's
// first item.  MODE 0: the forward parts P[poff_f[q] + b * mp + i] = (V_b
// x[cols_b])[i] for the tile's rows; 1: the transposed parts P[poff_m[q] + b * kp + k] = (V_b^T x[rows_b])[k];
// 2: both (the symmetric pass).  CONJ reads conj(V).  A block of one tile
// writes its transposed part directly; a block of several writes each
// tile's partial to W (woff[q] + (b * ntiles + t) * kp) and the block's
// last tile to finish (counted in cnt[bstart[q] + b]) sums them in tile
// order into P.
template <typename VS, typename T, int MODE, bool CONJ>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 4 : 2)
    products_r1_kernel(const bst::BucketDesc* __restrict__ tab,
                       const int* __restrict__ owner,
                       const long long* __restrict__ ifirst,
                       const long long* __restrict__ bstart,
                       const long long* __restrict__ poff_f,
                       const long long* __restrict__ poff_m,
                       const long long* __restrict__ woff, T* W, int* cnt,
                       const T* __restrict__ x, long long x_rows,
                       T* __restrict__ P) {
  __shared__ T mir[kWarps][kChunk];
  __shared__ bool last;
  const int q = owner[blockIdx.x];
  const bst::BucketDesc d = tab[q];
  const int mp = (int)d.mp, kp = (int)d.kp;
  const int ntiles = (mp + kTileRows - 1) / kTileRows;
  const long long item = (long long)blockIdx.x - ifirst[q];
  const long long b = item / ntiles;
  const int t = (int)(item - b * ntiles);
  const int i1 = min(mp, (t + 1) * kTileRows);
  const VS* __restrict__ V = static_cast<const VS*>(d.vals) + b * mp * kp;
  const int* __restrict__ rows = d.row_tab + b * mp;
  const int* __restrict__ cols = d.col_tab + b * kp;
  T* part = W + (MODE != 0 && ntiles > 1
                     ? woff[q] + (b * ntiles + t) * (long long)kp : 0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // lane l's columns of a chunk: slot s (16 bytes of V, N values) at
  // column c0 + (32 s + l) N; one load per slot where rows are 16-byte
  // aligned (kp % N == 0 and the values 16-byte aligned), else value by
  // value
  constexpr int N = bst::kRowVec<VS>;
  constexpr int S = kJ / N;
  const bool vec = kp % N == 0 &&
                   (reinterpret_cast<uintptr_t>(d.vals) & 15) == 0;
  for (int c0 = 0; c0 < kp; c0 += kChunk) {
    T xc[kJ], macc[kJ];
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const int k = c0 + (32 * (j / N) + lane) * N + j % N;
      xc[j] = (MODE != 1 && k < kp) ? gathered(x, x_rows, cols[k]) : T(0);
      macc[j] = T(0);
    }
    // the warp's rows i, i + 8, ...: the next row's loads issued before
    // this row's sums and shuffles
    auto fetch = [&](int i, uint4 (&slots)[S], T& xr) {
#pragma unroll
      for (int sl = 0; sl < S; ++sl) {
        const int k = c0 + (32 * sl + lane) * N;
        slots[sl] = i < i1 && k < kp
                    ? bst::load_slot(V + (long long)i * kp + k, vec,
                                     min(N, kp - k))
                    : make_uint4(0u, 0u, 0u, 0u);
      }
      xr = MODE != 0 && i < i1 ? gathered(x, x_rows, rows[i]) : T(0);
    };
    uint4 cur[S];
    T xr;
    fetch(t * kTileRows + warp, cur, xr);
    for (int i = t * kTileRows + warp; i < i1; i += kWarps) {
      uint4 nxt[S];
      T xr_next;
      fetch(i + kWarps, nxt, xr_next);
      T f = T(0);
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const T v = bst::conj_if<CONJ>(
            bst::Widen<T, VS>::of(bst::unpack<VS>(cur[j / N], j % N)));
        if (MODE != 1) f = bst::mac(v, xc[j], f);
        if (MODE != 0) macc[j] = bst::mac(v, xr, macc[j]);
      }
      if (MODE != 1) {
#pragma unroll
        for (int m = 16; m; m >>= 1) f = f + bst::shfl_xor(f, m);
        if (lane == 0) {
          T* at = P + poff_f[q] + b * mp + i;
          *at = c0 == 0 ? f : *at + f;
        }
      }
#pragma unroll
      for (int sl = 0; sl < S; ++sl) cur[sl] = nxt[sl];
      xr = xr_next;
    }
    if (MODE != 0) {
#pragma unroll
      for (int j = 0; j < kJ; ++j)
        mir[warp][(32 * (j / N) + lane) * N + j % N] = macc[j];
      __syncthreads();
      for (int k = threadIdx.x; k < kChunk && c0 + k < kp; k += kThreads) {
        T s = mir[0][k];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) s = s + mir[w][k];
        if (ntiles == 1)
          P[poff_m[q] + b * kp + c0 + k] = s;
        else
          part[c0 + k] = s;
      }
      __syncthreads();
    }
  }
  if (MODE == 0 || ntiles == 1) return;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(cnt + bstart[q] + b, 1) == ntiles - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const T* w0 = W + woff[q] + b * ntiles * (long long)kp;
  for (int k = threadIdx.x; k < kp; k += kThreads) {
    T s = load_cg(w0 + k);
    for (int u = 1; u < ntiles; ++u) s = s + load_cg(w0 + (long long)u * kp + k);
    P[poff_m[q] + b * kp + k] = s;
  }
}

template <typename VS, typename T, bool CONJ>
void launch_products_r1(int mode, long long items, cudaStream_t s,
                        const bst::BucketDesc* tab, const int* owner,
                        const long long* ifirst, const long long* bstart,
                        const long long* poff_f, const long long* poff_m,
                        const long long* woff, T* W, int* cnt, const T* x,
                        long long x_rows, T* P) {
  const dim3 grid((unsigned)items);
  if (mode == 0)
    products_r1_kernel<VS, T, 0, CONJ><<<grid, kThreads, 0, s>>>(
        tab, owner, ifirst, bstart, poff_f, poff_m, woff, W, cnt, x, x_rows,
        P);
  else if (mode == 1)
    products_r1_kernel<VS, T, 1, CONJ><<<grid, kThreads, 0, s>>>(
        tab, owner, ifirst, bstart, poff_f, poff_m, woff, W, cnt, x, x_rows,
        P);
  else
    products_r1_kernel<VS, T, 2, CONJ><<<grid, kThreads, 0, s>>>(
        tab, owner, ifirst, bstart, poff_f, poff_m, woff, W, cnt, x, x_rows,
        P);
}

// table: n descriptors of element buckets (int64 [n, 9]); items: their
// work items (64-row tiles); owner [items] int32 (each item's bucket);
// ifirst [n] int64 (each bucket's first item); bstart [n] int64 (each bucket's first
// stored block); poff_f / poff_m [n] int64 (each bucket's first row of P
// among the forward / transposed parts; the mode that writes none reads
// neither); woff [n] int64 (each bucket's first element of W); W: the
// tiles' transposed partials of blocks of several tiles; cnt: int32 [all
// blocks], zeroed by the caller; x [x_rows]; P written; mode 0
// forward, 1 transpose, 2 symmetric, plus bst::kConj.
template <typename VS, typename T>
int products_r1(const void* table, int n, long long items, const int* owner,
                const long long* ifirst, const long long* bstart, const long long* poff_f,
                const long long* poff_m, const long long* woff, T* W,
                int* cnt, const T* x, long long x_rows, T* P, int mode,
                void* stream) {
  const bool conj = bst::kComplex<T> && (mode & bst::kConj) != 0;
  mode &= ~bst::kConj;
  if (n <= 0 || items < 0 || items > 0x7fffffffLL || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  if (items == 0) return 0;
  const auto* tab = static_cast<const bst::BucketDesc*>(table);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (conj)
    launch_products_r1<VS, T, bst::kComplex<T>>(mode, items, s, tab, owner,
                                                ifirst, bstart, poff_f,
                                                poff_m, woff, W, cnt, x,
                                                x_rows, P);
  else
    launch_products_r1<VS, T, false>(mode, items, s, tab, owner, ifirst,
                                     bstart, poff_f, poff_m, woff, W, cnt, x,
                                     x_rows, P);
  return (int)cudaGetLastError();
}

// tables: int32 [ncolors, out_len] (the plan's, sentinel total); P: [total,
// r] of T; y: [out_len, r] of T, added into, one write per entry.
template <typename T>
int rounds(const int* tables, int ncolors, long long out_len, long long total,
           const T* P, T* y, int r, void* stream) {
  if (ncolors < 0 || out_len < 0 || total < 0 || r < 0)
    return (int)cudaErrorInvalidValue;
  if (ncolors == 0 || out_len == 0 || r == 0) return 0;
  const long long blocks = (out_len * (long long)r + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  rounds_kernel<T><<<dim3((unsigned)blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      tables, ncolors, out_len, total, P, y, r);
  return (int)cudaGetLastError();
}

using bf16 = __nv_bfloat16;
using c64 = bst::cplx<float>;
using c128 = bst::cplx<double>;

}  // namespace

// bst_colored_products_r1_<stored>[_<compute>]: the products pass at r = 1,
// for each stored / compute pair of B1 and B9 (fused_spmm.COMPUTE_TYPES).
#define BST_COLORED_PRODUCTS(SUFFIX, V, T)                                    \
  extern "C" int bst_colored_products_r1_##SUFFIX(                            \
      const void* table, int n, long long items, const int* owner,           \
      const long long* ifirst, const long long* bstart,                       \
      const long long* poff_f, const long long* poff_m,                       \
      const long long* woff, T* W, int* cnt, const T* x, long long x_rows,    \
      T* P, int mode, void* stream) {                                         \
    return products_r1<V, T>(table, n, items, owner, ifirst, bstart, poff_f,  \
                             poff_m, woff, W, cnt, x, x_rows, P, mode,        \
                             stream);                                         \
  }

BST_COLORED_PRODUCTS(f32, float, float)
BST_COLORED_PRODUCTS(f64, double, double)
BST_COLORED_PRODUCTS(c64, c64, c64)
BST_COLORED_PRODUCTS(c128, c128, c128)
BST_COLORED_PRODUCTS(bf16_f32, bf16, float)
BST_COLORED_PRODUCTS(bf16_f64, bf16, double)
BST_COLORED_PRODUCTS(f32_f64, float, double)
BST_COLORED_PRODUCTS(c64_c128, c64, c128)

// bst_colored_rounds_<compute>: the rounds pass, by compute type.
#define BST_COLORED_ROUNDS(SUFFIX, T)                                         \
  extern "C" int bst_colored_rounds_##SUFFIX(                                 \
      const int* tables, int ncolors, long long out_len, long long total,     \
      const T* P, T* y, int r, void* stream) {                                \
    return rounds<T>(tables, ncolors, out_len, total, P, y, r, stream);       \
  }

BST_COLORED_ROUNDS(f32, float)
BST_COLORED_ROUNDS(f64, double)
BST_COLORED_ROUNDS(c64, c64)
BST_COLORED_ROUNDS(c128, c128)
