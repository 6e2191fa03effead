// B9's owner mode (scatter="sorted"): two passes on Hopper.
//
// Replaces the scatter of
// blocksparse_tpu/ops/pallas/mask_select.py::_scatter_kernel for an operator
// built with scatter="sorted", and the JAX engine's sorted scatter
// (blocksparse_tpu/ops/xla_spmv.py: each element bucket's products permuted
// by a stable argsort of their targets and summed with
// segment_sum(indices_are_sorted=True)).  The two passes are that engine's
// own structure:
//
//   products  P[poff[bucket] + b * M + i, :] = (V_b @ x[col_idx_b])[i, :]
//             (transposed: V_b^T @ x[row_idx_b], M = kp), every element
//             bucket of a layout in one launch.  It runs the element pass's
//             tile core (tile_core.cuh, ElemMap gathers) with the FlatMap
//             output map in STORE mode: each (block, 64-row tile, column
//             tile) work item stages its gathered x rows once in shared
//             memory and writes its rows of P, one writer per entry.
//   sum       y[row, c] = y[row, c] + sum over the row's contributions e, in
//             list order, of P[flat[e], c], one write per owned row and
//             column.  The host's owner table lists, per output row that
//             any bucket reaches, its contributions in the JAX order
//             (buckets in table order, each in its stable-sorted order) and
//             each one's flat row of P (mask_select.py::OwnerTable).  One
//             warp owns one (row, 32-column tile); lane c adds its column.
//
// Race-freedom without atomics: every entry of P has one writer, and every
// owned (row, column) of y one reader-writer.  Every sum has a fixed order
// (the tile core's FMA order per entry of P, the list order per row), so
// the result is bit-identical from run to run.
//
// What bounds it: the products pass is the element pass's arithmetic and
// bytes (each value read once, each gathered x row once per work item) plus
// the scratch it writes; the sum reads the scratch once and writes y once.
// A warp that owned a row and walked its contributions, one lane per column,
// ran K dependent steps per contribution and gathered x once per
// contribution: 6x the two passes at r = 64 on the scattered flagship, and
// slower at r = 1 on a real-size operand too (config 1 renumbered, H100).
// The scratch holds contributions x r entries of the compute type (the
// flagship at r = 64: 12,800 x 64 x 4 B = 3.3 MB; config 1 at r = 128:
// 256,000 x 128 x 4 B = 131 MB), allocated by the wrapper.
#include "tile_core.cuh"

namespace {

constexpr int kThreads = bst::kThreads;
constexpr int kWarps = kThreads / 32;

// Pass 1: every (block, 64-row tile) of every bucket (grid.x) x column tiles
// (grid.y).  poff[q]: bucket q's first row of P in this direction.
template <typename VS, typename T, int TR, bool TRANS, bool CONJ>
__global__ void __launch_bounds__(kThreads,
                                  TR == 1 && sizeof(T) == 4 ? 3 : 1)
    owner_products_kernel(const bst::DescTable tab,
                          const long long* __restrict__ poff,
                          const T* __restrict__ x, T* __restrict__ P, int r,
                          long long x_rows, long long p_rows) {
  const int side = TRANS ? 1 : 0;
  const int q = bst::locate_index(tab, blockIdx.x, side);
  const bst::BucketDesc d = tab.dev[q];
  const long long item = (long long)blockIdx.x - d.first[side];
  const int mp = (int)d.mp, kp = (int)d.kp;
  const bst::FlatMap out_map{poff[q], TRANS ? kp : mp};
  const bst::ElemMap in_map(TRANS ? d.row_tab : d.col_tab, TRANS ? mp : kp,
                            1);
  bst::tile_product<VS, T, TR, TRANS, false, CONJ, bst::FlatMap, bst::ElemMap,
                    true>(static_cast<const VS*>(d.vals), mp, kp, out_map,
                          in_map, x, x_rows, P, p_rows, r, item);
}

template <typename VS, typename T, int TR, bool CONJ>
void launch_products(dim3 grid, cudaStream_t s, bool trans,
                     const bst::DescTable& tab, const long long* poff,
                     const T* x, T* P, int r, long long x_rows,
                     long long p_rows) {
  if (trans)
    owner_products_kernel<VS, T, TR, true, CONJ><<<grid, kThreads, 0, s>>>(
        tab, poff, x, P, r, x_rows, p_rows);
  else
    owner_products_kernel<VS, T, TR, false, CONJ><<<grid, kThreads, 0, s>>>(
        tab, poff, x, P, r, x_rows, p_rows);
}

template <typename VS, typename T, bool CONJ>
cudaError_t products_width(int tr, dim3 grid, cudaStream_t s, bool trans,
                           const bst::DescTable& tab, const long long* poff,
                           const T* x, T* P, int r, long long x_rows,
                           long long p_rows) {
  switch (tr) {
    case 1: launch_products<VS, T, 1, CONJ>(grid, s, trans, tab, poff, x, P, r, x_rows, p_rows); break;
    case 32: launch_products<VS, T, 32, CONJ>(grid, s, trans, tab, poff, x, P, r, x_rows, p_rows); break;
    case 64: launch_products<VS, T, 64, CONJ>(grid, s, trans, tab, poff, x, P, r, x_rows, p_rows); break;
    default:
      if constexpr (sizeof(T) < 16)
        launch_products<VS, T, 128, CONJ>(grid, s, trans, tab, poff, x, P, r, x_rows, p_rows);
      else
        return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

// table: n descriptors of element buckets (int64 [n, 9], tile_core.cuh::
// BucketDesc), items their work items in this direction; poff [n] int64;
// P [p_rows, r] of T, written (not added into); mode 0 forward or 1
// transpose, plus bst::kConj.
template <typename VS, typename T>
int products_pass(const void* table, int n, long long items,
                  const long long* poff, const T* x, T* P, int r,
                  long long x_rows, long long p_rows, int mode,
                  void* stream) {
  const bool conj = bst::kComplex<T> && (mode & bst::kConj) != 0;
  mode &= ~bst::kConj;
  if (n <= 0 || items < 0 || items > 0x7fffffffLL || (mode != 0 && mode != 1))
    return (int)cudaErrorInvalidValue;
  if (items == 0 || r <= 0 || p_rows == 0) return 0;
  const bst::DescTable tab{static_cast<const bst::BucketDesc*>(table), n, {}};
  const int tr = bst::column_tile(r, false, (int)sizeof(T));
  const dim3 grid((unsigned)items, (r + tr - 1) / tr);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      conj ? products_width<VS, T, bst::kComplex<T>>(tr, grid, s, mode == 1,
                                                     tab, poff, x, P, r,
                                                     x_rows, p_rows)
           : products_width<VS, T, false>(tr, grid, s, mode == 1, tab, poff,
                                          x, P, r, x_rows, p_rows);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Pass 2: warp g owns row g / ctiles of the table and columns
// (g % ctiles) * 32 + lane.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    owner_sum_kernel(const int* __restrict__ rows,
                     const long long* __restrict__ ptr,
                     const long long* __restrict__ flat, long long n_rows,
                     const T* __restrict__ P, T* __restrict__ y,
                     long long y_rows, int r, int ctiles) {
  const long long g = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (g >= n_rows * ctiles) return;
  const long long w = g / ctiles;
  const int c = (int)(g % ctiles) * 32 + (int)(threadIdx.x % 32);
  const long long row = rows[w];
  if (c >= r || row < 0 || row >= y_rows) return;
  const long long e1 = ptr[w + 1];
  T acc = T(0);
  for (long long e = ptr[w]; e < e1; ++e) acc = acc + P[flat[e] * r + c];
  y[row * r + c] = y[row * r + c] + acc;
}

// rows [n_rows] int32, ptr [n_rows + 1] int64, flat [ptr[n_rows]] int64
// (the owner table), P [*, r] from the products pass; y is added into, one
// write per owned row and column.
template <typename T>
int sum_pass(const int* rows, const long long* ptr, const long long* flat,
             long long n_rows, const T* P, T* y, int r, long long y_rows,
             void* stream) {
  if (n_rows < 0 || r < 0) return (int)cudaErrorInvalidValue;
  if (n_rows == 0 || r == 0 || y_rows == 0) return 0;
  const int ctiles = (r + 31) / 32;
  const long long blocks = (n_rows * ctiles + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  owner_sum_kernel<T><<<dim3((unsigned)blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      rows, ptr, flat, n_rows, P, y, y_rows, r, ctiles);
  return (int)cudaGetLastError();
}

using bf16 = __nv_bfloat16;
using c64 = bst::cplx<float>;
using c128 = bst::cplx<double>;

}  // namespace

// bst_element_owner_products_<stored>[_<compute>]: pass 1 of the owner mode
// for each stored / compute pair of B1 and B9 (fused_spmm.COMPUTE_TYPES).
#define BST_OWNER_PRODUCTS(SUFFIX, V, T)                                      \
  extern "C" int bst_element_owner_products_##SUFFIX(                         \
      const void* table, int n, long long items, const long long* poff,       \
      const T* x, T* P, int r, long long x_rows, long long p_rows, int mode,  \
      void* stream) {                                                         \
    return products_pass<V, T>(table, n, items, poff, x, P, r, x_rows,        \
                               p_rows, mode, stream);                         \
  }

BST_OWNER_PRODUCTS(f32, float, float)
BST_OWNER_PRODUCTS(f64, double, double)
BST_OWNER_PRODUCTS(c64, c64, c64)
BST_OWNER_PRODUCTS(c128, c128, c128)
BST_OWNER_PRODUCTS(bf16_f32, bf16, float)
BST_OWNER_PRODUCTS(bf16_f64, bf16, double)
BST_OWNER_PRODUCTS(f32_f64, float, double)
BST_OWNER_PRODUCTS(c64_c128, c64, c128)

// bst_element_owner_sum_<compute>: pass 2, by compute type.
#define BST_OWNER_SUM(SUFFIX, T)                                              \
  extern "C" int bst_element_owner_sum_##SUFFIX(                              \
      const int* rows, const long long* ptr, const long long* flat,           \
      long long n_rows, const T* P, T* y, int r, long long y_rows,            \
      void* stream) {                                                         \
    return sum_pass<T>(rows, ptr, flat, n_rows, P, y, r, y_rows, stream);     \
  }

BST_OWNER_SUM(f32, float)
BST_OWNER_SUM(f64, double)
BST_OWNER_SUM(c64, c64)
BST_OWNER_SUM(c128, c128)
