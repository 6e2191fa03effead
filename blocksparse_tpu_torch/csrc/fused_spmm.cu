// Chunk-table block product on Hopper (kernel B1 of the port).
//
// Replaces blocksparse_tpu/ops/pallas/fused_spmm.py::_kernel (launched from
// chunked_block_apply) and, over many buckets, the JAX package's chain
// blocksparse_tpu/ops/xla_spmv.py::chunked_multi_apply.  For every stored
// block b of every chunked bucket of a layout:
//   forward    y[row chunks(b)] += V_b   @ x[col chunks(b)]
//   transpose  y[col chunks(b)] += V_b^T @ x[row chunks(b)]
//   symmetric  forward, plus y[col chunks] += V_b^T @ x[row chunks] from the
//              same shared-memory tile of V_b (one read of the values)
// where a chunk table row lists C-aligned chunks of x / y.  Element types:
// f32, f64 and complex64 / complex128 (c64, c128: interleaved {re, im}),
// the last two also in a conjugate mode that reads conj(V_b) (V_b^H in the
// transpose mode, conj(V_b) for both halves of the symmetric one).  Mixed
// instances read the values in their stored type and compute in a wider
// one (tile_core.cuh, Widen): bf16 -> f32 and bf16 -> f64 (bf16 storage),
// f32 -> f64 and c64 -> c128 (an operand of the wider type); the entry
// names carry both, bst_fused_spmm[_multi]_<stored>_<compute>.
//
// What bounds it on the card: SpMV (r = 1) streams each value once and does
// two flops per 4 or 8 bytes, so it is bound by the bytes of vals; at
// r = 64-128 each value feeds r FMAs and the CUDA-core FMA rate and the
// bytes of vals both matter (a complex value feeds four FMAs per column
// for its 8 or 16 bytes).  The design (tile_core.cuh): one launch per
// layout over a table of bucket descriptors, so the grid holds every
// (block, 64-row output tile) of every bucket and fills the 132 SMs however
// small each bucket is (one launch per bucket left most SMs idle and paid a
// launch each); each thread block finds its bucket by a binary search, then
// stages V and the gathered x in shared memory (RHS tile of 1, 32, 64 or 128
// columns; an 8 x up-to-4 register tile per thread) and adds its tile into
// y with atomics.  The TPU kernel's read-modify-write of y was race-free
// only because its grid ran in order; here every write to y is an atomicAdd
// into the zeroed output (or the partial sum of the launches before it), so
// the summation order varies between runs.  Any r is taken directly, with
// no RHS slicing and no on-chip memory budget.  At r = 1 the row-stream
// body (row_stream.cuh, bst_fused_spmm_rows_<pair>) reads the same table
// in stored row order, several blocks per SM, where the Python rule table
// (ops/kernels/fused_spmm.py::R1_RULES) picks it over the tile core.
#include "row_stream.cuh"

namespace {

template <typename V, typename T>
int run_one(const V* vals, const int* row_tab, const int* col_tab, const T* x,
            T* y, int nb, int mp, int kp, int C, int r, long long x_rows,
            long long y_rows, int mode, void* stream) {
  const int base = mode & ~bst::kConj;
  if (C <= 0 || mp % C != 0 || kp % C != 0 || base < 0 || base > 2)
    return (int)cudaErrorInvalidValue;
  if (nb <= 0 || mp <= 0 || kp <= 0) return 0;
  const long long M = base == 1 ? kp : mp;
  const bst::DescTable tab{
      nullptr, 1, bst::BucketDesc{vals, row_tab, col_tab, {0, 0}, mp, kp, C, nb}};
  return bst::launch_buckets<V, T, bst::ChunkMap>(
      tab, nb * ((M + bst::kMT - 1) / bst::kMT), x, y, r, x_rows, y_rows, mode,
      stream);
}

template <typename V, typename T>
int run_many(const void* table, int n, long long items, const T* x, T* y,
             int r, long long x_rows, long long y_rows, int mode,
             void* stream) {
  if (n < 0 || (n == 0 && items != 0)) return (int)cudaErrorInvalidValue;
  const bst::DescTable tab{static_cast<const bst::BucketDesc*>(table), n, {}};
  return bst::launch_buckets<V, T, bst::ChunkMap>(tab, items, x, y, r, x_rows,
                                                  y_rows, mode, stream);
}

template <typename V, typename T>
int run_rows(const void* table, int n, long long items, const T* x, T* y,
             int r, long long x_rows, long long y_rows, int mode,
             void* stream) {
  if (n < 0 || (n == 0 && items != 0)) return (int)cudaErrorInvalidValue;
  const bst::DescTable tab{static_cast<const bst::BucketDesc*>(table), n, {}};
  return bst::launch_row_stream<V, T, bst::ChunkMap>(tab, items, x, y, r,
                                                     x_rows, y_rows, mode,
                                                     stream);
}

using bf16 = __nv_bfloat16;
using c64 = bst::cplx<float>;
using c128 = bst::cplx<double>;

}  // namespace

// One bucket (bst_fused_spmm_<suffix>): vals [nb, mp, kp] of V, row_tab
// [nb, mp / C], col_tab [nb, kp / C]; mode 0 forward, 1 transpose, 2
// symmetric, plus bst::kConj (4) for conj(V) (the complex entries).  y is
// added into.  Many buckets (bst_fused_spmm_multi_<suffix>): table is n
// descriptors (int64 [n, 9] on the card, see tile_core.cuh::BucketDesc),
// items their work items in this mode.  The row-stream body at r = 1
// (bst_fused_spmm_rows_<suffix>, row_stream.cuh): the same table, items its
// forward work items in every mode.
#define BST_B1_ENTRIES(SUFFIX, V, T)                                          \
  extern "C" int bst_fused_spmm_##SUFFIX(                                     \
      const V* vals, const int* row_tab, const int* col_tab, const T* x,      \
      T* y, int nb, int mp, int kp, int C, int r, long long x_rows,           \
      long long y_rows, int mode, void* stream) {                             \
    return run_one<V, T>(vals, row_tab, col_tab, x, y, nb, mp, kp, C, r,      \
                         x_rows, y_rows, mode, stream);                       \
  }                                                                           \
  extern "C" int bst_fused_spmm_multi_##SUFFIX(                               \
      const void* table, int n, long long items, const T* x, T* y, int r,     \
      long long x_rows, long long y_rows, int mode, void* stream) {           \
    return run_many<V, T>(table, n, items, x, y, r, x_rows, y_rows, mode,     \
                          stream);                                            \
  }                                                                           \
  extern "C" int bst_fused_spmm_rows_##SUFFIX(                                \
      const void* table, int n, long long items, const T* x, T* y, int r,     \
      long long x_rows, long long y_rows, int mode, void* stream) {           \
    return run_rows<V, T>(table, n, items, x, y, r, x_rows, y_rows, mode,     \
                          stream);                                            \
  }

BST_B1_ENTRIES(f32, float, float)
BST_B1_ENTRIES(f64, double, double)
BST_B1_ENTRIES(c64, c64, c64)
BST_B1_ENTRIES(c128, c128, c128)
BST_B1_ENTRIES(bf16_f32, bf16, float)
BST_B1_ENTRIES(bf16_f64, bf16, double)
BST_B1_ENTRIES(f32_f64, float, double)
BST_B1_ENTRIES(c64_c128, c64, c128)

extern "C" const char* bst_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
