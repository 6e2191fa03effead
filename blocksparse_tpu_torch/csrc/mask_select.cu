// Sentinel-aware element gather and scatter-add, and the one-launch element
// pass built on them, on Hopper (kernel B9 of the port).
//
// Replaces blocksparse_tpu/ops/pallas/mask_select.py::_gather_kernel and
// ::_scatter_kernel (launched from mask_gather / mask_scatter_add), the
// gather and scatter-add of the element engine (bucket_apply) for f32
// vectors:
//   gather   out[e] = x[idx[e]]        idx[e] >= n reads 0
//   scatter  y[idx[e]] += v[e]         idx[e] >= out_len is dropped
// which is the layout's sentinel convention (core/layout.py: padded lanes
// carry the index n or out_len).  A negative index, which no layout makes,
// is treated the same way, so no index reaches outside x or y.
//
// What bounds it on the card: each index moves 4 bytes of index, 4 of value
// and one random 4-byte access into x or y; x and y (at most a few hundred
// KB for the element buckets) stay in the 50 MB L2, so the kernels are bound
// by the streamed index and value bytes and by the launch itself.  The TPU
// kernels turned each random access into one-hot matrix products because
// the TPU has no fast scalar gather; on the GPU a thread does the access
// directly: four indices per thread and step (one 16-byte index load, and
// a 16-byte value load or store) where the streams are 16-byte aligned, one
// otherwise, neighbouring threads on neighbouring indices, in a grid of at
// most 8 blocks per SM of the card and a grid-stride loop.
//
// Race-freedom: indices repeat (blocks share rows), so the scatter adds with
// fp32 atomicAdd into the output the wrapper zeroed; the summation order
// varies between runs.  The TPU kernel summed in a fixed order through its
// sequential grid.  No product route of the port calls these two kernels:
// the colored element route, their caller until the colored rounds
// (colored_rounds.cu), runs a products pass and one rounds launch, without
// atomics; they stay as the one-call gather and scatter-add of
// mask_select.py.
//
// The element pass (bst_element_pass_*): the element engine's whole
// gather -> per-block product -> scatter-add over every element bucket of a
// layout in one launch, f32, f64, complex64 and complex128 (the complex
// ones also in the conjugate mode of the tile core), in place of one
// gather, one product and one scatter-add per bucket (three launches and
// two allocations each, and the buckets' values are tiny, so the per-bucket
// chain was all launch latency).  It takes a table of bucket descriptors (values [nb, mp, kp],
// row_idx [nb, mp], col_idx [nb, kp]) and runs the tile core of kernel B1
// (tile_core.cuh) with element row maps: each thread block gathers
// x[col_idx] of its block into shared memory (an index >= n reads 0), forms
// V @ xg for a 64-row tile and adds each row into y[row_idx] with one atomic
// add per (block, row) (an index >= out_len is dropped).  Transpose mode
// swaps the tables and uses V^T; symmetric mode also gathers x[row_idx] and
// adds V^T @ xr into y[col_idx] from the same shared-memory tile of V.
// Every write to y is an atomicAdd (fp32 / fp64; a complex value as two,
// one per part) into the output the wrapper zeroed, or into the partial sum
// of the launches before it.  The one-call gather and scatter-add stay f32,
// as the TPU kernels they replace.  The element pass also has the mixed
// instances of the tile core (bf16 -> f32, bf16 -> f64, f32 -> f64, c64 ->
// c128: values read in their stored type, computed in the wider one), named
// bst_element_pass_<stored>_<compute>.  At r = 1 the element pass runs the
// row-stream body (row_stream.cuh, bst_element_pass_rows_<pair>) where the
// Python rule table (ops/kernels/fused_spmm.py::R1_RULES) picks it.
//
// The owner mode of the element pass (scatter="sorted", the port of the JAX
// engine's sorted scatter) is owner_pass.cu: two passes at every r,
// race-free by row ownership and bit-identical from run to run.
#include "row_stream.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;  // 2048 threads: a full SM

// as many blocks as needed for one quad of indices per thread, at most
// kBlocksPerSm per SM of the current card, then a grid-stride loop
int grid_for(long long quads) {
  static int sms[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  int n = dev >= 0 && dev < 64 ? sms[dev] : 0;
  if (n == 0) {
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 1;
    if (dev >= 0 && dev < 64) sms[dev] = n;
  }
  const long long need = (quads + kThreads - 1) / kThreads;
  const long long cap = (long long)n * kBlocksPerSm;
  return (int)(need < 1 ? 1 : need < cap ? need : cap);
}

__device__ __forceinline__ float gathered(const float* __restrict__ x,
                                          long long n, int i) {
  return (i >= 0 && i < n) ? __ldg(x + i) : 0.0f;
}

__device__ __forceinline__ void scattered(float* __restrict__ y,
                                          long long out_len, int i, float v) {
  if (i >= 0 && i < out_len) atomicAdd(y + i, v);
}

// VEC: idx and out 16-byte aligned, four indices per thread and step (one
// int4 load, one float4 store); the K % 4 tail by the first threads of
// block 0.  Without VEC one index per thread and step.
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
    mask_gather_kernel(const float* __restrict__ x, long long n,
                       const int* __restrict__ idx, long long K,
                       float* __restrict__ out) {
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (!VEC) {
    for (long long e = first; e < K; e += stride)
      out[e] = gathered(x, n, idx[e]);
    return;
  }
  const long long quads = K / 4;
  for (long long q = first; q < quads; q += stride) {
    const int4 i = __ldg(reinterpret_cast<const int4*>(idx) + q);
    reinterpret_cast<float4*>(out)[q] =
        make_float4(gathered(x, n, i.x), gathered(x, n, i.y),
                    gathered(x, n, i.z), gathered(x, n, i.w));
  }
  const long long e = quads * 4 + first;
  if (e < K) out[e] = gathered(x, n, idx[e]);
}

// VEC: idx and v 16-byte aligned, four indices per thread and step
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
    mask_scatter_kernel(const float* __restrict__ v,
                        const int* __restrict__ idx, long long K,
                        float* __restrict__ y, long long out_len) {
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (!VEC) {
    for (long long e = first; e < K; e += stride)
      scattered(y, out_len, idx[e], v[e]);
    return;
  }
  const long long quads = K / 4;
  for (long long q = first; q < quads; q += stride) {
    const int4 i = __ldg(reinterpret_cast<const int4*>(idx) + q);
    const float4 w = __ldg(reinterpret_cast<const float4*>(v) + q);
    scattered(y, out_len, i.x, w.x);
    scattered(y, out_len, i.y, w.y);
    scattered(y, out_len, i.z, w.z);
    scattered(y, out_len, i.w, w.w);
  }
  const long long e = quads * 4 + first;
  if (e < K) scattered(y, out_len, idx[e], v[e]);
}

bool aligned16(const void* a, const void* b) {
  return (reinterpret_cast<unsigned long long>(a) |
          reinterpret_cast<unsigned long long>(b)) % 16 == 0;
}

}  // namespace

// out: [K].  x: [n].
extern "C" int bst_mask_gather_f32(const float* x, long long n, const int* idx,
                                   long long K, float* out, void* stream) {
  if (n < 0 || K < 0) return (int)cudaErrorInvalidValue;
  if (K == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (aligned16(idx, out))
    mask_gather_kernel<true><<<grid_for(K / 4), kThreads, 0, s>>>(x, n, idx,
                                                                  K, out);
  else
    mask_gather_kernel<false><<<grid_for((K + 3) / 4), kThreads, 0, s>>>(
        x, n, idx, K, out);
  return (int)cudaGetLastError();
}

// y: [out_len], zeroed by the caller (the kernel adds into it).
extern "C" int bst_mask_scatter_add_f32(const float* v, const int* idx,
                                        long long K, float* y,
                                        long long out_len, void* stream) {
  if (out_len < 0 || K < 0) return (int)cudaErrorInvalidValue;
  if (K == 0 || out_len == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (aligned16(idx, v))
    mask_scatter_kernel<true><<<grid_for(K / 4), kThreads, 0, s>>>(
        v, idx, K, y, out_len);
  else
    mask_scatter_kernel<false><<<grid_for((K + 3) / 4), kThreads, 0, s>>>(
        v, idx, K, y, out_len);
  return (int)cudaGetLastError();
}

// The element pass: table is n descriptors (int64 [n, 9] on the card, see
// tile_core.cuh::BucketDesc, chunk 1), items their work items in this mode;
// mode 0 forward, 1 transpose, 2 symmetric, plus bst::kConj (4) for conj(V)
// (the complex entries).  y is added into.
template <typename V, typename T>
static int element_pass(const void* table, int n, long long items,
                        const T* x, T* y, int r, long long x_rows,
                        long long y_rows, int mode, void* stream) {
  if (n < 0 || (n == 0 && items != 0)) return (int)cudaErrorInvalidValue;
  const bst::DescTable tab{static_cast<const bst::BucketDesc*>(table), n, {}};
  return bst::launch_buckets<V, T, bst::ElemMap>(tab, items, x, y, r, x_rows,
                                                 y_rows, mode, stream);
}

// The element pass at r = 1 on the row-stream body (row_stream.cuh): the
// same table, items its forward work items in every mode.
template <typename V, typename T>
static int element_rows(const void* table, int n, long long items,
                        const T* x, T* y, int r, long long x_rows,
                        long long y_rows, int mode, void* stream) {
  if (n < 0 || (n == 0 && items != 0)) return (int)cudaErrorInvalidValue;
  const bst::DescTable tab{static_cast<const bst::BucketDesc*>(table), n, {}};
  return bst::launch_row_stream<V, T, bst::ElemMap>(tab, items, x, y, r,
                                                    x_rows, y_rows, mode,
                                                    stream);
}

using bf16 = __nv_bfloat16;
using c64 = bst::cplx<float>;
using c128 = bst::cplx<double>;

#define BST_B9_ENTRIES(SUFFIX, V, T)                                          \
  extern "C" int bst_element_pass_##SUFFIX(                                   \
      const void* table, int n, long long items, const T* x, T* y, int r,     \
      long long x_rows, long long y_rows, int mode, void* stream) {           \
    return element_pass<V, T>(table, n, items, x, y, r, x_rows, y_rows,       \
                              mode, stream);                                  \
  }                                                                           \
  extern "C" int bst_element_pass_rows_##SUFFIX(                              \
      const void* table, int n, long long items, const T* x, T* y, int r,     \
      long long x_rows, long long y_rows, int mode, void* stream) {           \
    return element_rows<V, T>(table, n, items, x, y, r, x_rows, y_rows,       \
                              mode, stream);                                  \
  }

BST_B9_ENTRIES(f32, float, float)
BST_B9_ENTRIES(f64, double, double)
BST_B9_ENTRIES(c64, c64, c64)
BST_B9_ENTRIES(c128, c128, c128)
BST_B9_ENTRIES(bf16_f32, bf16, float)
BST_B9_ENTRIES(bf16_f64, bf16, double)
BST_B9_ENTRIES(f32_f64, float, double)
BST_B9_ENTRIES(c64_c128, c64, c128)
