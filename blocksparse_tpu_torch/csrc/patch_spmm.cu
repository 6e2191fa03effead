// Merged-patch SpMM on Hopper (kernel B2 of the port): the forward pass on
// wgmma + TMA, and the operand prologue it shares with the transposed
// product (patch_spmm_tr.cu).
//
// Replaces blocksparse_tpu/ops/patch_engine.py::_kern_fwd (launched from
// _bucket_spmm_raw / patch_spmm).  For every slot b of a patch bucket, with
// V_b of shape [MP, KP] and its KP/32 column chunks cc[b]:
//   Y[rs[b] : rs[b] + MP] += V_b @ Xg,  Xg = concat_j X[cc[b,j]*32 : +32]
// Sentinel column chunks (id >= ceil(n / 32)) read zero; padded slots
// (zero values, rs = 0) add zeros.
//
// What bounds it on the card: 2 r flops per stored value at the tier's
// tensor-core rate (3xTF32: 165 TFLOP/s for "highest"/"high"; one TF32
// pass: 495 TFLOP/s for precision=None, where the bytes of V bound it).
//
// The design:
//   - Prologue (xt_kernel, its own launch): X [P, n, r] -> X^T [P, r, ld],
//     ld = n rounded up to 4 floats (TMA takes 16-byte global strides), one
//     grid plane per product.  It writes hi = tf32(X)^T (cvt.rna) and, at
//     tier 1, lo = (X - tf32(X))^T, exact in fp32.  Every gathered 32-row
//     chunk of X is then a K-major box X^T[c0 : c0 + TR, chunk*32 : +32] of
//     128-byte rows: exactly the span of the 128-byte swizzle that wgmma
//     reads.  The transposed product reads its slot windows the same way.
//   - Main kernel: one thread block per (slot b, 64-row tile of MP, column
//     tile TR in {64, 128}), two blocks per SM.  The slot's live chunks
//     are compacted first (tile_mma.cuh's live_chunks), so sentinels issue
//     neither loads nor MMAs.  One producer warp issues TMA loads of the V
//     tile [64 x 32] (a tensor map over vals viewed [nb*MP, KP]) and the
//     X^T box(es) [TR x 32] into a ring of mbarrier-guarded stages; boxes
//     past r, n or nb*MP are zero-filled by the TMA unit.  One consumer
//     warpgroup owns the m64 x TR tile.
//   - Tier 0 (precision=None): wgmma.m64nTRk8.f32.tf32.tf32 with both
//     operands in shared memory, four per 32-deep stage, accumulating in
//     registers.
//   - Tier 1 ("highest"/"high", 3xTF32): A is read from the swizzled tile
//     into registers and split there (big = tf32(a), small = a - big); B's
//     two parts come from shared memory.  Each k8 sums small*big_hi +
//     big*lo + big*hi, in that order (the register-A form).  The tensor
//     core's sums round toward zero, an error that grows with the length of
//     the sum, so each stage's products go into a fresh accumulator that is
//     then added into the block's sums with IEEE fp32 adds.
//
// Race-freedom: slots may share output rows and blocks run in no order, so
// every write to Y is an atomicAdd(float4*) (scalar atomics where r % 4 !=
// 0) into the zeroed output the wrapper allocates (tile_mma.cuh's AddY).
// The summation order across blocks varies from run to run.
//
// Tensor maps are encoded on the host (tma_wgmma.cuh) and passed as
// __grid_constant__ kernel parameters.  A shape the kernel does not take
// returns cudaErrorInvalidValue; there is no fallback.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_mma.cuh"
#include "tma_wgmma.cuh"

using namespace bst_tma;

namespace {

constexpr int kCC = 32;  // column chunk width of the patch plan

// -- prologue ------------------------------------------------------------------

// hi[p, c, i] = tf32(x[p, i, c]); lo[p, c, i] = x[p, i, c] - hi[p, c, i] (lo
// may be null); product p = blockIdx.z.  64 x 64 tiles through shared memory, 256 threads, four float4 loads of
// X's rows (scalar loads where vec is 0: r % 4 != 0 or x unaligned) and
// four float4 stores of X^T's rows per thread (ld % 4 == 0 and 16-byte
// aligned outputs; rows of X past n are written as zeros into the pad).
__global__ void __launch_bounds__(256)
    xt_kernel(const float* __restrict__ x, float* __restrict__ hi,
              float* __restrict__ lo, long long n, int r, long long ld,
              int vec) {
  __shared__ float tile[64][65];
  const long long p = blockIdx.z;
  x += p * n * r;
  hi += p * r * ld;
  if (lo != nullptr) lo += p * r * ld;
  const long long i0 = (long long)blockIdx.x * 64;
  const int c0 = blockIdx.y * 64;
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int idx = threadIdx.x + it * 256;
    const int row = idx >> 4, c = c0 + (idx & 15) * 4;
    const long long i = i0 + row;
    float v[4];
    if (vec && i < n && c + 3 < r) {
      const float4 q = *reinterpret_cast<const float4*>(x + i * r + c);
      v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = (i < n && c + j < r) ? x[i * r + c + j] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) tile[row][c - c0 + j] = v[j];
  }
  __syncthreads();
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int idx = threadIdx.x + it * 256;
    const int cc = idx >> 4, i4 = (idx & 15) * 4;
    const long long c = c0 + cc, i = i0 + i4;
    if (c >= r || i >= n) continue;  // i % 4 == 0 and i < ld: i + 3 < ld
    float h[4], l[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float v = tile[i4 + j][cc];
      h[j] = __uint_as_float(bst_mma::tf32_bits(v));
      l[j] = v - h[j];
    }
    *reinterpret_cast<float4*>(hi + c * ld + i) =
        make_float4(h[0], h[1], h[2], h[3]);
    if (lo != nullptr)
      *reinterpret_cast<float4*>(lo + c * ld + i) =
          make_float4(l[0], l[1], l[2], l[3]);
  }
}

// -- the forward kernel -----------------------------------------------------------

// One consumer warpgroup (64 output rows) and one producer warp per block; a
// ring of stages, each [V tile 64 x 32 | X^T hi TR x 32 | X^T lo TR x 32
// (tier 1)], every part 1024-byte aligned for the swizzle, ~96 KB in all:
// two blocks per SM, so one block's loads and epilogue overlap the other's
// MMAs.
template <int TR, int TIER>
struct Fwd {
  static constexpr int THREADS = 128 + 32;
  static constexpr int A_BYTES = 64 * 128;
  static constexpr int B_BYTES = TR * 128;
  static constexpr int STAGE = A_BYTES + (TIER == 1 ? 2 : 1) * B_BYTES;
  static constexpr int STAGES = 98304 / STAGE < 8 ? 98304 / STAGE : 8;
  static constexpr int SMEM = STAGES * STAGE + 1024;  // + alignment slack
  static constexpr int ND = TR / 2;  // accumulator floats per thread
  static_assert(STAGES >= 2, "ring");
};
template <int TR, int TIER>
__global__ void __launch_bounds__(Fwd<TR, TIER>::THREADS, 2)
    patch_fwd_kernel(const __grid_constant__ CUtensorMap vmap,
                     const __grid_constant__ CUtensorMap hmap,
                     const __grid_constant__ CUtensorMap lmap,
                     const int* __restrict__ cc, const int* __restrict__ rs,
                     float* __restrict__ y, int MP, int KP, int r,
                     long long x_rows, long long y_rows, int mtiles, int vec) {
  using F = Fwd<TR, TIER>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[F::STAGES], empty[F::STAGES];
  __shared__ int chunk[bst_mma::kMaxKC], kpos[bst_mma::kMaxKC];
  __shared__ int counts[bst_mma::kMaxKC / 32];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int b = blockIdx.x / mtiles, m0 = (blockIdx.x % mtiles) * 64;
  const int c0 = blockIdx.y * TR;
  const int nst = bst_mma::live_chunks(cc + (long long)b * (KP / kCC),
                                       KP / kCC, x_rows, chunk, kpos, counts);
  if (nst == 0) return;
  if (threadIdx.x == 0) {
    for (int s = 0; s < F::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (warp == 4) {  // the producer warp: lane 0 issues every load
    if (lane == 0) {
      const int vrow = b * MP + m0;
      for (int s = 0; s < nst; ++s) {
        const int slot = s % F::STAGES;
        mbar_wait(&empty[slot], ((s / F::STAGES) & 1) ^ 1);
        unsigned char* st = smem + slot * F::STAGE;
        mbar_expect_tx(&full[slot], F::STAGE);
        tma_load(st, &vmap, &full[slot], kpos[s], vrow);
        tma_load(st + F::A_BYTES, &hmap, &full[slot], chunk[s] * kCC, c0);
        if constexpr (TIER == 1)
          tma_load(st + F::A_BYTES + F::B_BYTES, &lmap, &full[slot],
                   chunk[s] * kCC, c0);
      }
    }
  } else {  // the consumer warpgroup: rows m0 .. m0 + 63 of the slot
    const int lw = warp, gid = lane >> 2, tig = lane & 3;
    float acc[F::ND];
#pragma unroll
    for (int i = 0; i < F::ND; ++i) acc[i] = 0.f;

    for (int s = 0; s < nst; ++s) {
      const int slot = s % F::STAGES;
      mbar_wait(&full[slot], (s / F::STAGES) & 1);
      const unsigned char* st = smem + slot * F::STAGE;
      const uint32_t a_addr = smem_u32(st);
      const uint32_t h_addr = a_addr + F::A_BYTES;
      if constexpr (TIER == 0) {
        fence_regs(acc);
        wg_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          Wgmma<TR>::ss(acc, sw128_desc(a_addr + 32 * ks),
                        sw128_desc(h_addr + 32 * ks), 1);
        wg_commit();
        wg_wait0();
        fence_regs(acc);
      } else {
        const uint32_t l_addr = h_addr + F::B_BYTES;
        // A fragments of the four k8 steps from the swizzled tile
        uint32_t abig[4][4], asml[4][4];
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int row = lw * 16 + gid + 8 * (q & 1);
            const int k = ks * 8 + tig + 4 * (q >> 1);
            const float v = *reinterpret_cast<const float*>(
                st + sw128_offset(row, k));
            bst_mma::split<1>(v, abig[ks][q], asml[ks][q]);
          }
        float part[F::ND];
        wg_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          const uint64_t dh = sw128_desc(h_addr + 32 * ks);
          Wgmma<TR>::rs(part, asml[ks], dh, ks > 0);  // ks 0: part = product
          Wgmma<TR>::rs(part, abig[ks], sw128_desc(l_addr + 32 * ks), 1);
          Wgmma<TR>::rs(part, abig[ks], dh, 1);
        }
        wg_commit();
        wg_wait0();
        fence_regs(part);
#pragma unroll
        for (int i = 0; i < F::ND; ++i) acc[i] += part[i];
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);
    }

    // Lane (gid, tig) holds rows gid and gid + 8 of its warp's 16 at
    // columns 8 j + 2 tig (+ 1): an even lane takes row gid and an odd lane
    // row gid + 8 of the four columns 8 j + 4 (tig / 2) .. + 3, trading
    // halves.
    const bst_mma::AddY add{y, y_rows, r, c0, vec != 0};
    const long long row0 = (long long)__ldg(rs + b) + m0;
    const bool odd = tig & 1;
    const int row = lw * 16 + (odd ? gid + 8 : gid);
    const bool in = m0 + row < MP;
#pragma unroll
    for (int j = 0; j < TR / 8; ++j) {
      const float* v = acc + 4 * j;
      const float r0 = __shfl_xor_sync(0xffffffffu, odd ? v[0] : v[2], 1);
      const float r1 = __shfl_xor_sync(0xffffffffu, odd ? v[1] : v[3], 1);
      if (in)
        add(row0 + row, 8 * j + (tig & 2) * 2,
            odd ? make_float4(r0, r1, v[2], v[3])
                : make_float4(v[0], v[1], r0, r1));
    }
  }
}

// -- host side ---------------------------------------------------------------------

}  // namespace

namespace bst_tma {

cudaError_t encoder(EncodeTiled* out) {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                  cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess) return e;
    if (q != cudaDriverEntryPointSuccess || p == nullptr)
      return cudaErrorNotSupported;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  *out = fn;
  return cudaSuccess;
}

}  // namespace bst_tma

namespace {

struct Maps {
  CUtensorMap v, h, l;
};

template <int TR, int TIER>
int launch(const Maps& m, const int* cc, const int* rs, float* y, int nb,
           int MP, int KP, int r, long long x_rows, long long y_rows, bool vec,
           cudaStream_t s) {
  using F = Fwd<TR, TIER>;
  static bool sized = false;  // above 48 KB once per kernel instance
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        patch_fwd_kernel<TR, TIER>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, F::SMEM);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  const int mtiles = (MP + 63) / 64;
  const dim3 grid(nb * mtiles, (r + TR - 1) / TR);
  patch_fwd_kernel<TR, TIER><<<grid, F::THREADS, F::SMEM, s>>>(
      m.v, m.h, m.l, cc, rs, y, MP, KP, r, x_rows, y_rows, mtiles, vec ? 1 : 0);
  return (int)cudaGetLastError();
}

template <int TR>
int launch_tier(int tier, const Maps& m, const int* cc, const int* rs,
                float* y, int nb, int MP, int KP, int r, long long x_rows,
                long long y_rows, bool vec, cudaStream_t s) {
  return tier ? launch<TR, 1>(m, cc, rs, y, nb, MP, KP, r, x_rows, y_rows,
                              vec, s)
              : launch<TR, 0>(m, cc, rs, y, nb, MP, KP, r, x_rows, y_rows,
                              vec, s);
}

}  // namespace

// The prologue: per product p < P, hi [p, r, ld] = tf32(x[p])^T and, where
// lo is not null, lo [p, r, ld] = (x[p] - tf32(x[p]))^T, for x [P, n, r]
// row-major; ld % 4 == 0, ld >= n.
extern "C" int bst_patch_xt_f32(const float* x, float* hi, float* lo, int P,
                                long long n, int r, long long ld,
                                void* stream) {
  if (ld % 4 != 0 || ld < n || (r + 63) / 64 > 65535 || P > 65535 || n < 0 ||
      r < 0 || P < 0 || !aligned16(hi) || (lo != nullptr && !aligned16(lo)))
    return (int)cudaErrorInvalidValue;
  if (n == 0 || r == 0 || P == 0) return 0;
  const dim3 grid((unsigned)((n + 63) / 64), (r + 63) / 64, P);
  const int vec = r % 4 == 0 && aligned16(x);
  xt_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      x, hi, lo, n, r, ld, vec);
  return (int)cudaGetLastError();
}

// The forward product: y [y_rows, r] (zeroed) += the bucket applied to X,
// given as the prologue's hi / lo [r, ld] (lo read at tier 1 only).
// tier: 0 one TF32 pass, 1 3xTF32.
extern "C" int bst_patch_spmm_f32(const float* vals, const int* cc,
                                  const int* rs, const float* xt_hi,
                                  const float* xt_lo, float* y, int nb, int MP,
                                  int KP, int r, long long x_rows,
                                  long long ld, long long y_rows, int tier,
                                  void* stream) {
  if (KP % kCC != 0 || KP / kCC > bst_mma::kMaxKC || tier < 0 || tier > 1 ||
      !aligned16(vals) || !aligned16(xt_hi) ||
      (tier == 1 && (xt_lo == nullptr || !aligned16(xt_lo))) || ld % 4 != 0 ||
      ld < x_rows || x_rows >= (1LL << 31) || (long long)nb * MP >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (nb <= 0 || r <= 0 || MP <= 0 || KP <= 0 || x_rows <= 0 || y_rows <= 0)
    return 0;
  const int tr = r <= 64 ? 64 : 128;
  if ((r + tr - 1) / tr > 65535) return (int)cudaErrorInvalidValue;
  EncodeTiled enc;
  const cudaError_t e = encoder(&enc);
  if (e != cudaSuccess) return (int)e;
  Maps m;
  if (!tensor_map(enc, &m.v, vals, KP, (long long)nb * MP, KP, 64) ||
      !tensor_map(enc, &m.h, xt_hi, x_rows, r, ld, tr) ||
      !tensor_map(enc, &m.l, tier == 1 ? xt_lo : xt_hi, x_rows, r, ld, tr))
    return (int)cudaErrorInvalidValue;
  const bool vec = r % 4 == 0 && aligned16(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return tr == 64 ? launch_tier<64>(tier, m, cc, rs, y, nb, MP, KP, r, x_rows,
                                    y_rows, vec, s)
                  : launch_tier<128>(tier, m, cc, rs, y, nb, MP, KP, r, x_rows,
                                     y_rows, vec, s);
}
