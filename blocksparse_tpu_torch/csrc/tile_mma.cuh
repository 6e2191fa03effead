// Tensor-core tile core of kernels B3 (patch_sym.cu) and B4
// (batched_spmm.cu): a slot GEMM on mma.sync.m16n8k8 TF32 fed by cp.async.
//
// One thread block (kThreads = 256, eight warps) computes an output tile of
// Tile::ROWS x Tile::TR -- rows in whole m16 tiles, of which the caller says
// how many are live (a 48-row slot runs three), columns 64 or 128 of the
// right-hand side -- as a sum over a list of contraction stages of depth
// Tile::KT.  The caller's Stages functor says what stage s is: which values
// form its A tile and which rows of X its B tile.  So one loop runs the
// forward product (A = rows of V, B = a gathered 32-row chunk of X) and
// B3's owner pass, a transposed product (A = V^T, B = rows of a slot's
// window) over a list of (slot, chunk) pairs.  Stages that would read only
// zeros -- sentinel chunks -- are left out of the list by the caller, so
// they issue neither loads nor MMAs.
//
// Staging: each stage's tiles are copied from global memory with 16-byte
// cp.async (4-byte copies where r % 4 != 0 or X is not 16-byte aligned)
// into a ring of Tile::STAGES shared-memory buffers, issued STAGES - 1
// stages ahead of the MMAs that read them; rows and columns outside the
// operands are zero-filled by the copy itself (src-size 0) and read nothing.
// Fragments (gid = lane / 4, tig = lane % 4): an MMA sums over its eight k
// in any order, so its logical k = tig and tig + 4 are read from physical
// k = 2 tig and 2 tig + 1 of the stage in both operands; in the transposed
// layout the m16 tile's logical rows gid and gid + 8 likewise sit at
// physical rows 2 gid and 2 gid + 1 (the epilogue writes them there).  A
// lane then reads its four A values as two 8-byte loads.  Row strides are
// padded so each load of a warp hits distinct banks:
//   forward A     As[i][k], row stride KT + 8    (float2 at [i][2 tig])
//   transposed A  As[k][i], row stride ROWS + 4  (float2 at [2 tig][2 gid])
//   B             Bs[k][c], row stride TR + 4    ([2 tig][gid], [2 tig + 1][gid])
// Warps: RG warp rows x (8 / RG) column strips; a warp owns WN n8 tiles of
// its strip and the m16 tiles rg, rg + RG, ... (interleaved, so a short
// slot spreads over the warp rows).
//
// Precision tiers (template parameter TIER, fixed per launch):
//   0  one TF32 pass: each operand rounded to TF32 (cvt.rna), fp32
//      accumulation in the tensor core;
//   1  3xTF32: each operand split in registers, at fragment load, into
//      big = tf32(a) and small = a - big (see split), and small*big + big*small +
//      big*big accumulated in that order: products near fp32 accuracy at a
//      third of the TF32 rate.  The tensor core rounds its fp32 sums toward
//      zero, an error that grows with the length of the sum, so each
//      stage's products go into a fresh fragment per m16 tile that is then
//      added into the block's sums with IEEE fp32 adds (the stage's B
//      fragments are split once and held in registers for that).
//
// Output: a warp's accumulator fragments are paired across neighbouring
// lanes (two shuffles) into four consecutive columns of one row and handed
// to the caller's Out functor, which maps the row and adds the float4 into
// y (AddY: atomicAdd(float4*), global memory on sm_90; four scalar atomics
// where r % 4 != 0).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace bst_mma {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <bool TRANS_, int RG_, int WM_, int WN_, int KT_, int STAGES_>
struct Tile {
  static constexpr bool TRANS = TRANS_;  // A = V^T (contraction over V rows)
  static constexpr int RG = RG_;         // warp rows
  static constexpr int NSTRIP = kWarps / RG_;
  static constexpr int WM = WM_;  // m16 tiles per warp
  static constexpr int WN = WN_;  // n8 tiles per warp
  static constexpr int KT = KT_;  // contraction depth per stage
  static constexpr int STAGES = STAGES_;  // shared-memory ring
  static constexpr int ROWS = 16 * WM_ * RG_;
  static constexpr int TR = 8 * WN_ * NSTRIP;
  static constexpr int A_LD = TRANS_ ? ROWS + 4 : KT_ + 8;
  static constexpr int A_SIZE = TRANS_ ? KT_ * A_LD : ROWS * A_LD;
  static constexpr int B_LD = TR + 4;
  static constexpr int B_SIZE = KT_ * B_LD;
  static constexpr int STAGE = A_SIZE + B_SIZE;
  static constexpr int SMEM = STAGES_ * STAGE * (int)sizeof(float);
  static_assert(kWarps % RG_ == 0 && KT_ % 8 == 0, "tile shape");
};

// -- copies --------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(full ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy an [NR, NC] tile into dst (row stride ld).  row(q) is the address of
// row q's first column, or nullptr for a zero row; col_ok(c) says whether
// column c exists (with vec, c is a multiple of 4 and the test covers the
// whole 16 bytes).  safe: any valid address, passed where nothing is read.
template <int NR, int NC, class RowPtr, class ColOk>
__device__ __forceinline__ void copy_tile(float* dst, int ld, RowPtr row,
                                          ColOk col_ok, bool vec,
                                          const float* safe) {
  if (vec) {
    constexpr int V = NC / 4, N = NR * V;
#pragma unroll
    for (int it = 0; it < (N + kThreads - 1) / kThreads; ++it) {
      const int idx = threadIdx.x + it * kThreads;
      if (N % kThreads == 0 || idx < N) {
        const int q = idx / V, c = (idx % V) * 4;
        const float* p = row(q);
        const bool ok = p != nullptr && col_ok(c);
        cp_async16(dst + q * ld + c, ok ? p + c : safe, ok);
      }
    }
  } else {
    for (int idx = threadIdx.x; idx < NR * NC; idx += kThreads) {
      const int q = idx / NC, c = idx % NC;
      const float* p = row(q);
      const bool ok = p != nullptr && col_ok(c);
      cp_async4(dst + q * ld + c, ok ? p + c : safe, ok);
    }
  }
}

struct AllCols {
  __device__ __forceinline__ bool operator()(int) const { return true; }
};

struct ColsBelow {  // column c0 + c of an r-column operand exists
  int lim;          // r - c0
  __device__ __forceinline__ bool operator()(int c) const { return c < lim; }
};

// -- tensor-core arithmetic ---------------------------------------------------

__device__ __forceinline__ uint32_t tf32_bits(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// Tier 1's operand split.  small = x - big is exact in fp32; it goes to the
// tensor core as it is, which reads the TF32 part of a 32-bit operand and
// drops the low 13 bits -- a truncation of small that costs at most
// 2^-23 |x|, fp32's own rounding, and saves a conversion per operand.
template <int TIER>
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = tf32_bits(x);
  if constexpr (TIER == 1) small = __float_as_uint(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a b (no accumulator input)
__device__ __forceinline__ void mma_tf32_new(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
}

// -- the tile loop ----------------------------------------------------------------

// A fragment of the m16 tile at row i0, k8 step at k0 of the stage, split
// for the tier: logical (gid, tig), (gid + 8, tig), (gid, tig + 4),
// (gid + 8, tig + 4) from physical k0 + 2 tig (+ 1) and, transposed,
// physical rows i0 + 2 gid (+ 1).
template <class T, int TIER>
__device__ __forceinline__ void load_a(const float* A, int i0, int k0, int gid,
                                       int tig, uint32_t (&big)[4],
                                       uint32_t (&small)[4]) {
  const int k = k0 + 2 * tig;
  float a[4];
  if constexpr (T::TRANS) {
    const float2 lo =
        *reinterpret_cast<const float2*>(A + k * T::A_LD + i0 + 2 * gid);
    const float2 hi = *reinterpret_cast<const float2*>(
        A + (k + 1) * T::A_LD + i0 + 2 * gid);
    a[0] = lo.x, a[1] = lo.y, a[2] = hi.x, a[3] = hi.y;
  } else {
    const float2 lo =
        *reinterpret_cast<const float2*>(A + (i0 + gid) * T::A_LD + k);
    const float2 hi =
        *reinterpret_cast<const float2*>(A + (i0 + gid + 8) * T::A_LD + k);
    a[0] = lo.x, a[1] = hi.x, a[2] = lo.y, a[3] = hi.y;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) split<TIER>(a[q], big[q], small[q]);
}

// Sum the nst stages of `st` into the block's [ROWS, TR] tile and hand it
// to `out` in float4 pieces.  Stages: load(s, As, Bs) issues stage s's
// copies; live(mi) says whether m16 tile mi (< mtiles) has an output (it
// must be the same for every lane of a warp).  Out: out(row, col, float4)
// with row < ROWS, col < TR a multiple of 4.  All threads of the block call
// this; smem holds T::SMEM bytes.
template <class T, int TIER, class Stages, class Out>
__device__ __forceinline__ void tile_gemm(const Stages& st, int nst,
                                          int mtiles, const Out& out,
                                          float* smem) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int rg = warp / T::NSTRIP, ns = warp % T::NSTRIP;
  constexpr int KS = T::KT / 8;  // k8 steps per stage
  float acc[T::WM][T::WN][4];
#pragma unroll
  for (int t = 0; t < T::WM; ++t)
#pragma unroll
    for (int u = 0; u < T::WN; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][u][e] = 0.f;
  bool live[T::WM];
#pragma unroll
  for (int t = 0; t < T::WM; ++t) {
    const int mi = rg + T::RG * t;
    live[t] = mi < mtiles && st.live(mi);
  }

#pragma unroll
  for (int s = 0; s < T::STAGES - 1; ++s) {
    if (s < nst) {
      float* buf = smem + s * T::STAGE;
      st.load(s, buf, buf + T::A_SIZE);
    }
    cp_async_commit();
  }
  for (int s = 0; s < nst; ++s) {
    cp_async_wait<T::STAGES - 2>();
    __syncthreads();
    const int nx = s + T::STAGES - 1;
    if (nx < nst) {
      float* buf = smem + (nx % T::STAGES) * T::STAGE;
      st.load(nx, buf, buf + T::A_SIZE);
    }
    cp_async_commit();
    const float* A = smem + (s % T::STAGES) * T::STAGE;
    const float* B = A + T::A_SIZE;
    if constexpr (TIER == 1) {
      // the stage's B fragments once, then per m16 tile its three products
      // over the whole stage into a fresh fragment, added into acc once
      uint32_t bbig[KS][T::WN][2], bsml[KS][T::WN][2];
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const int k = ks * 8 + 2 * tig;  // physical k of logical tig; + 1: tig + 4
#pragma unroll
        for (int u = 0; u < T::WN; ++u) {
          const int c = (ns * T::WN + u) * 8 + gid;
          split<1>(B[k * T::B_LD + c], bbig[ks][u][0], bsml[ks][u][0]);
          split<1>(B[(k + 1) * T::B_LD + c], bbig[ks][u][1], bsml[ks][u][1]);
        }
      }
#pragma unroll
      for (int t = 0; t < T::WM; ++t) {
        if (!live[t]) continue;  // warp-uniform
        float part[T::WN][4];
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          uint32_t abig[4], asml[4];
          load_a<T, 1>(A, (rg + T::RG * t) * 16, ks * 8, gid, tig, abig, asml);
#pragma unroll
          for (int u = 0; u < T::WN; ++u) {
            if (ks == 0)
              mma_tf32_new(part[u], asml, bbig[ks][u]);
            else
              mma_tf32(part[u], asml, bbig[ks][u]);
            mma_tf32(part[u], abig, bsml[ks][u]);
            mma_tf32(part[u], abig, bbig[ks][u]);
          }
        }
#pragma unroll
        for (int u = 0; u < T::WN; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[t][u][e] += part[u][e];
      }
    } else {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const int k = ks * 8 + 2 * tig;
        uint32_t bbig[T::WN][2];
#pragma unroll
        for (int u = 0; u < T::WN; ++u) {
          const int c = (ns * T::WN + u) * 8 + gid;
          bbig[u][0] = tf32_bits(B[k * T::B_LD + c]);
          bbig[u][1] = tf32_bits(B[(k + 1) * T::B_LD + c]);
        }
#pragma unroll
        for (int t = 0; t < T::WM; ++t) {
          if (!live[t]) continue;
          uint32_t abig[4], asml[4];
          load_a<T, 0>(A, (rg + T::RG * t) * 16, ks * 8, gid, tig, abig, asml);
#pragma unroll
          for (int u = 0; u < T::WN; ++u) mma_tf32(acc[t][u], abig, bbig[u]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // Lane (gid, tig) holds logical rows gid and gid + 8 at columns 2 tig,
  // 2 tig + 1 of each n8 tile; an even lane takes row gid and an odd lane
  // row gid + 8 of the four columns 4 (tig / 2) .. + 3, trading the other
  // halves.  Logical row gid + 8 h is tile row gid + 8 h (forward) or
  // 2 gid + h (transposed).
  const bool odd = tig & 1;
#pragma unroll
  for (int t = 0; t < T::WM; ++t) {
    if (!live[t]) continue;
    const int h = odd ? 1 : 0;
    const int row = (rg + T::RG * t) * 16 + (T::TRANS ? 2 * gid + h : gid + 8 * h);
#pragma unroll
    for (int u = 0; u < T::WN; ++u) {
      const float* v = acc[t][u];
      const float r0 = __shfl_xor_sync(0xffffffffu, odd ? v[0] : v[2], 1);
      const float r1 = __shfl_xor_sync(0xffffffffu, odd ? v[1] : v[3], 1);
      const int col = (ns * T::WN + u) * 8 + (tig & 2) * 2;
      out(row, col, odd ? make_float4(r0, r1, v[2], v[3])
                        : make_float4(v[0], v[1], r0, r1));
    }
  }
}

// Adds into y [y_rows, r] (row-major) at columns c0 + col; rows outside
// [0, y_rows) and columns past r are dropped.
struct AddY {
  float* y;
  long long y_rows;
  int r, c0;
  bool vec;  // r % 4 == 0 and y 16-byte aligned
  __device__ __forceinline__ void operator()(long long row, int col,
                                             float4 v) const {
    if (row < 0 || row >= y_rows) return;
    const int c = c0 + col;
    float* p = y + row * r + c;
    if (vec) {
      if (c < r) atomicAdd(reinterpret_cast<float4*>(p), v);
    } else {
      if (c < r) atomicAdd(p, v.x);
      if (c + 1 < r) atomicAdd(p + 1, v.y);
      if (c + 2 < r) atomicAdd(p + 2, v.z);
      if (c + 3 < r) atomicAdd(p + 3, v.w);
    }
  }
};

// The live (non-sentinel) column chunks of one slot, in chunk order, into
// shared memory: chunk[s] the chunk id, kpos[s] its offset j * 32 in the
// slot's k extent.  j < limit; a chunk whose rows start at or past x_rows
// is a sentinel.  Returns the count; every thread of the block calls it.
constexpr int kMaxKC = 128;  // column chunks per slot the list holds

__device__ __forceinline__ int live_chunks(const int* cc_row, int limit,
                                           long long x_rows, int* chunk,
                                           int* kpos, int* counts) {
  const int t = threadIdx.x, lane = t & 31;
  int ch = 0;
  bool v = false;
  if (t < kMaxKC && t < limit) {
    ch = __ldg(cc_row + t);
    v = (long long)ch * 32 < x_rows;
  }
  const unsigned m = __ballot_sync(0xffffffffu, v);
  if (t < kMaxKC && lane == 0) counts[t >> 5] = __popc(m);
  __syncthreads();
  int total = 0, off = 0;
#pragma unroll
  for (int w = 0; w < kMaxKC / 32; ++w) {
    if (w < (t >> 5)) off += counts[w];
    total += counts[w];
  }
  if (v) {
    off += __popc(m & ((1u << lane) - 1u));
    chunk[off] = ch;
    kpos[off] = t * 32;
  }
  __syncthreads();
  return total;
}

}  // namespace bst_mma
