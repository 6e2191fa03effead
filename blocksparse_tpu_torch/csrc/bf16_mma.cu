// bf16 SpMM on the tensor cores: the instance of kernel B1 (fused_spmm.cu)
// for bf16 values with a float32 operand at r > 1 (bf16 storage).
//
// Replaces blocksparse_tpu/ops/pallas/fused_spmm.py::_kernel for bf16
// products with many right-hand sides.  The work items, the cp.async ring
// and the three modes are b1_mma.cuh's (forward, transpose, symmetric; a
// real instance has no conjugate).
//
// Arithmetic: the product of the exact bf16 values with the unrounded
// float32 operand, summed in float32.  (The TPU kernel rounds x to bf16 for
// its matrix unit; that is not ported.)  Each x value splits exactly into
// three bf16 parts, x = h + m + l with h = bf16(x), m = bf16(x - h) and l =
// bf16(x - h - m) (8 + 8 + 8 significant bits, each difference exact in
// float32), formed from the staged float32 x at fragment load.  Three
// mma.sync.m16n8k16 bf16 passes, V h + V m + V l, with float32 sums: every
// bf16 x bf16 product is exact in float32.  The tensor core rounds its
// float32 sums toward zero, an error that grows with the depth of the
// contraction, so the routing rule keeps blocks deeper than its measured
// cap (fused_spmm.MMA_RULES) on the FMA instance.
//
// Warps: each warp takes all 64 rows (four m16 tiles) of its quarter of
// the columns (WN n8 tiles, tiles of 32, 64 or 128 columns), as
// complex_mma.cu's, so every x value of the stage is split once, by the one
// warp that owns its column, and each split feeds four m16 tiles.  (A split
// done once per stage into shared memory does the same arithmetic with a
// pass and a barrier more: measured slower, 0.151 against 0.129 ms on the
// bf16 BEM at r = 64 and 0.347 against 0.232 at r = 128.)  A fragments
// come from ldmatrix: forward from As[i][k] (V's rows), transposed with
// .trans from As[k][i] (V's rows as they lie: A = V^T).  Stages of 32
// contraction rows; V is copied 16 bytes (8 values) at a time where the
// block's row length is a multiple of 8, else value by value with plain
// loads; x 16 bytes at a time where r % 4 == 0, else 8 (r even) or 4.
// Row strides are padded so that the ldmatrix rows and the x reads of a
// warp are free of bank conflicts.
//
// What bounds it on the card: 2 operations per multiply-add at a third of
// the bf16 tensor cores' 989 TFLOP/s (the three passes) against the stored
// values' bytes at 3.35 TB/s (PERF.md section 6).
//
// Race-freedom: every write to y is an atomicAdd (two neighbouring columns
// as one float2, sm_90's vector atomic whose parts are atomic on their own,
// where r is even), as b1_mma.cuh says.
#include "b1_mma.cuh"

namespace {

using bst_b1mma::Item;
using bst_b1mma::kRows;

// bf16x2 of (lo, hi): lo in the low half, rounded to nearest even
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// the three bf16 parts of the pair (lo, hi), packed as pack_bf16
__device__ __forceinline__ void split3(float lo, float hi, uint32_t& h,
                                       uint32_t& m, uint32_t& l) {
  h = pack_bf16(lo, hi);
  lo -= __uint_as_float(h << 16);
  hi -= __uint_as_float(h & 0xffff0000u);
  m = pack_bf16(lo, hi);
  lo -= __uint_as_float(m << 16);
  hi -= __uint_as_float(m & 0xffff0000u);
  l = pack_bf16(lo, hi);
}

// d += a b, bf16 in, f32 sums.  Fragments (gid = lane / 4, tig = lane %
// 4): a = rows gid, gid + 8 x k pairs (2 tig, 2 tig + 1), (2 tig + 8, 2 tig
// + 9), as ldmatrix gives them; b = k pairs (2 tig, 2 tig + 1), (2 tig +
// 8, 2 tig + 9) at n = gid; d as mma_tf32's.
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// four 8 x 8 bf16 matrices whose rows lanes 8 q .. 8 q + 7 address
template <bool TRANS>
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  if constexpr (TRANS)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
        "[%4];\n"
        : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
        : "r"(s)
        : "memory");
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
        : "r"(s)
        : "memory");
}

template <int WN, bool TRANS, bool CONJ>
struct PolicyBF16 {
  static constexpr bool kComplex = false;
  static constexpr int kVBytes = 2;
  static constexpr int kThreads = bst_b1mma::kThreads;
  static constexpr int KC = 32;         // contraction rows per stage
  // forward A: As[i][k], row stride KC + 8 values (80 bytes); transposed:
  // As[k][i], 64 + 8 (144 bytes): the eight rows of each ldmatrix matrix
  // fall in eight distinct 16-byte bank groups
  static constexpr int AF = KC + 8;
  static constexpr int AT = kRows + 8;
  static constexpr int ASIZE = kRows * AF > KC * AT ? kRows * AF : KC * AT;
  static constexpr int ABYTES = ASIZE * 2;
  static constexpr int NR = 32 * WN;    // columns of the tile
  static constexpr int TC = NR;
  // x stage: Xs[k][n] float32, row stride NR + 4 (XLD % 32 == 4: the reads
  // at rows 2 tig (+ 1, + 8, + 9), columns gid are conflict-free)
  static constexpr int XLD = NR + 4;
  static constexpr int STAGE = ABYTES + KC * XLD * (int)sizeof(float);
  static constexpr int kBlocks = WN == 4 ? 3 : 4;
  static constexpr int width(int r) { return r <= 32 ? 1 : (r <= 64 ? 2 : 4); }

  const Item it;
  int live_t;      // live m16 tiles of the item
  bool v_vec;      // 16-byte copies of V (row length % 8 == 0, aligned)
  int x_width;     // floats per copy of x: 4 (r % 4 == 0, aligned), 2, 1
  float acc[4][WN][4];

  __device__ __forceinline__ explicit PolicyBF16(const Item& i)
      : it(i),
        live_t((i.live_rows() + 15) / 16),
        v_vec(i.kp % 8 == 0 &&
              (reinterpret_cast<uintptr_t>(i.V) & 15) == 0),
        x_width(i.a.r % 4 == 0 &&
                        (reinterpret_cast<uintptr_t>(i.a.x) & 15) == 0
                    ? 4
                    : (i.a.r % 2 == 0 &&
                       (reinterpret_cast<uintptr_t>(i.a.x) & 7) == 0
                           ? 2
                           : 1)) {
#pragma unroll
    for (int tt = 0; tt < 4; ++tt)
#pragma unroll
      for (int u = 0; u < WN; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[tt][u][e] = 0.f;
  }

  __device__ __forceinline__ void load(int s, unsigned char* buf) const {
    uint16_t* As = reinterpret_cast<uint16_t*>(buf);
    float* Xs = reinterpret_cast<float*>(buf + ABYTES);
    const uint16_t* V = static_cast<const uint16_t*>(it.V);
    const int k0 = s * KC, t = threadIdx.x;
    // A: As[kk][i] = V[k0 + kk][m0 + i] (TRANS), As[i][kk] = V[m0 + i][k0
    // + kk]; with 16-byte copies, M (TRANS) or K is a multiple of 8, so a
    // copy is whole or out of range
    if (v_vec) {
#pragma unroll
      for (int q = 0; q < KC * kRows / 8 / kThreads; ++q) {
        const int idx = t + q * kThreads;
        if constexpr (TRANS) {
          const int kk = idx / (kRows / 8), i = idx % (kRows / 8) * 8;
          const bool ok = k0 + kk < it.K && it.m0 + i < it.M;
          bst_b1mma::cp_async<16>(
              As + kk * AT + i,
              ok ? V + (long long)(k0 + kk) * it.kp + it.m0 + i : V, ok);
        } else {
          const int i = idx / (KC / 8), kk = idx % (KC / 8) * 8;
          const bool ok = it.m0 + i < it.M && k0 + kk < it.K;
          bst_b1mma::cp_async<16>(
              As + i * AF + kk,
              ok ? V + (long long)(it.m0 + i) * it.kp + k0 + kk : V, ok);
        }
      }
    } else {
      // plain loads into the buffer of stage s - 1, which every thread
      // has finished reading (b1_mma.cuh's ring)
      for (int idx = t; idx < KC * kRows; idx += kThreads) {
        const int kk = TRANS ? idx / kRows : idx % KC;
        const int i = TRANS ? idx % kRows : idx / KC;
        const bool ok = k0 + kk < it.K && it.m0 + i < it.M;
        const long long off = TRANS ? (long long)(k0 + kk) * it.kp + it.m0 + i
                                    : (long long)(it.m0 + i) * it.kp + k0 + kk;
        As[TRANS ? kk * AT + i : i * AF + kk] = ok ? __ldg(V + off) : 0;
      }
    }
    if (x_width == 4)
      x_copies<4>(s, Xs);
    else if (x_width == 2)
      x_copies<2>(s, Xs);
    else
      x_copies<1>(s, Xs);
  }

  // x's rows of stage s in copies of P floats (whole or out of range: r %
  // P == 0)
  template <int P>
  __device__ __forceinline__ void x_copies(int s, float* Xs) const {
    const float* x = static_cast<const float*>(it.a.x);
    const int k0 = s * KC, r = it.a.r;
    for (int idx = threadIdx.x; idx < KC * NR / P; idx += kThreads) {
      const int kk = idx / (NR / P), c = idx % (NR / P) * P;
      const long long row = k0 + kk < it.K ? it.in_row(it.b, k0 + kk) : -1;
      const bool ok = row >= 0 && row < it.a.x_rows && it.c0 + c < r;
      bst_b1mma::cp_async<4 * P>(Xs + kk * XLD + c,
                                 ok ? x + row * r + it.c0 + c : x, ok);
    }
  }

  __device__ __forceinline__ void compute(const unsigned char* buf) {
    const uint16_t* As = reinterpret_cast<const uint16_t*>(buf);
    const float* Xs = reinterpret_cast<const float*>(buf + ABYTES);
    const int wc = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks) {
      const int k = 16 * ks + 2 * tig;
      // the three parts of B: [part][n8 tile][register]
      uint32_t bp[3][WN][2];
#pragma unroll
      for (int u = 0; u < WN; ++u) {
        const float* xc = Xs + (wc * WN + u) * 8 + gid;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int kh = k + 8 * half;
          split3(xc[kh * XLD], xc[(kh + 1) * XLD], bp[0][u][half],
                 bp[1][u][half], bp[2][u][half]);
        }
      }
      uint32_t a[4][4];
#pragma unroll
      for (int tt = 0; tt < 4; ++tt) {
        if (tt >= live_t) continue;  // block-uniform
        // lane l addresses row l % 8 of matrix l / 8: matrices (rows 0-7,
        // k 0-7), (rows 8-15, k 0-7), (rows 0-7, k 8-15), (rows 8-15, k
        // 8-15) of the m16 x k16 tile
        const int row = tt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int kq = 16 * ks + (lane >> 4) * 8;
        if constexpr (TRANS)
          ldmatrix_x4<true>(a[tt], As + (16 * ks + (lane & 7) +
                                         (lane >> 4) * 8) * AT +
                                       tt * 16 + ((lane >> 3) & 1) * 8);
        else
          ldmatrix_x4<false>(a[tt], As + row * AF + kq);
      }
      // each part over every tile in turn, so neighbouring MMAs are
      // independent
#pragma unroll
      for (int p = 0; p < 3; ++p)
#pragma unroll
        for (int tt = 0; tt < 4; ++tt) {
          if (tt >= live_t) continue;
#pragma unroll
          for (int u = 0; u < WN; ++u) mma_bf16(acc[tt][u], a[tt], bp[p][u]);
        }
    }
  }

  // lane (gid, tig) holds rows gid and gid + 8 at columns 2 tig, 2 tig + 1
  // of each n8 tile
  __device__ __forceinline__ void store() const {
    float* y = static_cast<float*>(it.a.y);
    const int wc = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int gid = lane >> 2, tig = lane & 3;
    const int live = it.live_rows(), r = it.a.r;
#pragma unroll
    for (int tt = 0; tt < 4; ++tt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = tt * 16 + gid + 8 * h;
        if (i >= live) continue;
        const long long row = it.out_row(it.b, it.m0 + i);
        if (row < 0 || row >= it.a.y_rows) continue;
#pragma unroll
        for (int u = 0; u < WN; ++u) {
          const int c = it.c0 + (wc * WN + u) * 8 + 2 * tig;
          const float v0 = acc[tt][u][2 * h], v1 = acc[tt][u][2 * h + 1];
          if (c + 1 < r && r % 2 == 0) {
            atomicAdd(reinterpret_cast<float2*>(y + row * r + c),
                      make_float2(v0, v1));
          } else {
            if (c < r) atomicAdd(y + row * r + c, v0);
            if (c + 1 < r) atomicAdd(y + row * r + c + 1, v1);
          }
        }
      }
    }
  }
};

}  // namespace

// table: n descriptors of chunked bf16 buckets (int64 [n, 9],
// tile_core.cuh::BucketDesc); items_f / items_t: the table's work items in
// the forward and the transposed numbering; x [x_rows, r], y [y_rows, r]
// float32, y added into; mode 0 forward, 1 transpose, 2 symmetric (x_rows
// == y_rows); bst::kConj changes nothing.
extern "C" int bst_fused_spmm_mma_bf16_f32(const void* table, int n,
                                           long long items_f,
                                           long long items_t, const void* x,
                                           void* y, int r, long long x_rows,
                                           long long y_rows, int mode,
                                           void* stream) {
  return bst_b1mma::run<PolicyBF16>(table, n, items_f, items_t, x, y, r,
                                    x_rows, y_rows, mode, stream);
}
