// Float64 and complex128 SpMM on the tensor cores: the instances of kernel
// B1 (fused_spmm.cu) for float64 values with a float64 operand and for
// complex128 values with a complex128 operand at r > 1.
//
// Replaces blocksparse_tpu/ops/pallas/fused_spmm.py::_kernel for f64 and
// complex128 products with many right-hand sides.  The work items, the
// cp.async ring and the three modes are b1_mma.cuh's: for every stored
// block b of every chunked bucket of a layout
//   forward    y[row chunks(b)] += V_b   @ x[col chunks(b)]
//   transpose  y[col chunks(b)] += V_b^T @ x[row chunks(b)]
//   symmetric  both, in one launch
// and, for complex128 under kConj, conj(V_b) in place of V_b.
//
// Arithmetic: mma.sync.m16n8k8 in f64, the H100's DMMA path: every product
// and sum is an IEEE f64 fused multiply-add, so there is no split, no
// precision tier and no depth cap.  Float64 runs each block's GEMM as it
// is.  Complex128 runs complex_mma.cu's real embedding: the interleaved V
// [M, K] read as a real [M, 2K] times a real B [2K, 2r] whose row 2k is x's
// row k as it lies, (Xr, Xi) per column, and whose row 2k + 1 is (-Xi, Xr)
// (under kConj (Xi, -Xr)): the real product is the interleaved complex one.
// The stage holds only x's rows; a lane forms the derived row's value from
// the staged pair at fragment load.  Transposed, A = V^T is staged as V's
// rows as they lie in memory: complex128 keeps each value's pair together,
// so both modes read A as 16-byte pairs; float64 reads its four values
// singly.
//
// Warps: an f64 accumulator takes two registers, so where complex_mma.cu's
// four warps each take all 64 rows of a quarter of the columns (which here
// would cost 128 accumulator registers a thread at its widest tile),
// eight warps split the tile two (rows) by four (columns): 32 rows (two
// m16 tiles) by WN n8 tiles each, 16 WN doubles of accumulators a thread
// (64 registers at WN = 4), two blocks an SM.  Tiles of 32, 64 or 128
// real columns (complex128: 16, 32 or 64 complex ones): r = 128 in
// float64 and r = 64 in complex128 read each value of a block once per
// 64-row tile.  Stages of 16 real contraction rows (complex128: 16, or 32
// below WN = 4), copied 16 bytes at a time (two float64 values where the
// rows' lengths are even, else one; one complex128 value); the 256 / KC
// threads that copy a row of x look its row number up once.  Sentinel
// rows, rows and columns past the operands are zero-filled by the copy.
// Row strides are padded so that every fragment read of a warp is free
// of bank conflicts.
//
// What bounds it on the card: 2 operations per multiply-add (8 per complex
// one) at the f64 tensor cores' 67 TFLOP/s, against the stored values'
// bytes at 3.35 TB/s; at r >= 16 the operations.  Measured, the staging
// takes most of the time: without its MMAs a four-warp form of this
// kernel kept three quarters of its time, and without x's row lookups it
// lost 14-21% (PERF.md section 6); the eight-warp tile, 16-byte float64
// copies and one lookup per row and thread came from those ablations.
// This form keeps 76-99% of its time without its MMAs: the bytes staged
// into shared memory per MMA bound it.
//
// Race-freedom: every write to y is an atomicAdd of one double (a complex
// value as two, one per part, as tile_core.cuh's atomics), as b1_mma.cuh
// says.
#include "b1_mma.cuh"

namespace {

using bst_b1mma::Item;
using bst_b1mma::kRows;

constexpr int kWarpRows = 32;  // output rows of a warp: two m16 tiles
constexpr int kWarpCols = 4;   // warps across the tile's columns
constexpr int kDmmaThreads = 32 * 2 * kWarpCols;

// d += a b, f64.  Fragments (gid = lane / 4, tig = lane % 4): a = (gid,
// tig), (gid + 8, tig), (gid, tig + 4), (gid + 8, tig + 4); b = (k = tig, n
// = gid), (tig + 4, gid); d = (gid, 2 tig), (gid, 2 tig + 1), (gid + 8,
// 2 tig), (gid + 8, 2 tig + 1).  The MMA sums over its k in any order, so
// logical k = tig and tig + 4 are read from physical rows 2 tig and 2 tig +
// 1 of the k8 step in both operands.
__device__ __forceinline__ void mma_f64(double (&d)[4], const double (&a)[4],
                                        const double (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// A fragment from 16-byte pairs: lo at row gid, hi at row gid + 8
__device__ __forceinline__ void pair_fragment(const double* lo_p,
                                              const double* hi_p,
                                              double (&a)[4]) {
  const double2 lo = *reinterpret_cast<const double2*>(lo_p);
  const double2 hi = *reinterpret_cast<const double2*>(hi_p);
  a[0] = lo.x, a[1] = hi.x, a[2] = lo.y, a[3] = hi.y;
}

// What the two policies share: accumulators of two m16 tiles by WN n8 tiles
// a warp, warp (wr, wc) = (warp / kWarpCols, warp % kWarpCols) at rows
// 32 wr, n8 tiles wc * WN ..; the copy of a stage's x rows
template <int WN>
struct DmmaTile {
  static constexpr int kThreads = kDmmaThreads;
  static constexpr int kBlocks = 2;  // two blocks of 256 threads an SM
  const Item it;
  double acc[2][WN][4];

  __device__ __forceinline__ explicit DmmaTile(const Item& i) : it(i) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int u = 0; u < WN; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[h][u][e] = 0.0;
  }
  static __device__ __forceinline__ int warp_row() {
    return (threadIdx.x >> 5) / kWarpCols;
  }
  static __device__ __forceinline__ int warp_col() {
    return (threadIdx.x >> 5) % kWarpCols;
  }
  // tile h of this warp has output rows (warp-uniform)
  __device__ __forceinline__ bool live(int h) const {
    return warp_row() * kWarpRows + h * 16 < it.live_rows();
  }
  __device__ __forceinline__ void mma(int h, const double (&a)[4],
                                      const double (&b)[WN][2]) {
#pragma unroll
    for (int u = 0; u < WN; ++u) mma_f64(acc[h][u], a, b[u]);
  }
  // x's KC rows of a stage from k0 into Xs (row stride XLD, in doubles),
  // each row as NC copies of BYTES from x's columns c0 ..: 256 / KC
  // threads a row, each looking the row up once and copying CPT
  // neighbouring pieces; pieces past r or of sentinel rows zero-filled
  template <int KC, int NC, int BYTES, int XLD, class E>
  __device__ __forceinline__ void x_rows(int k0, double* Xs) const {
    constexpr int TPR = kDmmaThreads / KC;
    constexpr int CPT = (NC + TPR - 1) / TPR;
    constexpr int PE = BYTES / (int)sizeof(E);  // elements of x a piece
    static_assert(kDmmaThreads % KC == 0, "whole rows per thread group");
    const E* x = static_cast<const E*>(it.a.x);
    const int kk = threadIdx.x / TPR, q0 = threadIdx.x % TPR * CPT;
    const int r = it.a.r;
    const long long row = k0 + kk < it.K ? it.in_row(it.b, k0 + kk) : -1;
    const bool live_row = row >= 0 && row < it.a.x_rows;
    const E* src = x + (live_row ? row * r + it.c0 : 0);
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int q = q0 + j, c = q * PE;
      if (NC % TPR != 0 && q >= NC) break;
      const bool ok = live_row && it.c0 + c < r;
      bst_b1mma::cp_async<BYTES>(
          Xs + kk * XLD + c * (int)(sizeof(E) / sizeof(double)),
          ok ? src + c : x, ok);
    }
  }
  // lane (gid, tig) holds rows gid and gid + 8 at real columns 2 tig, 2 tig
  // + 1 of each n8 tile: add(y's row, n8 tile, tig, the two values) for
  // every live output row of the warp
  template <class Add>
  __device__ __forceinline__ void each_output(const Add& add) const {
    const int lane = threadIdx.x & 31, wr = warp_row();
    const int gid = lane >> 2, tig = lane & 3;
    const int live = it.live_rows();
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = wr * kWarpRows + h * 16 + gid + 8 * hh;
        if (i >= live) continue;
        const long long row = it.out_row(it.b, it.m0 + i);
        if (row < 0 || row >= it.a.y_rows) continue;
#pragma unroll
        for (int u = 0; u < WN; ++u)
          add(row, u, tig, acc[h][u][2 * hh], acc[h][u][2 * hh + 1]);
      }
  }
};

// Float64 values, float64 operand: the block's GEMM
template <int WN, bool TRANS, bool CONJ>
struct PolicyF64 : DmmaTile<WN> {
  static constexpr bool kComplex = false;
  static constexpr int kVBytes = 8;
  static constexpr int KC = 16;         // contraction rows per stage
  // forward A: As[i][k], row stride KC + 8 (16-byte pair reads of a warp
  // at rows gid: conflict-free); transposed: As[k][i], row stride 64 + 2
  // (single reads at rows 2 tig, columns gid: conflict-free)
  static constexpr int AF = KC + 8;
  static constexpr int AT = kRows + 2;
  static constexpr int ASIZE = kRows * AF > KC * AT ? kRows * AF : KC * AT;
  static constexpr int NR = 8 * kWarpCols * WN;  // columns of the tile
  static constexpr int TC = NR;
  static constexpr int XLD = NR + 2;    // x stage: Xs[k][n], as AT
  static constexpr int STAGE = (ASIZE + KC * XLD) * (int)sizeof(double);
  static constexpr int width(int r) { return r <= 32 ? 1 : (r <= 64 ? 2 : 4); }

  using DmmaTile<WN>::it;
  // 16-byte copies (two values) where the block's rows and x's rows allow
  // them (even lengths, 16-byte aligned), else 8-byte ones
  const bool vec;
  __device__ __forceinline__ explicit PolicyF64(const Item& i)
      : DmmaTile<WN>(i),
        vec(i.kp % 2 == 0 && i.a.r % 2 == 0 &&
            ((reinterpret_cast<uintptr_t>(i.V) |
              reinterpret_cast<uintptr_t>(i.a.x)) & 15) == 0) {}

  // stage s in copies of P values; with P = 2 a copy of A or x is whole or
  // out of range (kp and r are even)
  template <int P>
  __device__ __forceinline__ void copies(int s, double* As,
                                         double* Xs) const {
    const double* V = static_cast<const double*>(it.V);
    const int k0 = s * KC, t = threadIdx.x;
#pragma unroll
    for (int q = 0; q < KC * kRows / P / kDmmaThreads; ++q) {
      const int idx = t + q * kDmmaThreads;
      if constexpr (TRANS) {  // V rows k0.., columns m0.. (output rows)
        const int mm = idx / (kRows / P), i = idx % (kRows / P) * P;
        const bool ok = k0 + mm < it.K && it.m0 + i < it.M;
        bst_b1mma::cp_async<8 * P>(
            As + mm * AT + i,
            ok ? V + (long long)(k0 + mm) * it.kp + it.m0 + i : V, ok);
      } else {  // V rows m0.. (output rows), columns k0..
        const int i = idx / (KC / P), kk = idx % (KC / P) * P;
        const bool ok = it.m0 + i < it.M && k0 + kk < it.K;
        bst_b1mma::cp_async<8 * P>(
            As + i * AF + kk,
            ok ? V + (long long)(it.m0 + i) * it.kp + k0 + kk : V, ok);
      }
    }
    this->template x_rows<KC, NR / P, 8 * P, XLD, double>(k0, Xs);
  }

  __device__ __forceinline__ void load(int s, unsigned char* buf) const {
    double* As = reinterpret_cast<double*>(buf);
    if (vec)
      copies<2>(s, As, As + ASIZE);
    else
      copies<1>(s, As, As + ASIZE);
  }

  __device__ __forceinline__ void compute(const unsigned char* buf) {
    const double* As = reinterpret_cast<const double*>(buf);
    const double* Xs = As + ASIZE;
    const int lane = threadIdx.x & 31;
    const int gid = lane >> 2, tig = lane & 3;
    const int wr = this->warp_row(), wc = this->warp_col();
#pragma unroll
    for (int ks = 0; ks < KC / 8; ++ks) {
      const int k = 8 * ks + 2 * tig;  // physical rows k, k + 1
      double b[WN][2];
#pragma unroll
      for (int u = 0; u < WN; ++u) {
        const int n = (wc * WN + u) * 8 + gid;
        b[u][0] = Xs[k * XLD + n];
        b[u][1] = Xs[(k + 1) * XLD + n];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (!this->live(h)) continue;
        const int i = wr * kWarpRows + h * 16 + gid;
        double a[4];
        if constexpr (TRANS) {
          a[0] = As[k * AT + i], a[1] = As[k * AT + i + 8];
          a[2] = As[(k + 1) * AT + i], a[3] = As[(k + 1) * AT + i + 8];
        } else {
          pair_fragment(As + i * AF + k, As + (i + 8) * AF + k, a);
        }
        this->mma(h, a, b);
      }
    }
  }

  __device__ __forceinline__ void store() const {
    double* y = static_cast<double*>(it.a.y);
    const int r = it.a.r, wc = this->warp_col();
    this->each_output([&](long long row, int u, int tig, double v0,
                          double v1) {
      const int c = it.c0 + (wc * WN + u) * 8 + 2 * tig;
      if (c < r) atomicAdd(y + row * r + c, v0);
      if (c + 1 < r) atomicAdd(y + row * r + c + 1, v1);
    });
  }
};

// Complex128 values, complex128 operand: the real embedding
template <int WN, bool TRANS, bool CONJ>
struct PolicyC128 : DmmaTile<WN> {
  static constexpr bool kComplex = true;
  static constexpr int kVBytes = 16;
  // complex contraction rows per stage: 16 for the narrower tiles, 8 at
  // WN = 4 (measured on the complex BEM: 16 faster at r = 16 and 32, 8 at
  // r = 64)
  static constexpr int KC = WN == 4 ? 8 : 16;
  static constexpr int KT = 2 * KC;     // real contraction depth
  // forward A: As[i][p] (p < KT real), row stride KT + 8; transposed:
  // As[mm][2 i + j] (V's rows as they lie), row stride 2 * 64 + 4; both
  // read as conflict-free 16-byte pairs
  static constexpr int AF = KT + 8;
  static constexpr int AT = 2 * kRows + 4;
  static constexpr int ASIZE = kRows * AF > KC * AT ? kRows * AF : KC * AT;
  static constexpr int NR = 8 * kWarpCols * WN;  // real columns of the tile
  static constexpr int TC = NR / 2;     // complex columns
  static constexpr int XLD = NR + 4;    // x stage: Xs[kc][2 c + j]
  static constexpr int STAGE = (ASIZE + KC * XLD) * (int)sizeof(double);
  static constexpr int width(int r) { return r <= 16 ? 1 : (r <= 32 ? 2 : 4); }

  using DmmaTile<WN>::it;
  __device__ __forceinline__ explicit PolicyC128(const Item& i)
      : DmmaTile<WN>(i) {}

  __device__ __forceinline__ void load(int s, unsigned char* buf) const {
    double* As = reinterpret_cast<double*>(buf);
    const double2* V = static_cast<const double2*>(it.V);
    const int k0 = s * KC, t = threadIdx.x;
#pragma unroll
    for (int q = 0; q < KC * kRows / kDmmaThreads; ++q) {
      const int idx = t + q * kDmmaThreads;
      if constexpr (TRANS) {
        const int mm = idx / kRows, i = idx % kRows;
        const bool ok = k0 + mm < it.K && it.m0 + i < it.M;
        bst_b1mma::cp_async<16>(
            As + mm * AT + 2 * i,
            ok ? V + (long long)(k0 + mm) * it.kp + it.m0 + i : V, ok);
      } else {
        const int i = idx / KC, kk = idx % KC;
        const bool ok = it.m0 + i < it.M && k0 + kk < it.K;
        bst_b1mma::cp_async<16>(
            As + i * AF + 2 * kk,
            ok ? V + (long long)(it.m0 + i) * it.kp + k0 + kk : V, ok);
      }
    }
    this->template x_rows<KC, TC, 16, XLD, double2>(k0, As + ASIZE);
  }

  __device__ __forceinline__ void compute(const unsigned char* buf) {
    const double* As = reinterpret_cast<const double*>(buf);
    const double* Xs = As + ASIZE;
    const int lane = threadIdx.x & 31;
    const int gid = lane >> 2, tig = lane & 3;
    const int wr = this->warp_row(), wc = this->warp_col();
#pragma unroll
    for (int ks = 0; ks < KT / 8; ++ks) {
      const int kc = 4 * ks + tig;  // the stage's complex contraction row
      // B at real column n: logical k = tig is row 2 kc (x's pair as it
      // lies), k = tig + 4 the derived row 2 kc + 1
      double b[WN][2];
#pragma unroll
      for (int u = 0; u < WN; ++u) {
        const int n = (wc * WN + u) * 8 + gid;
        const double2 pr =
            *reinterpret_cast<const double2*>(Xs + kc * XLD + (n & ~1));
        b[u][0] = (n & 1) ? pr.y : pr.x;
        b[u][1] = (n & 1) ? pr.x : -pr.y;
        if (CONJ) b[u][1] = -b[u][1];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (!this->live(h)) continue;
        const int i = wr * kWarpRows + h * 16 + gid;
        // A: logical k = tig is Re of contraction row kc, tig + 4 its Im
        double a[4];
        if constexpr (TRANS)
          pair_fragment(As + kc * AT + 2 * i, As + kc * AT + 2 * (i + 8), a);
        else
          pair_fragment(As + i * AF + 2 * kc, As + (i + 8) * AF + 2 * kc, a);
        this->mma(h, a, b);
      }
    }
  }

  // real columns 2 tig, 2 tig + 1 of an n8 tile: one complex value
  __device__ __forceinline__ void store() const {
    double* y = static_cast<double*>(it.a.y);
    const int r = it.a.r, wc = this->warp_col();
    this->each_output([&](long long row, int u, int tig, double re,
                          double im) {
      const int c = it.c0 + (wc * WN + u) * 4 + tig;
      if (c < r) {
        atomicAdd(y + 2 * (row * r + c), re);
        atomicAdd(y + 2 * (row * r + c) + 1, im);
      }
    });
  }
};

}  // namespace

// table: n descriptors of chunked float64 / complex128 buckets (int64 [n,
// 9], tile_core.cuh::BucketDesc); items_f / items_t: the table's work items
// in the forward and the transposed numbering; x [x_rows, r], y [y_rows, r]
// float64 / complex128 (interleaved), y added into; mode 0 forward, 1
// transpose, 2 symmetric (x_rows == y_rows), plus bst::kConj (4) for
// conj(V) (complex128).
extern "C" int bst_fused_spmm_mma_f64(const void* table, int n,
                                      long long items_f, long long items_t,
                                      const void* x, void* y, int r,
                                      long long x_rows, long long y_rows,
                                      int mode, void* stream) {
  return bst_b1mma::run<PolicyF64>(table, n, items_f, items_t, x, y, r,
                                   x_rows, y_rows, mode, stream);
}

extern "C" int bst_fused_spmm_mma_c128(const void* table, int n,
                                       long long items_f, long long items_t,
                                       const void* x, void* y, int r,
                                       long long x_rows, long long y_rows,
                                       int mode, void* stream) {
  return bst_b1mma::run<PolicyC128>(table, n, items_f, items_t, x, y, r,
                                    x_rows, y_rows, mode, stream);
}
