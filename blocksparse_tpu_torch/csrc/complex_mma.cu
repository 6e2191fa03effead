// Complex64 SpMM on the tensor cores: the instance of kernel B1
// (fused_spmm.cu) for complex64 values and a complex64 operand at r > 1.
//
// Replaces blocksparse_tpu/ops/pallas/fused_spmm.py::_kernel for complex
// products with many right-hand sides.  For every stored block b of every
// chunked bucket of a layout, as B1 does:
//   forward    y[row chunks(b)] += V_b   @ x[col chunks(b)]
//   transpose  y[col chunks(b)] += V_b^T @ x[row chunks(b)]
//   symmetric  both, in one launch: the forward work items, then the
//              transposed ones
// and with kConj, conj(V_b) in place of V_b (V_b^H in the transpose mode).
//
// The real embedding.  The interleaved complex V [M, K] (the layout of
// torch.view_as_real) is a real [M, 2K]; with B the real [2K, 2r] whose row
// 2k is x's row k as it lies in memory, (Xr, Xi) per column, and whose row
// 2k + 1 is (-Xi, Xr) (under kConj (Xi, -Xr)), the real product V B is the
// interleaved complex product V x: column 2c is Re, column 2c + 1 Im.  So
// one real GEMM reads each complex value once and does the four real
// products of every complex multiply-add.  The stage holds only x's rows:
// a lane reads its B fragment's even-row value and forms the odd-row one
// from the same float pair (a swap and a sign), so B's derived rows cost
// no shared memory and no copy.  In the transpose mode A = V^T is staged
// as V's rows as they lie in memory (each complex value's pair kept
// together), which gives the fragments the same float2 reads as the
// forward layout.
//
// Arithmetic: mma.sync.m16n8k8 TF32 in 3xTF32 at every precision tier
// (tile_mma.cuh's split: small*big + big*small + big*big, the three terms
// each issued over a warp's whole tile in turn, so neighbouring MMAs do not
// depend on each other), summed in the tensor core's fp32 over the whole
// contraction.  Its sums round toward zero, an error that grows with the
// depth: 1.8e-6 of max|y| at the complex BEM's 512-deep blocks on an H100
// (7.7e-7 with a fresh fragment per 16-deep stage, whose 32 more registers
// a thread cost 7% of the time; 8.5e-6 at 512 and 1.3e-5 at 1024 on
// normal values), so the routing rule keeps blocks deeper than the cap in
// fused_spmm.MMA_RULES on the FMA instance.
//
// Work (b1_mma.cuh, the skeleton the tensor-core instances share): one
// thread block of four warps per (stored block, 64-row output tile, column
// tile of 16, 32 or 64 complex columns), numbered through the bucket table
// as B1's work items; a warp takes all 64 rows (four m16 tiles) of its
// quarter of the columns,
// so each B fragment is split once and each A fragment serves 4 WN MMAs
// per term.  The contraction runs in stages of 16 complex rows through a
// three-deep cp.async ring (8-byte copies: one complex value each; sentinel
// rows, rows and columns past the operands are zero-filled by the copy);
// four blocks share an SM, three at WN = 4, whose 64 accumulators a thread
// need more than the 128 registers four blocks leave it.
//
// What bounds it on the card: 8 real operations per complex multiply-add
// at 3xTF32's 165 TFLOP/s (the complex Helmholtz BEM at r = 64: 17.6
// GFLOP, 0.1064 ms), against the stored values' bytes at 3.35 TB/s (139
// MB, 0.042 ms).  The symmetric mode reads the off-diagonal values twice,
// once per half (278 MB in place of 139 on that operator), and the
// transposed items read their x rows once per 64-row output tile.  A
// design that formed both halves from one staged tile (the tile core's
// MIRROR) halved those reads and was no faster; so were persistent blocks
// with one ring across items, deeper rings and A split once per stage in
// shared memory: the time goes to the MMA loop's issue and latency (the
// first design without its loads took 0.406 of its 0.565 ms), and the
// instance runs at ~100 of the card's TFLOP/s in TF32 (PERF.md section 6).
//
// Race-freedom: thread blocks of a bucket share output rows, so every
// write to y is an atomicAdd of the lane's (Re, Im) pair as one float2
// (sm_90's vector atomic: each part is added atomically on its own, as
// tile_core.cuh's two scalar atomics do) into the output the wrapper
// zeroed or the partial sum of the launches before it; the summation
// order across blocks varies from run to run.
#include "b1_mma.cuh"

namespace {

using bst_b1mma::Item;
using bst_b1mma::kRows;

// B's fragment at x row kc of a staged tile (row stride ld), real column n:
// logical k = tig is the row as it lies (physical row 2 kc), k = tig + 4 the
// derived row (2 kc + 1), each split for 3xTF32
template <bool CONJ>
__device__ __forceinline__ void b_fragment(const float* X, int ld, int kc,
                                           int n, uint32_t (&big)[2],
                                           uint32_t (&sml)[2]) {
  const float2 pr = *reinterpret_cast<const float2*>(X + kc * ld + (n & ~1));
  const float b0 = (n & 1) ? pr.y : pr.x;
  float b1 = (n & 1) ? pr.x : -pr.y;
  if (CONJ) b1 = -b1;
  bst_mma::split<1>(b0, big[0], sml[0]);
  bst_mma::split<1>(b1, big[1], sml[1]);
}

// A's fragment of a 16-row tile from float pairs: lo at row gid, hi at row
// gid + 8, each pair (logical k = tig, k = tig + 4), split for 3xTF32
__device__ __forceinline__ void a_fragment(const float* lo_p,
                                           const float* hi_p,
                                           uint32_t (&big)[4],
                                           uint32_t (&sml)[4]) {
  const float2 lo = *reinterpret_cast<const float2*>(lo_p);
  const float2 hi = *reinterpret_cast<const float2*>(hi_p);
  const float av[4] = {lo.x, hi.x, lo.y, hi.y};
#pragma unroll
  for (int e = 0; e < 4; ++e) bst_mma::split<1>(av[e], big[e], sml[e]);
}

// The complex64 policy of b1_mma.cuh: WN n8 tiles per warp, 4 warps x WN x
// 8 real columns = the tile
template <int WN, bool TRANS, bool CONJ>
struct PolicyC64 {
  static constexpr bool kComplex = true;
  static constexpr int kVBytes = 8;         // one complex64 value
  static constexpr int kThreads = bst_b1mma::kThreads;
  static constexpr int KC = 16;             // complex contraction rows
  static constexpr int KT = 2 * KC;         // real contraction depth
  // forward A: As[i][p] (i < 64 output rows, p < KT real), row stride KT + 8
  static constexpr int AF = KT + 8;
  // transposed A: As[mm][2 i + j] (mm < KC contraction rows, i < 64 output
  // rows, j the part), row stride 2 * 64 + 8
  static constexpr int AT = 2 * kRows + 8;
  static constexpr int ASIZE = kRows * AF > KC * AT ? kRows * AF : KC * AT;
  static constexpr int NR = 32 * WN;        // real columns of the tile
  static constexpr int TC = NR / 2;         // complex columns
  static constexpr int XLD = NR + 8;        // x stage row stride (floats)
  static constexpr int STAGE = (ASIZE + KC * XLD) * (int)sizeof(float);
  // four blocks share an SM, three at WN = 4, whose 64 accumulators a
  // thread need more than the 128 registers four blocks leave it
  static constexpr int kBlocks = WN == 4 ? 3 : 4;
  static constexpr int width(int r) { return r <= 16 ? 1 : (r <= 32 ? 2 : 4); }

  const Item it;
  int live_t;  // live m16 tiles of the item
  float acc[4][WN][4];

  __device__ __forceinline__ explicit PolicyC64(const Item& i)
      : it(i), live_t((i.live_rows() + 15) / 16) {
#pragma unroll
    for (int tt = 0; tt < 4; ++tt)
#pragma unroll
      for (int u = 0; u < WN; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[tt][u][e] = 0.f;
  }

  // stage s: contraction rows k0 = s * KC .. + KC, 8-byte copies (one
  // complex value each); sentinel rows, rows and columns past the operands
  // are zero-filled by the copy
  __device__ __forceinline__ void load(int s, unsigned char* buf) const {
    float* As = reinterpret_cast<float*>(buf);
    float* Xs = As + ASIZE;
    const float2* V = static_cast<const float2*>(it.V);
    const float2* x = static_cast<const float2*>(it.a.x);
    const int k0 = s * KC, t = threadIdx.x, r = it.a.r;
    if constexpr (TRANS) {  // V rows k0.., columns m0.. (output rows)
#pragma unroll
      for (int q = 0; q < KC * kRows / kThreads; ++q) {
        const int idx = t + q * kThreads;
        const int mm = idx / kRows, i = idx % kRows;
        const bool ok = k0 + mm < it.K && it.m0 + i < it.M;
        bst_b1mma::cp_async<8>(
            As + mm * AT + 2 * i,
            ok ? V + (long long)(k0 + mm) * it.kp + it.m0 + i : V, ok);
      }
    } else {  // V rows m0.. (output rows), columns k0..
#pragma unroll
      for (int q = 0; q < KC * kRows / kThreads; ++q) {
        const int idx = t + q * kThreads;
        const int i = idx / KC, kk = idx % KC;
        const bool ok = it.m0 + i < it.M && k0 + kk < it.K;
        bst_b1mma::cp_async<8>(
            As + i * AF + 2 * kk,
            ok ? V + (long long)(it.m0 + i) * it.kp + k0 + kk : V, ok);
      }
    }
    for (int idx = t; idx < KC * TC; idx += kThreads) {
      const int kk = idx / TC, c = idx % TC;
      const long long row = k0 + kk < it.K ? it.in_row(it.b, k0 + kk) : -1;
      const bool ok = row >= 0 && row < it.a.x_rows && it.c0 + c < r;
      bst_b1mma::cp_async<8>(Xs + kk * XLD + 2 * c,
                             ok ? x + row * r + it.c0 + c : x, ok);
    }
  }

  __device__ __forceinline__ void compute(const unsigned char* buf) {
    const float* As = reinterpret_cast<const float*>(buf);
    const float* Xs = As + ASIZE;
    const int wc = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int ks = 0; ks < KT / 8; ++ks) {
      const int kc = ks * 4 + tig;  // the stage's complex contraction row
      uint32_t bbig[WN][2], bsml[WN][2];
#pragma unroll
      for (int u = 0; u < WN; ++u)
        b_fragment<CONJ>(Xs, XLD, kc, (wc * WN + u) * 8 + gid, bbig[u],
                         bsml[u]);
      // two m16 tiles at a time; the three terms of 3xTF32 each over both
      // tiles' n8 tiles in turn, so neighbouring MMAs are independent
#pragma unroll
      for (int tp = 0; tp < 2; ++tp) {
        if (2 * tp >= live_t) continue;  // block-uniform
        uint32_t abig[2][4], asml[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = (2 * tp + h) * 16 + gid;
          // A: logical k = tig is Re of contraction row kc, tig + 4 its Im
          if constexpr (TRANS)
            a_fragment(As + kc * AT + 2 * i, As + kc * AT + 2 * (i + 8),
                       abig[h], asml[h]);
          else
            a_fragment(As + i * AF + 2 * kc, As + (i + 8) * AF + 2 * kc,
                       abig[h], asml[h]);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int u = 0; u < WN; ++u)
            bst_mma::mma_tf32(acc[2 * tp + h][u], asml[h], bbig[u]);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int u = 0; u < WN; ++u)
            bst_mma::mma_tf32(acc[2 * tp + h][u], abig[h], bsml[u]);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int u = 0; u < WN; ++u)
            bst_mma::mma_tf32(acc[2 * tp + h][u], abig[h], bbig[u]);
      }
    }
  }

  // lane (gid, tig) holds rows gid and gid + 8 at real columns 2 tig, 2 tig
  // + 1 of each n8 tile: one complex value per row
  __device__ __forceinline__ void store() const {
    float2* y = static_cast<float2*>(it.a.y);
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
          const int c = it.c0 + (wc * WN + u) * 4 + tig;
          if (c < r)
            atomicAdd(y + row * r + c,
                      make_float2(acc[tt][u][2 * h], acc[tt][u][2 * h + 1]));
        }
      }
    }
  }
};

}  // namespace

// table: n descriptors of chunked complex64 buckets (int64 [n, 9],
// tile_core.cuh::BucketDesc); items_f / items_t: the table's work items in
// the forward and the transposed numbering; x [x_rows, r], y [y_rows, r]
// complex64 (interleaved), y added into; mode 0 forward, 1 transpose, 2
// symmetric (x_rows == y_rows), plus bst::kConj (4) for conj(V).
extern "C" int bst_fused_spmm_mma_c64(const void* table, int n,
                                      long long items_f, long long items_t,
                                      const void* x, void* y, int r,
                                      long long x_rows, long long y_rows,
                                      int mode, void* stream) {
  return bst_b1mma::run<PolicyC64>(table, n, items_f, items_t, x, y, r,
                                   x_rows, y_rows, mode, stream);
}
