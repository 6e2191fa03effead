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
// a thread cost 7% of the time), so the routing rule keeps blocks deeper
// than fused_spmm.MMA_MAX_DEPTH on the FMA instance.
//
// Work: one thread block of four warps per (stored block, 64-row output
// tile, column tile of 16, 32 or 64 complex columns), numbered through the
// bucket table as B1's work items (tile_core.cuh::BucketDesc, locate); a
// warp takes all 64 rows (four m16 tiles) of its quarter of the columns,
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
#include "tile_core.cuh"
#include "tile_mma.cuh"

namespace {

constexpr int kThreads = 128;    // four warps, each all 64 rows of a tile
constexpr int kRows = bst::kMT;  // output rows per work item (64)
constexpr int KC = 16;           // complex contraction rows per stage
constexpr int KT = 2 * KC;       // real contraction depth per stage
constexpr int kStages = 3;
// forward A: As[i][p] (i < 64 output rows, p < KT real), row stride KT + 8
constexpr int kAF = KT + 8;
// transposed A: As[mm][2 i + j] (mm < KC contraction rows, i < 64 output
// rows, j the part), row stride 2 * 64 + 8
constexpr int kAT = 2 * kRows + 8;
constexpr int kASize = kRows * kAF > KC * kAT ? kRows * kAF : KC * kAT;

// WN n8 tiles per warp: 4 warps x WN x 8 real columns = the tile
template <int WN>
struct Geo {
  static constexpr int NR = 32 * WN;   // real columns of the tile
  static constexpr int TRC = NR / 2;   // complex columns
  static constexpr int XLD = NR + 8;   // x stage row stride (floats)
  static constexpr int STAGE = kASize + KC * XLD;  // floats
  static constexpr int SMEM = kStages * STAGE * (int)sizeof(float);
};

__device__ __forceinline__ void cp_async8(float* dst, const void* src,
                                          bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
               "l"(src), "r"(full ? 8 : 0));
}

struct Args {
  bst::DescTable tab;
  const float2* x;
  float2* y;
  int r;
  long long x_rows, y_rows;
};

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

// One work item (grid.x) and column tile (grid.y); TRANS: A = V^T (the
// transposed numbering).
template <int WN, bool TRANS, bool CONJ>
__device__ __forceinline__ void item_product(const Args& a, long long g,
                                             float* smem) {
  using G = Geo<WN>;
  long long item;
  const bst::BucketDesc d = bst::locate(a.tab, g, TRANS ? 1 : 0, item);
  const int mp = (int)d.mp, kp = (int)d.kp, C = (int)d.C;
  const int M = TRANS ? kp : mp, K = TRANS ? mp : kp;
  const int mtiles = (M + kRows - 1) / kRows;
  const int b = (int)(item / mtiles);
  const int m0 = (int)(item % mtiles) * kRows;
  const int c0 = blockIdx.y * G::TRC;  // first complex column
  const bst::ChunkMap out_row(TRANS ? d.col_tab : d.row_tab, M, C);
  const bst::ChunkMap in_row(TRANS ? d.row_tab : d.col_tab, K, C);
  const float2* V = static_cast<const float2*>(d.vals) + (long long)b * mp * kp;
  const float2* x = a.x;
  const int r = a.r, t = threadIdx.x;

  // stage s: contraction rows k0 = s * KC .. + KC
  auto load = [&](int s, float* buf) {
    float* As = buf;
    float* Xs = buf + kASize;
    const int k0 = s * KC;
    if constexpr (TRANS) {  // V rows k0.., columns m0.. (output rows)
#pragma unroll
      for (int q = 0; q < KC * kRows / kThreads; ++q) {
        const int idx = t + q * kThreads;
        const int mm = idx / kRows, i = idx % kRows;
        const bool ok = k0 + mm < K && m0 + i < M;
        cp_async8(As + mm * kAT + 2 * i,
                  ok ? V + (long long)(k0 + mm) * kp + m0 + i : V, ok);
      }
    } else {  // V rows m0.. (output rows), columns k0..
#pragma unroll
      for (int q = 0; q < KC * kRows / kThreads; ++q) {
        const int idx = t + q * kThreads;
        const int i = idx / KC, kk = idx % KC;
        const bool ok = m0 + i < M && k0 + kk < K;
        cp_async8(As + i * kAF + 2 * kk,
                  ok ? V + (long long)(m0 + i) * kp + k0 + kk : V, ok);
      }
    }
    for (int idx = t; idx < KC * G::TRC; idx += kThreads) {
      const int kk = idx / G::TRC, c = idx % G::TRC;
      const long long row = k0 + kk < K ? in_row(b, k0 + kk) : -1;
      const bool ok = row >= 0 && row < a.x_rows && c0 + c < r;
      cp_async8(Xs + kk * G::XLD + 2 * c, ok ? x + row * r + c0 + c : x, ok);
    }
  };

  const int wc = t >> 5, lane = t & 31;  // warp wc: columns wc * 8 WN ..
  const int gid = lane >> 2, tig = lane & 3;
  const int live_rows = M - m0 < kRows ? M - m0 : kRows;
  const int live_t = (live_rows + 15) / 16;  // live m16 tiles
  float acc[4][WN][4];
#pragma unroll
  for (int tt = 0; tt < 4; ++tt)
#pragma unroll
    for (int u = 0; u < WN; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[tt][u][e] = 0.f;

  const int nst = (K + KC - 1) / KC;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nst) load(s, smem + s * G::STAGE);
    bst_mma::cp_async_commit();
  }
  for (int s = 0; s < nst; ++s) {
    bst_mma::cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nx = s + kStages - 1;
    if (nx < nst) load(nx, smem + (nx % kStages) * G::STAGE);
    bst_mma::cp_async_commit();
    const float* As = smem + (s % kStages) * G::STAGE;
    const float* Xs = As + kASize;
#pragma unroll
    for (int ks = 0; ks < KT / 8; ++ks) {
      const int kc = ks * 4 + tig;  // the stage's complex contraction row
      uint32_t bbig[WN][2], bsml[WN][2];
#pragma unroll
      for (int u = 0; u < WN; ++u)
        b_fragment<CONJ>(Xs, G::XLD, kc, (wc * WN + u) * 8 + gid, bbig[u],
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
            a_fragment(As + kc * kAT + 2 * i, As + kc * kAT + 2 * (i + 8),
                       abig[h], asml[h]);
          else
            a_fragment(As + i * kAF + 2 * kc, As + (i + 8) * kAF + 2 * kc,
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
  bst_mma::cp_async_wait<0>();

  // lane (gid, tig) holds rows gid and gid + 8 at real columns 2 tig, 2 tig
  // + 1 of each n8 tile: one complex value per row
#pragma unroll
  for (int tt = 0; tt < 4; ++tt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = tt * 16 + gid + 8 * h;
      if (i >= live_rows) continue;
      const long long row = out_row(b, m0 + i);
      if (row < 0 || row >= a.y_rows) continue;
#pragma unroll
      for (int u = 0; u < WN; ++u) {
        const int c = c0 + (wc * WN + u) * 4 + tig;
        if (c < r)
          atomicAdd(a.y + row * r + c,
                    make_float2(acc[tt][u][2 * h], acc[tt][u][2 * h + 1]));
      }
    }
  }
}

// mode (without kConj): 0 forward, 1 transpose, 2 symmetric (the forward
// items, then the transposed ones)
template <int WN, bool CONJ>
__global__ void __launch_bounds__(kThreads, WN == 4 ? 3 : 4)
    complex_mma_kernel(const Args a, long long items_f, int mode) {
  extern __shared__ __align__(16) float smem[];
  const long long g = blockIdx.x;
  if (mode == 0 || (mode == 2 && g < items_f))
    item_product<WN, false, CONJ>(a, g, smem);
  else
    item_product<WN, true, CONJ>(a, mode == 2 ? g - items_f : g, smem);
}

template <int WN, bool CONJ>
int launch(const Args& a, long long items_f, long long items, int mode,
           cudaStream_t s) {
  constexpr int smem = Geo<WN>::SMEM;
  // above 48 KB of dynamic shared memory, once per kernel and device
  static unsigned sized = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 32) return (int)cudaErrorInvalidDevice;
  if (!(sized & (1u << dev))) {
    e = cudaFuncSetAttribute(complex_mma_kernel<WN, CONJ>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return (int)e;
    sized |= 1u << dev;
  }
  const dim3 grid((unsigned)items,
                  (unsigned)((a.r + Geo<WN>::TRC - 1) / Geo<WN>::TRC));
  complex_mma_kernel<WN, CONJ><<<grid, kThreads, smem, s>>>(a, items_f,
                                                             mode);
  return (int)cudaGetLastError();
}

template <bool CONJ>
int launch_width(const Args& a, long long items_f, long long items, int mode,
                 cudaStream_t s) {
  if (a.r <= 16) return launch<1, CONJ>(a, items_f, items, mode, s);
  if (a.r <= 32) return launch<2, CONJ>(a, items_f, items, mode, s);
  return launch<4, CONJ>(a, items_f, items, mode, s);
}

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
  const bool conj = (mode & bst::kConj) != 0;
  mode &= ~bst::kConj;
  const long long items =
      mode == 0 ? items_f : (mode == 1 ? items_t : items_f + items_t);
  if (n <= 0 || mode < 0 || mode > 2 || items_f < 0 || items_t < 0 ||
      items > 0x7fffffffLL || (mode == 2 && x_rows != y_rows))
    return (int)cudaErrorInvalidValue;
  if (items == 0 || r <= 0 || y_rows == 0) return 0;
  const Args a{bst::DescTable{static_cast<const bst::BucketDesc*>(table), n,
                              {}},
               static_cast<const float2*>(x), static_cast<float2*>(y), r,
               x_rows, y_rows};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return conj ? launch_width<true>(a, items_f, items, mode, s)
              : launch_width<false>(a, items_f, items, mode, s);
}
