// Symmetric merged-patch SpMM on Hopper tensor cores (kernel B3 of the port).
//
// Replaces blocksparse_tpu/ops/patch_engine.py::_kern_mir (launched from
// _bucket_spmm_raw / patch_spmm for a symmetric plan).  A symmetric plan
// holds S = D + O + O^T with each stored off-diagonal block once; for every
// slot b, with V_b of shape [MP, KP], its KP/32 column chunks cc[b] and
// mk[b] leading chunks that hold off-diagonal blocks:
//   symmetric  Y[rs[b] : rs[b] + MP]  += V_b @ concat_j X[cc[b,j]*32 : +32]
//              Y[cc[b,j]*32 : +32]    += (V_b^T @ X[rs[b] : rs[b] + MP])[j*32 : +32]
//                                        for j < mk[b] only
//   adjoint    the transpose of that map (the backward pass's dX):
//              Y[cc[b,j]*32 : +32]    += (V_b^T @ X[rs[b] : rs[b] + MP])[j*32 : +32]
//                                        for every chunk j
//              Y[rs[b] : rs[b] + MP]  += V_b @ concat_{j < mk[b]} X[cc[b,j]*32 : +32]
// X and Y have the operand's n rows; a chunk id whose rows start at or past
// n is a sentinel (zero values), and rows past n read zero / are dropped.
//
// One launch, two block roles (blockIdx.x ranges; blockIdx.y = column tile):
//   owner blocks (first, one per output chunk c that receives transposed
//     contributions, in descending fan-in so the longest start first): keep
//     sum over the pairs (b, j) with cc[b, j] = c of
//     V_b[:, j*32 : +32]^T @ X[rs[b] : rs[b] + MP] in registers and add the
//     [32, TR] sum into Y once.  The pairs come from the owner tables
//     (own_chunk, own_ptr, own_pair = b * KC + j; ops/patch_engine.py
//     builds them, j < mk[b] in symmetric mode, every live chunk in adjoint
//     mode); n_own = 0 launches the forward blocks alone.
//   forward blocks (slot b, 64-row tile): V_b @ X[live chunks] into the
//     slot's row window -- every live chunk in symmetric mode, the chunks
//     j < mk[b] in adjoint mode.
// Both run tile_mma.cuh's tensor-core loop (rows in whole m16 tiles: a
// 48-row slot is three; columns 64 or 128, so at r = 128 a slot's V is
// staged once); sentinel chunks issue neither loads nor MMAs.  tier 0 is
// one TF32 pass (precision=None), tier 1 3xTF32 ("high", "highest").
//
// What bounds it on the card: 2 r flops per stored value and mirror (S's
// logical nnz x 2r), at the 3xTF32 rate (165 TFLOP/s) for tier 1; at tier 0
// the bytes of V and its mirrored columns, which the owner blocks read a
// second time (the price of adding each output chunk once).
//
// Race-freedom: every write to Y is an atomicAdd(float4*) into the zeroed
// output the wrapper allocates -- windows of different slots overlap, and
// an owner's chunk is also a window row of other slots.  Ownership cuts the
// transposed adds to one per (output chunk, column) instead of one per
// (pair, column), and fixes the summation order inside each owner block;
// the order across blocks still varies between runs.  The TPU kernel kept
// Y resident and relied on an in-order grid.
#include "tile_mma.cuh"

namespace {

using bst_mma::Tile;
constexpr int kCC = 32;  // column chunk width of the patch plan

struct SymArgs {
  const float* vals;
  const int* cc;
  const int* rs;
  const int* mk;
  const int* own_chunk;
  const int* own_ptr;
  const int* own_pair;
  int n_own;
  const float* x;
  float* y;
  int nb, MP, KP, r;
  long long n;
  int adjoint, vec, rtiles;
};

// Forward stage s: A = V_b[m0 : m0 + 64, kpos[s] : +32], B = the chunk's X rows.
template <class T>
struct ForwardStages {
  const float* V;  // V_b
  int KP, m0, mrows;
  const float* x;
  long long n;
  int r, c0;
  bool vec;
  const int* chunk;  // shared memory
  const int* kpos;
  __device__ __forceinline__ bool live(int) const { return true; }
  __device__ __forceinline__ void load(int s, float* As, float* Bs) const {
    const float* Vk = V + kpos[s];
    bst_mma::copy_tile<T::ROWS, T::KT>(
        As, T::A_LD,
        [&](int q) -> const float* {
          return q < mrows ? Vk + (long long)(m0 + q) * KP : nullptr;
        },
        bst_mma::AllCols{}, true, V);
    const long long base = (long long)chunk[s] * kCC;
    bst_mma::copy_tile<T::KT, T::TR>(
        Bs, T::B_LD,
        [&](int q) -> const float* {
          return base + q < n ? x + (base + q) * r + c0 : nullptr;
        },
        bst_mma::ColsBelow{r - c0}, vec, x);
  }
};

// Owner stage s: pair s / spp, rows (s % spp) * 16 .. + 16 of its slot:
// A = V_b[rows, j*32 : +32] (transposed layout), B = X[rs[b] + rows].
template <class T>
struct OwnerStages {
  const float* vals;
  const int* pair;  // this owner's pairs
  const int* rs;
  int MP, KP, KC, spp;
  const float* x;
  long long n;
  int r, c0;
  bool vec;
  __device__ __forceinline__ bool live(int) const { return true; }
  __device__ __forceinline__ void load(int s, float* As, float* Bs) const {
    const int p = __ldg(pair + s / spp), m0 = (s % spp) * T::KT;
    const int b = p / KC, j = p % KC, mrows = MP - m0;
    const float* V = vals + (long long)b * MP * KP + (long long)m0 * KP + j * kCC;
    bst_mma::copy_tile<T::KT, T::ROWS>(
        As, T::A_LD,
        [&](int q) -> const float* {
          return q < mrows ? V + (long long)q * KP : nullptr;
        },
        bst_mma::AllCols{}, true, vals);
    const long long w = (long long)__ldg(rs + b) + m0;
    bst_mma::copy_tile<T::KT, T::TR>(
        Bs, T::B_LD,
        [&](int q) -> const float* {
          return q < mrows && w + q < n ? x + (w + q) * r + c0 : nullptr;
        },
        bst_mma::ColsBelow{r - c0}, vec, x);
  }
};

// Tiles: forward 64 rows x TRW columns, 32 deep per stage; owner one
// 32-row chunk x TRW, OKT deep per stage (48: a 48-row slot's pair per
// stage; 16 for other slot heights).
template <int TRW>
using ForwardTile = Tile<false, 1, 4, TRW / 64, 32, 3>;
template <int TRW, int OKT>
using OwnerTile = Tile<true, 1, 2, TRW / 64, OKT, OKT == 48 ? 3 : 6>;

template <int TRW, int TIER, int OKT>
__global__ void __launch_bounds__(bst_mma::kThreads, 2)
    patch_sym_kernel(SymArgs a) {
  using F = ForwardTile<TRW>;
  using O = OwnerTile<TRW, OKT>;
  static_assert(F::TR == TRW && O::TR == TRW && O::ROWS == kCC, "tiles");
  extern __shared__ __align__(16) float smem[];
  const int c0 = blockIdx.y * TRW;
  const bst_mma::AddY add{a.y, a.n, a.r, c0, a.vec != 0};
  if ((int)blockIdx.x < a.n_own) {
    const int o = blockIdx.x;
    const int p0 = __ldg(a.own_ptr + o), p1 = __ldg(a.own_ptr + o + 1);
    const long long row0 = (long long)__ldg(a.own_chunk + o) * kCC;
    const int spp = (a.MP + O::KT - 1) / O::KT;
    const OwnerStages<O> st{a.vals, a.own_pair + p0, a.rs, a.MP, a.KP,
                            a.KP / kCC, spp, a.x, a.n, a.r, c0,
                            a.vec != 0};
    bst_mma::tile_gemm<O, TIER>(
        st, (p1 - p0) * spp, 2,
        [&](int row, int col, float4 v) { add(row0 + row, col, v); }, smem);
    return;
  }
  __shared__ int chunk[bst_mma::kMaxKC], kpos[bst_mma::kMaxKC];
  __shared__ int counts[bst_mma::kMaxKC / 32];
  const int idx = blockIdx.x - a.n_own;
  const int b = idx / a.rtiles, m0 = (idx % a.rtiles) * F::ROWS;
  const int KC = a.KP / kCC;
  const int limit = a.adjoint ? min(__ldg(a.mk + b), KC) : KC;
  const int nst = bst_mma::live_chunks(a.cc + (long long)b * KC, limit, a.n,
                                       chunk, kpos, counts);
  if (nst == 0) return;
  const int mrows = min(F::ROWS, a.MP - m0);
  const long long row0 = (long long)__ldg(a.rs + b) + m0;
  const ForwardStages<F> st{a.vals + (long long)b * a.MP * a.KP, a.KP, m0,
                            mrows, a.x, a.n, a.r, c0, a.vec != 0, chunk,
                            kpos};
  bst_mma::tile_gemm<F, TIER>(
      st, nst, (mrows + 15) / 16,
      [&](int row, int col, float4 v) {
        if (row < mrows) add(row0 + row, col, v);
      },
      smem);
}

template <int TRW, int TIER, int OKT>
int launch(const SymArgs& a, int ctiles, cudaStream_t s) {
  using F = ForwardTile<TRW>;
  using O = OwnerTile<TRW, OKT>;
  constexpr int smem = F::SMEM > O::SMEM ? F::SMEM : O::SMEM;
  static bool sized = false;  // above 48 KB once per kernel instance
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        patch_sym_kernel<TRW, TIER, OKT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  const dim3 grid(a.n_own + a.nb * a.rtiles, ctiles);
  patch_sym_kernel<TRW, TIER, OKT><<<grid, bst_mma::kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <int TRW, int TIER>
int launch_tier(const SymArgs& a, int ctiles, cudaStream_t s) {
  return a.MP % 48 == 0 ? launch<TRW, TIER, 48>(a, ctiles, s)
                        : launch<TRW, TIER, 16>(a, ctiles, s);
}

}  // namespace

// y ([n, r]) must be zeroed.  adjoint: 0 symmetric, 1 its transpose; the
// owner tables must be the ones of that mode (n_own owners).  tier: 0 one
// TF32 pass, 1 3xTF32.  vals must be 16-byte aligned.
extern "C" int bst_patch_sym_f32(const float* vals, const int* cc,
                                 const int* rs, const int* mk,
                                 const int* own_chunk, const int* own_ptr,
                                 const int* own_pair, int n_own,
                                 const float* x, float* y, int nb, int MP,
                                 int KP, int r, long long n, int adjoint,
                                 int tier, void* stream) {
  if (KP % kCC != 0 || KP / kCC > bst_mma::kMaxKC || tier < 0 || tier > 1 ||
      n_own < 0 || reinterpret_cast<uintptr_t>(vals) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (nb <= 0 || r <= 0 || MP <= 0 || n <= 0) return 0;
  const bool vec = r % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const int trw = r <= 64 ? 64 : 128;
  const SymArgs a{vals, cc, rs, mk, own_chunk, own_ptr, own_pair, n_own,
                  x, y, nb, MP, KP, r, n, adjoint, vec ? 1 : 0,
                  (MP + 63) / 64};
  const int ctiles = (r + trw - 1) / trw;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (trw == 64)
    return tier ? launch_tier<64, 1>(a, ctiles, s)
                : launch_tier<64, 0>(a, ctiles, s);
  return tier ? launch_tier<128, 1>(a, ctiles, s)
              : launch_tier<128, 0>(a, ctiles, s);
}
