// Hopper building blocks of kernel B2 (patch_spmm.cu: the forward;
// patch_spmm_tr.cu: the transposed product): shared-memory addresses,
// mbarriers, TMA tile loads and reduce-adds, the 128-byte-swizzle
// descriptor and wgmma TF32 products, plus the host side of TMA (tensor
// maps).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (declarations only)
#include <cuda_runtime.h>
#include <stdint.h>

namespace bst_tma {

// -- PTX: shared memory, mbarriers, TMA ------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Waits for the phase of parity `parity` to complete.  A wait that outlasts
// 2^28 polls (seconds; a stage takes microseconds) traps: a lost arrival
// ends the launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 28)) __trap();
  }
}

// box at coordinates (c0 innermost, c1) of `map` into dst; completes on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// the same for a 3-D map (c2 outermost)
__device__ __forceinline__ void tma_load3(void* dst, const CUtensorMap* map,
                                          uint64_t* bar, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// Reduce-add the box at src into `map` at coordinates (c0, c1, c2): the
// TMA unit adds every element in the L2 (each element's add atomic, out-of-
// range elements dropped) and reads src asynchronously.  The writes to src
// need fence_proxy_async() and a barrier first; src may be reused after
// bulk_wait_read() by the issuing thread.
__device__ __forceinline__ void tma_reduce_add3(const CUtensorMap* map,
                                                const void* src, int c0,
                                                int c1, int c2) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.3d.global.shared::cta.add.bulk_group "
      "[%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// generic-proxy writes to shared memory made visible to the TMA unit
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// barrier `id` (1 .. 15) among `threads` threads (whole warps)
__device__ __forceinline__ void named_bar(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Byte offset of element (row, col) of a [rows x 32] f32 box that TMA
// reads or writes under the 128-byte swizzle at a 1024-byte-aligned
// address: the 16-byte group col / 4 of each 128-byte row is XORed with
// row % 8.
__device__ __forceinline__ int sw128_offset(int row, int col) {
  return row * 128 + ((((col >> 2) ^ (row & 7)) << 4) | ((col & 3) << 2));
}

// -- PTX: wgmma ------------------------------------------------------------------

// Shared-memory descriptor of a K-major tile of 128-byte rows under the
// 128-byte swizzle (as TMA writes it): start address >> 4, leading offset
// 1 (unused in this layout), stride 1024 bytes between 8-row groups, layout
// type 1 (128-byte swizzle).  A k8 step of TF32 advances the start by 32
// bytes inside the swizzle atom.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// all but the last committed group done
__device__ __forceinline__ void wg_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// keep the compiler from moving accumulator traffic across wgmma
template <int K>
__device__ __forceinline__ void fence_regs(float (&d)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define BST_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define BST_D16(i) BST_D4(i), BST_D4(i + 4), BST_D4(i + 8), BST_D4(i + 12)
#define BST_R32                                                              \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31"
#define BST_R64                                                              \
  BST_R32                                                                    \
  ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, " \
  "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "   \
  "%60, %61, %62, %63"

// d [m64 x N] (+)= A [m64 x k8] B [k8 x N]: ss with A from shared memory,
// rs with A from registers (the m16n8k8 A fragment of each warp's 16 rows);
// scale 0 overwrites d.
template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void ss(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{" BST_R32 "}, %32, %33, p, 1, 1;\n}\n"
        : BST_D16(0), BST_D16(16)
        : "l"(da), "l"(db), "r"(scale));
  }
  __device__ __forceinline__ static void rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{" BST_R32 "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : BST_D16(0), BST_D16(16)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale));
  }
};

template <>
struct Wgmma<128> {
  __device__ __forceinline__ static void ss(float (&d)[64], uint64_t da,
                                            uint64_t db, int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{" BST_R64 "}, %64, %65, p, 1, 1;\n}\n"
        : BST_D16(0), BST_D16(16), BST_D16(32), BST_D16(48)
        : "l"(da), "l"(db), "r"(scale));
  }
  __device__ __forceinline__ static void rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{" BST_R64 "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : BST_D16(0), BST_D16(16), BST_D16(32), BST_D16(48)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale));
  }
};

#undef BST_D4
#undef BST_D16
#undef BST_R32
#undef BST_R64

// -- host side ---------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once at run time (the library links no
// libcuda); defined in patch_spmm.cu
cudaError_t encoder(EncodeTiled* out);

// A row-major f32 tensor of `rank` dimensions (dims[0] innermost; strides[i]
// in floats between consecutive indices of dimension i + 1), read in boxes
// of box[] under the 128-byte swizzle (box[0] = 32 floats: one 128-byte
// span); out-of-range elements read zero.
inline bool tensor_map_nd(EncodeTiled enc, CUtensorMap* m,
                          const float* base, int rank, const long long* dims,
                          const long long* strides, const int* box) {
  cuuint64_t d[3], s[2];
  cuuint32_t b[3], step[3];
  for (int i = 0; i < rank; ++i) {
    d[i] = (cuuint64_t)dims[i];
    b[i] = (cuuint32_t)box[i];
    step[i] = 1;
    if (i + 1 < rank) s[i] = (cuuint64_t)strides[i] * sizeof(float);
  }
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank,
             const_cast<float*>(base), d, s, b, step,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the 2-D case: [outer, inner] with row stride ld, boxes [box_outer, 32]
inline bool tensor_map(EncodeTiled enc, CUtensorMap* m, const float* base,
                       long long inner, long long outer, long long ld,
                       int box_outer) {
  const long long dims[2] = {inner, outer}, strides[1] = {ld};
  const int box[2] = {32, box_outer};
  return tensor_map_nd(enc, m, base, 2, dims, strides, box);
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace bst_tma
