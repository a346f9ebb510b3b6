// Hopper (sm_90a) building blocks that csrc/int4_prefill.cu, csrc/int8_matmul.cu
// and csrc/flash_fwd_wgmma.cu share: mbarriers, TMA loads of 2-D and 4-D tiles
// into 128-byte-swizzled shared memory, wgmma descriptors (K-major and MN-major)
// and synchronisation, and the host-side tensor-map encoder for strided tensors
// (fetched from the driver at run time, so nothing links -lcuda).
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
                 : "memory");
}

// Add bytes to the transaction count of the barrier's current phase without arriving.
__device__ __forceinline__ void mbar_expect_tx_only(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
        "@!p bra WAIT;\n"
        "}\n" ::"r"(smem_u32(bar)),
        "r"(parity)
        : "memory");
}

// Fetch a tensor map (a __grid_constant__ parameter) into the descriptor cache ahead of its first copy.
__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// One box of a 2-D tensor map into shared memory; completion counted in bytes on bar.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
        ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
        : "memory");
}

// One box of a 4-D tensor map (coordinates innermost first).
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1, int c2,
                                            int c3) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
        ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
        "r"(c3)
        : "memory");
}

// A wgmma shared-memory descriptor for a K-major tile written by TMA with the
// 128-byte swizzle: rows of 128 bytes, 8-row atoms 1024 bytes apart (SBO), the
// leading offset unused by this layout (1), layout type 1 (128B) in bits 62-63.
// The tile base is 1024-byte aligned; a k step of 32 bytes (16 bf16, 32 int8)
// adds 32 bytes.
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
    return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// The same for a bf16 tile that is MN-major (the contraction runs along its rows; read with the transpose
// bit): TMA wrote it in boxes of rows of 128 bytes = 64 MN values, 128-byte swizzle. 8-row atoms along the
// contraction lie 1024 bytes apart (SBO); the next 64 MN values lie mn_stride bytes on (LBO: the next box).
// A k step of 16 rows adds 2048 bytes.
__device__ __forceinline__ uint64_t smem_desc_mn(const void* p, uint32_t mn_stride) {
    return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)((mn_stride >> 4) & 0x3FFF) << 16) | (64ull << 32) |
           (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() { asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory"); }

// Keep the compiler from moving accumulator reads or writes across the asynchronous products.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
    for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
    for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[R]) {
#pragma unroll
    for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// ---------------------------------------------------------------------------
// Host side: tensor maps
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

constexpr int ERR_NO_ENCODER = 900;   // the driver has no cuTensorMapEncodeTiled
constexpr int ERR_ENCODE = 1000;      // + the CUresult of a refused tensor map

EncodeTiled encode_tiled() {
    static EncodeTiled fn = nullptr;
    if (!fn) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
        const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
        const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
        if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
    }
    return fn;
}

// A strided tensor of `rank` (2..5) dimensions, innermost first: dims[i] values along dimension i, the
// innermost contiguous, strides[i - 1] bytes from one index of dimension i >= 1 to the next (any order: a
// (B, H, S, D) view of (B, S, H, D) storage is fine). Values of `elem` bytes (2: bf16, 1: int8), boxes of box[i]
// values with box[0] * elem == 128 (one swizzle row), 128-byte swizzle, zeros beyond every edge, so a box that
// overhangs dimension i never reads the next index of dimension i + 1. The base and every stride must be
// multiples of 16 bytes, each stride below 2^40 (the driver refuses the rest: ERR_ENCODE + its CUresult).
int make_map_nd(CUtensorMap* map, const void* base, int elem, int rank, const long long* dims,
                const long long* strides, const int* box) {
    const EncodeTiled fn = encode_tiled();
    if (!fn) return ERR_NO_ENCODER;
    cuuint64_t d[5], st[4];
    cuuint32_t bx[5], step[5];
    for (int i = 0; i < rank; ++i) {
        d[i] = (cuuint64_t)dims[i];
        bx[i] = (cuuint32_t)box[i];
        step[i] = 1;
        if (i) st[i - 1] = (cuuint64_t)strides[i - 1];
    }
    const CUresult r = fn(map, elem == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8,
                          (cuuint32_t)rank, const_cast<void*>(base), d, st, bx, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : ERR_ENCODE + (int)r;
}

// A (rows, cols) row-major tensor of `elem` bytes a value (2: bf16, 1: int8), boxes of box_rows rows x
// 128 bytes, 128-byte swizzle, zeros beyond its edges. cols * elem must be a multiple of 16.
int make_map(CUtensorMap* map, const void* base, int elem, int rows, int cols, int box_rows) {
    const long long dims[2] = {cols, rows}, strides[1] = {(long long)cols * elem};
    const int box[2] = {128 / elem, box_rows};
    return make_map_nd(map, base, elem, 2, dims, strides, box);
}

}  // namespace
