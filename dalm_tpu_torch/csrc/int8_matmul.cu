// K1 + K2: W8A8 int8 matmul for the frozen QLoRA base, and the per-row int8
// quantiser, hand-written for Hopper (sm_90a).
//
// Replaces dalm_tpu/kernels/int8_matmul.py:
//   K2  _rowquant_pallas / _rowquant_kernel      -> dalm_i8_rowquant (int8 out), dalm_i8_rowquant_bf16
//                                                   (the same values as bf16: K5's i8mxu fold route)
//   K1  _w8a8_fused_pallas / _w8a8_fused_kernel  -> dalm_i8_act_quant, dalm_i8_transpose, dalm_i8_gemm_fold
// and carries the int8 x int8 -> int32 products that the TPU version left to
// the compiler (_i8_dot_last): the dx product of the int8 backward
// (dalm_i8_gemm_nt) and, after the weight pre-pass, the unfused forward. Its
// GEMM also serves K5's per-column instance at prefill
// (dalm_tpu/kernels/int4_matmul.py:_int4pc_matmul_fwd_pallas, pallas_call at :299):
// dalm_i8_gemm_scaled, after K2 and csrc/int4_prefill.cu's int8 nibble pre-pass. The same scaled GEMM runs
// the calibrated forward (int8_matmul_cal, dalm_tpu/kernels/int8_matmul.py:310-406), after the calibrated-scale
// quantiser (dalm_i8_cal_quant: the XLA expressions clip(round(x / a_scale)) at :326 and
// clip(round(dy * scale / dy_scale)) + max |dy * scale| at :389) and the weight pre-pass.
//
// What bounds them on an H100 SXM (3.35 TB/s, 1,979 TOP/s int8). K2, K1's
// two pre-passes and the calibrated quantiser move each byte once and do a
// handful of operations per element: bytes. K2 is one block per row: an absmax pass, then a quantise
// pass that re-reads the row from L1/L2. The GEMM at the Llama shapes (M =
// 4608, K and N in the thousands) does thousands of int8 operations per
// byte: operations, 0.078 ms at 4608 x 4096 x 4096 (K5 pcol at prefill, M = 8192:
// 0.139 ms at K = N = 4096, 0.373 ms at 4096 x 11008 and 11008 x 4096).
//
// K1 is three launches on one stream (kernels/int8_matmul.py:w8a8_fused):
//   quantise pre-pass  xq (M, K) int8 and xs (M, K / bk) f32 from x (M, K), one
//                      warp per (row, k-block of bk): absmax, s = absmax / 127
//                      (1 for a zero block), q = clip(rint(x / s), +-127);
//   weight pre-pass    qt (N, K) = q (K, N)^T, through shared memory, so that
//                      both operands of the GEMM are K-major (integer wgmma
//                      has no transpose: both must be K-major in shared memory);
//   GEMM               out = ((sum over k-blocks of f32(xq_kb . qt_kb^T) * xs_kb)) * wscale.
// The TPU K1 quantises an M-stripe once and keeps it in VMEM across a
// sequential sweep over N; blocks here run in no order, so x is quantised once
// by the pre-pass and the GEMM reads the int8 scratch (L2-resident for a
// wave). Arithmetic is the plain version's: true division, round-half-even,
// the int32 sum of each k-block exact in any order, and the fold
// acc = acc + f32(p) * s with two roundings (__fmul_rn, __fadd_rn) in k-block
// order: bit-equal to w8a8_fused_ref.
//
// The GEMM (one template, three epilogues): TMA loads 128-deep int8 slices of A
// (M, K) and B (N, K), 128-byte swizzle, into a 4-slot ring of 1024-byte-aligned
// slots, each gated by a full and an empty mbarrier; one producer thread issues
// them. Two consumer warpgroups own 64 output rows each and run
// wgmma.m64nNk32.s32.s8.s8 (4 per slot, the descriptor start 32 bytes further
// each step). K1's instance (f32 or bf16 out) holds an s32 and an f32
// accumulator, 96 + 96 registers a thread at its 128 x 192 tile (a 128 x 128
// tile ran slower at all four Llama shapes on the H100, and 128 x 256 would need
// 256 registers): after the last slot of a k-block it waits for its
// products, folds the s32 sums into the f32 ones with the rows' scales, and
// the next k-block's first wgmma starts from zero (scale-d = 0); the epilogue
// multiplies by the column's weight scale and casts. The int32 instance
// (128 x 256 tile) stores the s32 sums over all of K. The scaled instance (K5
// pcol: the same tile, s32 sums over all of K, no f32 accumulator) stores
// bf16((f32(acc) * xs[m]) * wscale[n]), the plain version's two roundings, so it
// equals _ref_pcol bit for bit (f32(acc) is even exact: |acc| <= K * 127 * 8 stays
// below 2^24 up to K = 16,513). TMA fills rows beyond M
// and N and columns beyond K with zeros; the epilogue masks the stores. Tiles
// are walked in groups of 16 row tiles so that a wave's slices stay in L2.

#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ int quant1(float v, float s) {
    float r = rintf(__fdiv_rn(v, s));
    return (int)fminf(fmaxf(r, -127.f), 127.f);
}

// ---------------------------------------------------------------------------
// K1's quantise pre-pass: one warp per (row, k-block) of x (M, K), bk % 128 == 0.
// ---------------------------------------------------------------------------
constexpr int AQ_THREADS = 256;

__device__ __forceinline__ void store_packed(int8_t* o, const uint32_t (&w)[2], float) { *reinterpret_cast<uint32_t*>(o) = w[0]; }
__device__ __forceinline__ void store_packed(int8_t* o, const uint32_t (&w)[2], __nv_bfloat16) {
    *reinterpret_cast<uint2*>(o) = make_uint2(w[0], w[1]);
}

template <typename T>
__global__ void __launch_bounds__(AQ_THREADS)
act_quant_kernel(const T* __restrict__ x, int M, int K, int bk, int8_t* __restrict__ xq, float* __restrict__ xs) {
    constexpr int PER = 16 / (int)sizeof(T);  // elements in one 16-byte load
    const int nkb = K / bk, lane = threadIdx.x % 32;
    const long long item = (long long)blockIdx.x * (AQ_THREADS / 32) + threadIdx.x / 32;
    if (item >= (long long)M * nkb) return;
    const int row = (int)(item / nkb), kb = (int)(item % nkb);
    const T* p = x + (size_t)row * K + (size_t)kb * bk;
    float m = 0.f;
    for (int c = lane * PER; c < bk; c += 32 * PER) {
        uint4 raw = __ldg(reinterpret_cast<const uint4*>(p + c));
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int j = 0; j < PER; ++j) m = fmaxf(m, fabsf(to_float(e[j])));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    const float s = m > 0.f ? __fdiv_rn(m, 127.f) : 1.f;
    if (lane == 0) xs[item] = s;
    int8_t* o = xq + (size_t)row * K + (size_t)kb * bk;
    for (int c = lane * PER; c < bk; c += 32 * PER) {  // the second read of the block comes from L1
        uint4 raw = __ldg(reinterpret_cast<const uint4*>(p + c));
        const T* e = reinterpret_cast<const T*>(&raw);
        uint32_t w[2] = {0u, 0u};
#pragma unroll
        for (int j = 0; j < PER; ++j) w[j >> 2] |= (uint32_t)(quant1(to_float(e[j]), s) & 0xff) << (8 * (j & 3));
        store_packed(o + c, w, T());
    }
}

// ---------------------------------------------------------------------------
// The weight pre-pass: q (K, N) int8 -> qt (N, K), K % 16 == 0, N % 4 == 0.
// A block moves a 64 x 64 tile: it reads along N (a warp reads two rows of 64
// contiguous bytes), and writes along K (a warp writes 8 rows of qt, 64
// contiguous bytes each, 16 bytes a thread). Rows of the shared tile are 17
// words apart, so the byte-wise column reads meet at most 2-way bank conflicts.
// ---------------------------------------------------------------------------
constexpr int WT_TILE = 64;
constexpr int WT_THREADS = 256;
constexpr int WT_LD = 68;

__global__ void __launch_bounds__(WT_THREADS)
transpose_kernel(const int8_t* __restrict__ q, int K, int N, int8_t* __restrict__ qt) {
    __shared__ __align__(16) uint8_t t[WT_TILE][WT_LD];
    const int n0 = blockIdx.x * WT_TILE, k0 = blockIdx.y * WT_TILE, tid = threadIdx.x;
#pragma unroll
    for (int i = 0; i < WT_TILE * WT_TILE / 4 / WT_THREADS; ++i) {
        const int w = tid + i * WT_THREADS, k = w / 16, n = 4 * (w % 16);
        uint32_t v = 0u;
        if (k0 + k < K && n0 + n < N) v = __ldg(reinterpret_cast<const uint32_t*>(q + (size_t)(k0 + k) * N + n0 + n));
        *reinterpret_cast<uint32_t*>(&t[k][n]) = v;
    }
    __syncthreads();
    const int n = tid / 4, c = tid % 4;  // column n of q, K values [16 c, 16 c + 16) of the tile
    if (n0 + n >= N || k0 + 16 * c >= K) return;
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const int k = 16 * c + 4 * j;
        w[j] = (uint32_t)t[k][n] | ((uint32_t)t[k + 1][n] << 8) | ((uint32_t)t[k + 2][n] << 16) |
               ((uint32_t)t[k + 3][n] << 24);
    }
    *reinterpret_cast<uint4*>(qt + (size_t)(n0 + n) * K + k0 + 16 * c) = make_uint4(w[0], w[1], w[2], w[3]);
}

// ---------------------------------------------------------------------------
// The GEMM: its wgmma
// ---------------------------------------------------------------------------

// d (64 x 192 s32, the warpgroup's accumulator fragment) = A (64 x 32) . B (192 x 32)^T + (scale_d ? d : 0),
// both int8 read from shared memory through their descriptors.
__device__ __forceinline__ void wgmma_s8(int (&d)[96], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
        "}, %96, %97, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
          "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
          "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
          "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
          "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95])
        : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 256 s32, the warpgroup's accumulator fragment) = A (64 x 32) . B (256 x 32)^T + (scale_d ? d : 0),
// both int8 read from shared memory through their descriptors.
__device__ __forceinline__ void wgmma_s8(int (&d)[128], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
          "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
          "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
          "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
          "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
          "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
          "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
          "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
          "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
        : "l"(da), "l"(db), "r"(scale_d));
}

// ---------------------------------------------------------------------------
// The GEMM kernel
// ---------------------------------------------------------------------------

constexpr int SLOT_K = 128;                   // int8 per ring slot along K: 128 bytes, one swizzle row
constexpr int GROUP_M = 16;                   // row tiles walked together (L2 reuse)
constexpr int CONS = 2;                       // consumer warpgroups, 64 output rows each
constexpr int BM = 64 * CONS;                 // output tile rows
constexpr int STAGES = 4;                     // ring slots
constexpr int THREADS = 128 * (CONS + 1);     // warpgroup 0 produces, the others consume
constexpr int FOLD_BN = 192;                  // K1's tile columns
constexpr int I32_BN = 256;                   // the int32 instance's tile columns

template <int BN>
struct Ring {
    static constexpr int A_BYTES = BM * SLOT_K;
    static constexpr int STAGE_BYTES = A_BYTES + BN * SLOT_K;
    static constexpr int SMEM = STAGES * STAGE_BYTES + 1024;  // + slack to align the ring to 1024 bytes
};

__device__ __forceinline__ void store2(float* o, float a, float b) { *reinterpret_cast<float2*>(o) = make_float2(a, b); }
__device__ __forceinline__ void store2(__nv_bfloat16* o, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(o) = __halves2bfloat162(__float2bfloat16_rn(a), __float2bfloat16_rn(b));
}

// What the GEMM's epilogue does with the s32 sums.
enum Epilogue {
    EPI_I32 = 0,    // store them (int8_gemm_nt / kn)
    EPI_FOLD = 1,   // fold each k-block's into f32 with the rows' scales, then the columns' (K1)
    EPI_SCALE = 2,  // one sum over all of K, times the row's scale, then the column's (K5 pcol)
};

// tm_a: A (M, K) int8, box 128 x BM; tm_b: B (N, K) int8, box 128 x BN. One block per output tile.
// EPI_I32, OutT int32_t: out (M, N) = A . B^T in int32 (K % 16 == 0; kb_slots, xs and wscale unused).
// EPI_FOLD, OutT float / bf16 (K1): K % (128 kb_slots) == 0, N % 4 == 0, xs (M, K / (128 kb_slots)) the
// rows' scales per k-block of kb_slots slots, wscale (N,) the columns' scales.
// EPI_SCALE, OutT bf16 (K5 pcol): K % 16 == 0, N % 2 == 0, xs (M,) the rows' scales, wscale (N,) the
// columns'; kb_slots unused.
template <int BN, int EPI, typename OutT>
__global__ void __launch_bounds__(THREADS, 1)
i8_gemm_kernel(__grid_constant__ const CUtensorMap tm_a, __grid_constant__ const CUtensorMap tm_b, int M, int N,
               int K, int kb_slots, const float* __restrict__ xs, const float* __restrict__ wscale,
               OutT* __restrict__ out) {
    constexpr bool FOLD = EPI == EPI_FOLD;
    using R = Ring<BN>;
    extern __shared__ uint8_t smem_raw[];
    __shared__ __align__(8) uint64_t full[STAGES];
    __shared__ __align__(8) uint64_t empty[STAGES];
    uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);

    // the tile: row tiles in groups of GROUP_M, the rows of a group fastest
    const int tiles_m = (M + BM - 1) / BM, tiles_n = (N + BN - 1) / BN;
    const int per_group = GROUP_M * tiles_n;
    const int first_m = (int)(blockIdx.x / per_group) * GROUP_M;
    const int gm = min(tiles_m - first_m, GROUP_M);
    const int in_group = (int)(blockIdx.x % per_group);
    const int m0 = (first_m + in_group % gm) * BM, n0 = (in_group / gm) * BN;
    const int k_tiles = (K + SLOT_K - 1) / SLOT_K;

    const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], CONS);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (wg == 0) {
        // producer: one thread keeps the ring filled
        asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
        if (t == 0) {
            for (int kt = 0; kt < k_tiles; ++kt) {
                const int s = kt % STAGES;
                if (kt >= STAGES) mbar_wait(&empty[s], ((kt / STAGES) - 1) & 1);
                uint8_t* a = ring + s * R::STAGE_BYTES;
                mbar_expect_tx(&full[s], R::STAGE_BYTES);
                tma_load_2d(a, &tm_a, &full[s], kt * SLOT_K, m0);
                tma_load_2d(a + R::A_BYTES, &tm_b, &full[s], kt * SLOT_K, n0);
            }
        }
        return;
    }

    // consumer warpgroup c: output rows [m0 + 64 c, +64)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = wg - 1;
    // the accumulator fragment: warp w holds rows 16 w + lane / 4 (+ 8); register
    // 4 i + e holds column 8 i + 2 (lane % 4) + (e & 1), the row + 8 for e >= 2
    const int warp = t / 32, lane = t % 32;
    const int row = m0 + c * 64 + warp * 16 + lane / 4;
    int acc[BN / 2];
    float facc[FOLD ? BN / 2 : 1];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
#pragma unroll
    for (int i = 0; i < (FOLD ? BN / 2 : 1); ++i) facc[i] = 0.f;
    const int span = FOLD ? kb_slots : k_tiles;  // slots summed in int32 before a fold or the store
    const int nkb = FOLD ? k_tiles / kb_slots : 1;
    float s_lo = 0.f, s_hi = 0.f;
    for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % STAGES;
        const bool first = kt % span == 0;
        if constexpr (FOLD) {
            if (first) {  // this k-block's row scales, read while its products run
                const int kb = kt / span;
                s_lo = row < M ? __ldg(xs + (size_t)row * nkb + kb) : 0.f;
                s_hi = row + 8 < M ? __ldg(xs + (size_t)(row + 8) * nkb + kb) : 0.f;
            }
        }
        mbar_wait(&full[s], (kt / STAGES) & 1);
        const uint8_t* a = ring + s * R::STAGE_BYTES + c * 64 * SLOT_K;
        const uint8_t* b = ring + s * R::STAGE_BYTES + R::A_BYTES;
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < SLOT_K / 32; ++kk)
            wgmma_s8(acc, smem_desc(a + kk * 32), smem_desc(b + kk * 32), (first && kk == 0) ? 0 : 1);
        wgmma_commit();
        wgmma_wait<0>();
        if (t == 0) mbar_arrive(&empty[s]);
        fence_regs(acc);
        if constexpr (FOLD) {
            if (kt % span == span - 1) {
                // end of a k-block: acc_f32 += f32(p) * s, two roundings as the plain version makes
#pragma unroll
                for (int i = 0; i < BN / 2; ++i)
                    facc[i] = __fadd_rn(facc[i], __fmul_rn((float)acc[i], (i & 2) ? s_hi : s_lo));
            }
        }
    }

    float r_lo = 0.f, r_hi = 0.f;  // EPI_SCALE: the rows' scales
    if constexpr (EPI == EPI_SCALE) {
        r_lo = row < M ? __ldg(xs + row) : 0.f;
        r_hi = row + 8 < M ? __ldg(xs + row + 8) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
        const int col = n0 + 8 * i + 2 * (lane % 4);
        if (col >= N) continue;
        if constexpr (FOLD) {  // N % 4 == 0 and col is even: col + 1 < N too
            const float w0 = __ldg(wscale + col), w1 = __ldg(wscale + col + 1);
            if (row < M)
                store2(out + (size_t)row * N + col, __fmul_rn(facc[4 * i], w0), __fmul_rn(facc[4 * i + 1], w1));
            if (row + 8 < M)
                store2(out + (size_t)(row + 8) * N + col, __fmul_rn(facc[4 * i + 2], w0),
                       __fmul_rn(facc[4 * i + 3], w1));
        } else if constexpr (EPI == EPI_SCALE) {  // N % 2 == 0 and col is even: col + 1 < N too
            const float w0 = __ldg(wscale + col), w1 = __ldg(wscale + col + 1);
            if (row < M)
                store2(out + (size_t)row * N + col, __fmul_rn(__fmul_rn((float)acc[4 * i], r_lo), w0),
                       __fmul_rn(__fmul_rn((float)acc[4 * i + 1], r_lo), w1));
            if (row + 8 < M)
                store2(out + (size_t)(row + 8) * N + col, __fmul_rn(__fmul_rn((float)acc[4 * i + 2], r_hi), w0),
                       __fmul_rn(__fmul_rn((float)acc[4 * i + 3], r_hi), w1));
        } else {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int r = row + 8 * h;
                if (r >= M) continue;
                int32_t* o = out + (size_t)r * N + col;
                if ((N & 1) == 0) {
                    *reinterpret_cast<int2*>(o) = make_int2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
                } else {
                    o[0] = acc[4 * i + 2 * h];
                    if (col + 1 < N) o[1] = acc[4 * i + 2 * h + 1];
                }
            }
        }
    }
}

// The two tensor maps of A (M, K) and B (N, K) at a BN-column tile: 0, or 900 / 1000 + CUresult.
int gemm_maps(const void* a, const void* b, int M, int N, int K, int bn, CUtensorMap& ta, CUtensorMap& tb) {
    const int err = make_map(&ta, a, 1, M, K, BM);
    return err ? err : make_map(&tb, b, 1, N, K, bn);
}

template <int BN, int EPI, typename OutT>
int launch_gemm(const void* a, const void* b, int M, int N, int K, int kb_slots, const float* xs,
                const float* wscale, void* out, cudaStream_t stream) {
    CUtensorMap ta, tb;
    const int err = gemm_maps(a, b, M, N, K, BN, ta, tb);
    if (err) return err;
    const cudaError_t e = cudaFuncSetAttribute(i8_gemm_kernel<BN, EPI, OutT>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, Ring<BN>::SMEM);
    if (e != cudaSuccess) return (int)e;
    const int tiles = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
    i8_gemm_kernel<BN, EPI, OutT><<<tiles, THREADS, Ring<BN>::SMEM, stream>>>(ta, tb, M, N, K, kb_slots, xs, wscale,
                                                                              static_cast<OutT*>(out));
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K2: per-row symmetric int8. One block per row; the optional column scale
// (1, K) is multiplied in at the load (the backward's dy * weight scale).
// ---------------------------------------------------------------------------
constexpr int RQ_THREADS = 256;
template <typename T>
__device__ __forceinline__ float rq_value(const T* __restrict__ x, const float* __restrict__ cs, int c) {
    float v = to_float(x[c]);
    return cs ? __fmul_rn(v, __ldg(cs + c)) : v;
}

// Four consecutive values starting at column c (c % 4 == 0, K % 4 == 0).
__device__ __forceinline__ void rq_load4(const float* __restrict__ x, int c, float (&v)[4]) {
    float4 t = *reinterpret_cast<const float4*>(x + c);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void rq_load4(const __nv_bfloat16* __restrict__ x, int c, float (&v)[4]) {
    uint2 t = *reinterpret_cast<const uint2*>(x + c);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&t);
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = __bfloat162float(e[j]);
}
template <typename T>
__device__ __forceinline__ void rq_values4(const T* __restrict__ x, const float* __restrict__ cs, int c,
                                           float (&v)[4]) {
    rq_load4(x, c, v);
    if (cs) {
        float4 t = __ldg(reinterpret_cast<const float4*>(cs + c));
        v[0] = __fmul_rn(v[0], t.x); v[1] = __fmul_rn(v[1], t.y);
        v[2] = __fmul_rn(v[2], t.z); v[3] = __fmul_rn(v[3], t.w);
    }
}

// Four quantised values of a row at qr + c: packed int8, or as bf16 (exact: |q| <= 127), which the fold
// route of K5's i8mxu instance feeds to a bf16 GEMM without another pass over x.
__device__ __forceinline__ void rq_store4(int8_t* qr, int c, const int (&v)[4]) {
    uint32_t w = 0u;
#pragma unroll
    for (int j = 0; j < 4; ++j) w |= (uint32_t)(v[j] & 0xff) << (8 * j);
    *reinterpret_cast<uint32_t*>(qr + c) = w;
}
__device__ __forceinline__ void rq_store4(__nv_bfloat16* qr, int c, const int (&v)[4]) {
    __align__(8) __nv_bfloat162 p[2] = {__floats2bfloat162_rn((float)v[0], (float)v[1]),
                                        __floats2bfloat162_rn((float)v[2], (float)v[3])};
    *reinterpret_cast<uint2*>(qr + c) = *reinterpret_cast<const uint2*>(p);
}
__device__ __forceinline__ void rq_store1(int8_t* qr, int c, int v) { qr[c] = (int8_t)v; }
__device__ __forceinline__ void rq_store1(__nv_bfloat16* qr, int c, int v) { qr[c] = __float2bfloat16_rn((float)v); }

template <typename T, typename Q>
__global__ void __launch_bounds__(RQ_THREADS)
rowquant_kernel(const T* __restrict__ x, const float* __restrict__ cs, int K, Q* __restrict__ q,
                float* __restrict__ s) {
    __shared__ float red[RQ_THREADS / 32];
    __shared__ float scale_sh;
    const T* xr = x + (size_t)blockIdx.x * K;
    Q* qr = q + (size_t)blockIdx.x * K;
    const int tid = threadIdx.x;
    const bool vec = (K & 3) == 0;  // rows stay 4-element aligned

    float m = 0.f;
    if (vec) {
        for (int c = tid * 4; c < K; c += RQ_THREADS * 4) {
            float v[4];
            rq_values4(xr, cs, c, v);
#pragma unroll
            for (int j = 0; j < 4; ++j) m = fmaxf(m, fabsf(v[j]));
        }
    } else {
        for (int c = tid; c < K; c += RQ_THREADS) m = fmaxf(m, fabsf(rq_value(xr, cs, c)));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if ((tid & 31) == 0) red[tid >> 5] = m;
    __syncthreads();
    if (tid == 0) {
        float t = red[0];
#pragma unroll
        for (int i = 1; i < RQ_THREADS / 32; ++i) t = fmaxf(t, red[i]);
        float sc = t > 0.f ? __fdiv_rn(t, 127.f) : 1.f;
        scale_sh = sc;
        s[blockIdx.x] = sc;
    }
    __syncthreads();
    const float sc = scale_sh;

    if (vec) {
        for (int c = tid * 4; c < K; c += RQ_THREADS * 4) {
            float v[4];
            rq_values4(xr, cs, c, v);
            const int r[4] = {quant1(v[0], sc), quant1(v[1], sc), quant1(v[2], sc), quant1(v[3], sc)};
            rq_store4(qr, c, r);
        }
    } else {
        for (int c = tid; c < K; c += RQ_THREADS) rq_store1(qr, c, quant1(rq_value(xr, cs, c), sc));
    }
}

template <typename Q>
int rowquant_launch(const void* x, int is_bf16, const float* colscale, int R, int K, void* q, float* s,
                    cudaStream_t stream) {
    if (is_bf16)
        rowquant_kernel<__nv_bfloat16, Q><<<R, RQ_THREADS, 0, stream>>>(
            static_cast<const __nv_bfloat16*>(x), colscale, K, static_cast<Q*>(q), s);
    else
        rowquant_kernel<float, Q><<<R, RQ_THREADS, 0, stream>>>(static_cast<const float*>(x), colscale, K,
                                                                static_cast<Q*>(q), s);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The calibrated-scale quantiser: q = clip(rint(v / s), +-127) with ONE scale s for the whole tensor, read
// from device memory (the calibrated a_scale of the forward, or the dy_scale of the backward), so there is no
// absmax pass: one read of x, one write of q. The backward's mode multiplies each value by its column's weight
// scale first (v = dy * scale[c], as K2 does) and also takes max |v| on the same read (the next dy_scale),
// max-reduced per block and folded into *amax with one atomic: non-negative floats order as their bits.
// Each thread moves CQ_UNROLL vectors of 16 bytes per step of a grid-stride loop, loads first.
// ---------------------------------------------------------------------------
constexpr int CQ_THREADS = 256;
constexpr int CQ_UNROLL = 4;

template <typename T, bool COLS, bool AMAX>
__global__ void __launch_bounds__(CQ_THREADS)
cal_quant_kernel(const T* __restrict__ x, const float* __restrict__ sp, const float* __restrict__ cs, long long n,
                 int K, int8_t* __restrict__ q, unsigned int* __restrict__ amax) {
    constexpr int PER = 16 / (int)sizeof(T);
    const float s = __ldg(sp);
    const long long nvec = n / PER;
    const long long stride = (long long)gridDim.x * CQ_THREADS;
    float m = 0.f;
    for (long long v0 = (long long)blockIdx.x * CQ_THREADS + threadIdx.x; v0 < nvec; v0 += stride * CQ_UNROLL) {
        uint4 raw[CQ_UNROLL];
#pragma unroll
        for (int u = 0; u < CQ_UNROLL; ++u) {
            const long long v = v0 + u * stride;
            if (v < nvec) raw[u] = __ldg(reinterpret_cast<const uint4*>(x) + v);
        }
#pragma unroll
        for (int u = 0; u < CQ_UNROLL; ++u) {
            const long long v = v0 + u * stride;
            if (v >= nvec) break;
            const T* e = reinterpret_cast<const T*>(&raw[u]);
            const long long first = v * PER;
            int c = COLS ? (int)((unsigned)first % (unsigned)K) : 0;  // n < 2^31
            uint32_t w[2] = {0u, 0u};
#pragma unroll
            for (int j = 0; j < PER; ++j) {
                float val = to_float(e[j]);
                if constexpr (COLS) {
                    val = __fmul_rn(val, __ldg(cs + c));
                    c = c + 1 == K ? 0 : c + 1;
                }
                if constexpr (AMAX) m = fmaxf(m, fabsf(val));
                w[j >> 2] |= (uint32_t)(quant1(val, s) & 0xff) << (8 * (j & 3));
            }
            store_packed(q + first, w, T());
        }
    }
    // the tail beyond the last whole vector (n % PER values), by the first threads of block 0
    if (blockIdx.x == 0 && threadIdx.x < n - nvec * PER) {
        const long long i = nvec * PER + threadIdx.x;
        float val = to_float(x[i]);
        if constexpr (COLS) val = __fmul_rn(val, __ldg(cs + (int)((unsigned)i % (unsigned)K)));
        if constexpr (AMAX) m = fmaxf(m, fabsf(val));
        q[i] = (int8_t)quant1(val, s);
    }
    if constexpr (AMAX) {
        __shared__ float red[CQ_THREADS / 32];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
        if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
        __syncthreads();
        if (threadIdx.x == 0) {
            float t = red[0];
#pragma unroll
            for (int i = 1; i < CQ_THREADS / 32; ++i) t = fmaxf(t, red[i]);
            atomicMax(amax, __float_as_uint(t));
        }
    }
}

template <typename T, bool COLS, bool AMAX>
int cal_quant_launch(const void* x, const float* s, const float* cs, long long n, int K, void* q, float* amax,
                     int blocks, cudaStream_t stream) {
    cal_quant_kernel<T, COLS, AMAX><<<blocks, CQ_THREADS, 0, stream>>>(
        static_cast<const T*>(x), s, cs, n, K, static_cast<int8_t*>(q), reinterpret_cast<unsigned int*>(amax));
    return (int)cudaGetLastError();
}

template <typename T>
int cal_quant_dispatch(const void* x, const float* s, const float* cs, long long n, int K, void* q, float* amax,
                       cudaStream_t stream) {
    constexpr int PER = 16 / (int)sizeof(T);
    const long long nvec = n / PER;
    int sms = 0, dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    // enough blocks for every thread to hold CQ_UNROLL loads in flight, at most 8 blocks an SM
    long long want = (nvec + (long long)CQ_THREADS * CQ_UNROLL - 1) / ((long long)CQ_THREADS * CQ_UNROLL);
    const int blocks = (int)(want < 1 ? 1 : (want > 8LL * sms ? 8LL * sms : want));
    if (cs && amax) return cal_quant_launch<T, true, true>(x, s, cs, n, K, q, amax, blocks, stream);
    if (cs) return cal_quant_launch<T, true, false>(x, s, cs, n, K, q, amax, blocks, stream);
    if (amax) return cal_quant_launch<T, false, true>(x, s, cs, n, K, q, amax, blocks, stream);
    return cal_quant_launch<T, false, false>(x, s, cs, n, K, q, amax, blocks, stream);
}

}  // namespace

extern "C" {

// x (R, K) float32 (is_bf16 = 0) or bfloat16 (1); colscale (K,) float32 or null; q (R, K) int8.
int dalm_i8_rowquant(const void* x, int is_bf16, const float* colscale, int R, int K, void* q, float* s,
                     cudaStream_t stream) {
    return rowquant_launch<int8_t>(x, is_bf16, colscale, R, K, q, s, stream);
}

// The same with q (R, K) bfloat16: the quantised values, exact, as K5's fold route takes them.
int dalm_i8_rowquant_bf16(const void* x, int is_bf16, const float* colscale, int R, int K, void* q, float* s,
                          cudaStream_t stream) {
    return rowquant_launch<__nv_bfloat16>(x, is_bf16, colscale, R, K, q, s, stream);
}

// K1's quantise pre-pass: x (M, K) float32 (is_bf16 = 0) or bfloat16 (1) -> xq (M, K) int8 and
// xs (M, K / bk) float32. bk % 128 == 0 divides K; x 16-byte aligned.
int dalm_i8_act_quant(const void* x, int is_bf16, int M, int K, int bk, void* xq, float* xs, cudaStream_t stream) {
    const long long warps = (long long)M * (K / bk);
    const int blocks = (int)((warps + AQ_THREADS / 32 - 1) / (AQ_THREADS / 32));
    if (is_bf16)
        act_quant_kernel<__nv_bfloat16><<<blocks, AQ_THREADS, 0, stream>>>(
            static_cast<const __nv_bfloat16*>(x), M, K, bk, static_cast<int8_t*>(xq), xs);
    else
        act_quant_kernel<float><<<blocks, AQ_THREADS, 0, stream>>>(static_cast<const float*>(x), M, K, bk,
                                                                   static_cast<int8_t*>(xq), xs);
    return (int)cudaGetLastError();
}

// The weight pre-pass: q (K, N) int8 -> qt (N, K). K % 16 == 0, N % 4 == 0, both 16-byte aligned.
int dalm_i8_transpose(const void* q, int K, int N, void* qt, cudaStream_t stream) {
    const dim3 grid((N + WT_TILE - 1) / WT_TILE, (K + WT_TILE - 1) / WT_TILE);
    transpose_kernel<<<grid, WT_THREADS, 0, stream>>>(static_cast<const int8_t*>(q), K, N, static_cast<int8_t*>(qt));
    return (int)cudaGetLastError();
}

// K1's GEMM: out (M, N) float32 (is_bf16 = 0) or bfloat16 (1) = (sum over k-blocks of
// f32(xq_kb . qt_kb^T) * xs_kb) * wscale. bk % 128 == 0 divides K, N % 4 == 0. Returns 0, a CUDA
// error, or 900 / 1000 + CUresult when the tensor maps cannot be encoded.
int dalm_i8_gemm_fold(const void* xq, const void* qt, const float* xs, const float* wscale, int M, int N, int K,
                      int bk, int is_bf16, void* out, cudaStream_t stream) {
    if (is_bf16)
        return launch_gemm<FOLD_BN, EPI_FOLD, __nv_bfloat16>(xq, qt, M, N, K, bk / SLOT_K, xs, wscale, out, stream);
    return launch_gemm<FOLD_BN, EPI_FOLD, float>(xq, qt, M, N, K, bk / SLOT_K, xs, wscale, out, stream);
}

// a (M, C) int8 . b (N, C)^T int8 -> (M, N) int32. C % 16 == 0. Returns as dalm_i8_gemm_fold.
int dalm_i8_gemm_nt(const void* a, const void* b, int M, int C, int N, void* out, cudaStream_t stream) {
    return launch_gemm<I32_BN, EPI_I32, int32_t>(a, b, M, N, C, 0, nullptr, nullptr, out, stream);
}

// K5 pcol's GEMM: out (M, N) bf16 = bf16((f32(xq (M, K) . wn (N, K)^T) * xs[m]) * wscale[n]), xq and wn
// int8, xs (M,) and wscale (N,) f32. K % 16 == 0, N % 2 == 0. Returns as dalm_i8_gemm_fold.
int dalm_i8_gemm_scaled(const void* xq, const void* wn, const float* xs, const float* wscale, int M, int N, int K,
                        void* out, cudaStream_t stream) {
    return launch_gemm<I32_BN, EPI_SCALE, __nv_bfloat16>(xq, wn, M, N, K, 0, xs, wscale, out, stream);
}

// The calibrated-scale quantiser: q (n,) int8 = clip(rint(v / *s), +-127), v = x (n,) float32 (is_bf16 = 0) or
// bfloat16 (1) as a row-major (n / K, K) tensor, times colscale[column] when colscale is not null; when amax is
// not null, max |v| is folded into *amax (a float >= 0 the caller zeroed). x and q 16-byte aligned, n < 2^31.
int dalm_i8_cal_quant(const void* x, int is_bf16, const float* s, const float* colscale, long long n, int K,
                      void* q, float* amax, cudaStream_t stream) {
    if (is_bf16) return cal_quant_dispatch<__nv_bfloat16>(x, s, colscale, n, K, q, amax, stream);
    return cal_quant_dispatch<float>(x, s, colscale, n, K, q, amax, stream);
}

// dalm_i8_gemm_scaled's tensor maps for these operands, encoded and dropped: 0, or what it would return
// before it launches (900 / 1000 + CUresult), so a caller can refuse its route before the first launch.
int dalm_i8_gemm_scaled_maps(const void* xq, const void* wn, int M, int N, int K) {
    CUtensorMap ta, tb;
    return gemm_maps(xq, wn, M, N, K, I32_BN, ta, tb);
}

}  // extern "C"
