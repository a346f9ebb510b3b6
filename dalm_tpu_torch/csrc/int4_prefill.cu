// K5 at prefill, rebuilt for Hopper (sm_90a). Two routes, each of two hand-written kernels:
//   prefill route (base, nf4): the 4-bit weight is dequantised once per call into a bf16
//     scratch (the pre-pass), then multiplied on wgmma with TMA-fed shared-memory rings (the GEMM);
//   fold route (groupmm, i8mxu): the pre-pass in its unscaled mode writes the bare nibbles
//     nib - 8 (exact in bf16), then a wgmma / TMA GEMM takes each scale group's two products
//     and folds them with their scales in registers, in group order (the fold GEMM).
// The pre-pass has a third unscaled mode that writes nib - 8 as int8: the int8 route of pcol
// (kernels/int4_matmul.py:int8_route), whose s8 GEMM lives in csrc/int8_matmul.cu.
//
// Replaces dalm_tpu/kernels/int4_matmul.py:_int4_matmul_fwd_pallas
// (pallas_call at :496) for its variants base / floorsplit (_int4_kernel :43,
// _floorsplit :151), nf4 (_nf4 :341) and groupmm / decomp (_int4_kernel_groupmm :78,
// _decomp :113), and its i8mxu variant (pallas_call at :464, _int4_kernel_i8mxu :199),
// for bfloat16 activations at many rows (prefill), and for base / nf4 at any rows where the
// group is no multiple of 16 (the fused kernel's k-step). Decode rows, float32 activations and
// pcol keep csrc/int4_matmul.cu; kernels/int4_matmul.py chooses.
//
// What it computes, as the plain versions in kernels/int4_matmul.py do:
//   pre-pass  Wt (N, K) bf16, Wt[n][k] = bf16(f32(decode(nib(k, n))) * scale4[k / group][n]),
//             decode = nib - 8 (base) or the NormalFloat4 codebook (nf4), from q4 (K/2, N)
//             uint8 in the half-split layout (packed row r holds K-row r in its low nibble
//             and K-row K/2 + r in its high one) and scale4 (K/group, N) f32; unscaled
//             (mode 2): Wn[n][k] = bf16(nib(k, n) - 8); (mode 3) the same as int8, Wn (N, K)
//             int8, the reference pcol kernel's lo / hi pairing (low nibbles in [0, K/2));
//   GEMM      y (M, N) = bf16(sum over k of f32(x[m][k] * Wt[n][k])), x (M, K) bf16;
//   fold GEMM acc = sum over the G = K / (2 group) groups, in order, of
//             (p_lo[g] * s_lo[g][n] + p_hi[g] * s_hi[g][n]), each product and sum rounded
//             once (__fmul_rn / __fadd_rn, no FMA), p_lo[g] the f32 product of A's columns
//             [g group, +group) and Wn's, p_hi[g] the same at K/2 + g group, s_lo = scale4[g],
//             s_hi = scale4[G + g]; y = bf16(acc) (groupmm, A = bf16(x)) or bf16(acc * xs[m])
//             (i8mxu, A = K2's xq written as bf16, xs its row scales).
// The prefill route gives y = bf16(x) @ bf16(dequant(W)) with f32 sums, K5's base / nf4:
// the weight is rounded to bf16 once, as there, so the split into two launches
// changes nothing but the order of the f32 sums. The fold route runs _fold_groups'
// arithmetic: groupmm differs from it only in the order of each group's f32 sums; for
// i8mxu every operand is an integer exact in bf16 (|xq| <= 127, nib - 8 in [-8, 7]) and a
// group's |p| <= group * 127 * 8 (16,256 at group 16, 130,048 at 128) < 2^24, so the f32
// products are the plain version's int32 sums and the route equals it bit for bit. One bf16
// GEMM serves both instances; i8mxu thereby gives up the int8 rate (its bound becomes the
// bf16 one). An s8 wgmma (k32) form for groups >= 32 would halve that bound and is not built.
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16, 67 TFLOP/s f32).
//   pre-pass: bytes. At (K, N) = (11008, 4096), group 16, it reads 22.5 MB of
//   nibbles and 11.3 MB of scales and writes 90.2 MB: 0.037 ms (unscaled: 0.034 ms;
//   int8: 1.5 K N bytes, 0.020 ms).
//   GEMM and fold GEMM: operations, at prefill's M = 8192: 2 M K N = 275 GFLOP at (4096, 4096),
//   0.278 ms (0.747 ms at (4096, 11008) and (11008, 4096)); its bytes (x, Wt, y)
//   take a third of that. csrc/int4_matmul.cu dequantises each weight again in
//   every 64-row block (128 times at M = 8192) on CUDA cores inside its product
//   loop; here each weight is dequantised once, in about 5% of the GEMM's bound.
//   The fold adds 4 f32 operations per output and group: 4 G M N, at (11008, 4096)
//   (group 16, G = 344) 4.6e10, 0.69 ms at 67 TFLOP/s, but as separate multiplies and
//   adds (no FMA) they issue at half that rate: 1.4 ms, above the tensor cores' 0.75.
//
// The fold GEMM's budget.
//   Registers: acc, p_lo and p_hi are three f32 fragments of the warpgroup's 64 x 128
//   tile, 3 x 64 registers a thread; with the addressing that needs the consumers' 240
//   (the producer drops to 24), so the prefill GEMM's 128 x 256 tile (3 x 128) cannot fold
//   and the tile is 128 x 128, two consumer warpgroups of 64 rows.
//   Group 16 (the down-projection, K/2 = 5504 = 128 * 43): per group two m64n128k16
//   products a consumer, about 256 tensor-core cycles an SM for both, against a fold of
//   64 values x 4 operations a thread, 512 CUDA-core issue cycles an SM for the arithmetic
//   alone and about 800 as compiled (32 scale loads and the loop's own instructions: some
//   400 a warp per group): the fold bounds it. Group 64 (the other six projections):
//   8 products a consumer a group against the same fold: the tensor cores and the L2
//   traffic of a 128 x 128 tile bound it.
//   Overlap: a consumer scales p_lo while its p_hi products run, and the two consumers
//   take turns to issue (named barriers), so one folds while the other's products run.
//   A consumer cannot run its next group's products under its own fold: ptxas serialises
//   every wgmma when a buffer the fold reads is written by a new product before a full
//   wgmma.wait_group 0 (reusing one buffer while the other is folded), and a second pair
//   of product buffers would need 320 registers.
//
// Design.
//   pre-pass: a block per 64 packed rows x 64 columns. It reads along N (a warp
//   reads 2 rows of 64 contiguous bytes of q4, and their scales), decodes into a
//   shared tile held [n][k] (rows of 66 bf16, so a warp's column of stores spreads
//   over the banks), then writes along K: 16 bytes a thread, 128 contiguous bytes
//   per (n, half) (the int8 mode: 64, packed from the bf16 tile). nf4's 16-entry codebook
//   sits in shared memory.
//   GEMM: x (M, K) and Wt (N, K) are both K-major, the canonical operands of
//   wgmma. A block owns a 128 x 256 output tile, 64 rows per consumer warpgroup
//   (two consumers, 3 ring slots, 144 KB of shared memory: the fastest, or level
//   with the fastest, of five tiles and rings timed on the H100; PERF.md section 6).
//   One producer thread issues TMA loads of 64-deep k slices of x (128 x 64) and
//   Wt (256 x 64), 128-byte swizzle, into the ring in dynamic shared memory, each
//   slot gated by a full and an empty mbarrier. Each consumer warpgroup runs
//   wgmma.m64n256k16 on its 64 rows (4 per slot), sums in f32 registers, and
//   frees the slot when its products are done. TMA fills rows beyond M and N
//   with zeros; the epilogue masks the stores and rounds once to bf16. Output tiles are walked in groups of 16 row tiles so that a wave's
//   slices of x and Wt stay in the 50 MB L2. The TMA descriptors are encoded per
//   call on the host (cuTensorMapEncodeTiled, fetched with cudaGetDriverEntryPoint:
//   no -lcuda) and passed by value as __grid_constant__ parameters.
//   fold GEMM: the same producer, ring and tile walk at a 128 x 128 tile. A slot holds
//   64-deep k slices of both halves of A (x's columns [64 kt, +64) and K/2 + the same)
//   and of Wn, through four 2-D tensor maps over the halves (so a box never crosses
//   K/2), and the scale rows of the groups that start in the slot (an f32 map without
//   swizzle, 1 to 4 rows a half): 68 KB a slot, 3 slots. The group's k16 steps a
//   template parameter (KPG = group / 16: 1, 2, 4, 8, one instance each); each group's
//   products start from zero (scale-d 0). Every consumer warp releases a slot after its
//   last read of it (the empty barrier counts 8 warps).

#include <cuda_bf16.h>
#include <stdint.h>

#include "flash_wgmma.cuh"
#include "hopper.cuh"
#include "int4_decode.cuh"

namespace {

// ---------------------------------------------------------------------------
// The pre-pass
// ---------------------------------------------------------------------------

constexpr int DQ_ROWS = 64;          // packed rows per block: 64 low-half and 64 high-half K values
constexpr int DQ_COLS = 64;          // columns per block
constexpr int DQ_THREADS = 256;
constexpr int DQ_LD = DQ_ROWS + 2;   // bf16 per [n] row of the shared tile (33 words)

// What a pre-pass writes: the weight scaled (base, nf4: the prefill route) or the bare
// nibbles nib - 8, unscaled, as bf16 (groupmm / i8mxu: the fold route scales after the product)
// or as int8 (pcol: the int8 route's s8 GEMM scales in its epilogue).
enum DequantMode { DQ_INT4 = 0, DQ_NF4 = 1, DQ_NIBBLES = 2, DQ_NIBBLES_I8 = 3 };

// q4 (half, N), scale4 (2 half / group, N; unread unscaled) -> wt (N, 2 half), bf16 or (DQ_NIBBLES_I8) int8.
// half % 32 == 0, group divides half, N % 8 == 0; block (bx, by) covers columns [64 bx, +64)
// and packed rows [64 by, +64).
template <int MODE>
__global__ void __launch_bounds__(DQ_THREADS)
dequant_t_kernel(const uint8_t* __restrict__ q4, const float* __restrict__ scale4, int half, int N, int group,
                 void* __restrict__ wt) {
    constexpr bool NF4 = MODE == DQ_NF4;
    constexpr bool UNSCALED = MODE == DQ_NIBBLES || MODE == DQ_NIBBLES_I8;
    __shared__ __align__(16) __nv_bfloat16 t[2][DQ_COLS][DQ_LD];
    __shared__ float cb[16];
    const int tid = threadIdx.x;
    if (NF4 && tid < 16) cb[tid] = kNF4[tid];
    __syncthreads();
    const int n0 = blockIdx.x * DQ_COLS, p0 = blockIdx.y * DQ_ROWS;
    const int tx = tid & 15, ty = tid >> 4;
    const int n = n0 + 4 * tx;  // N % 8 == 0: the thread's 4 columns lie all inside N or all beyond it
    if (n < N) {
#pragma unroll
        for (int i = 0; i < DQ_ROWS / 16; ++i) {
            const int r = ty + 16 * i, p = p0 + r;
            if (p >= half) break;
            const uint32_t q = __ldg(reinterpret_cast<const uint32_t*>(q4 + (size_t)p * N + n));
            float slo[4] = {1.f, 1.f, 1.f, 1.f}, shi[4] = {1.f, 1.f, 1.f, 1.f};
            if constexpr (!UNSCALED) {
                const int hi_row = half / group;  // scale row of K-row half + p is half / group + p / group
                const float4 sl = __ldg(reinterpret_cast<const float4*>(scale4 + (size_t)(p / group) * N + n));
                const float4 sh = __ldg(reinterpret_cast<const float4*>(scale4 + (size_t)(hi_row + p / group) * N + n));
                slo[0] = sl.x; slo[1] = sl.y; slo[2] = sl.z; slo[3] = sl.w;
                shi[0] = sh.x; shi[1] = sh.y; shi[2] = sh.z; shi[3] = sh.w;
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                float dlo, dhi;
                decode_pair<NF4>(q >> (8 * j), cb, dlo, dhi);
                if constexpr (UNSCALED) {  // nib - 8 is exact in bf16
                    t[0][4 * tx + j][r] = __float2bfloat16_rn(dlo);
                    t[1][4 * tx + j][r] = __float2bfloat16_rn(dhi);
                } else {
                    t[0][4 * tx + j][r] = __float2bfloat16_rn(__fmul_rn(dlo, slo[j]));
                    t[1][4 * tx + j][r] = __float2bfloat16_rn(__fmul_rn(dhi, shi[j]));
                }
            }
        }
    }
    __syncthreads();
    if constexpr (MODE == DQ_NIBBLES_I8) {
        // 2 halves x 64 columns x 4 chunks of 16 K values, each read from the bf16 tile (exact integers) and
        // packed to 16 int8; a warp writes 8 rows of 64 bytes
        int8_t* w8 = static_cast<int8_t*>(wt);
#pragma unroll
        for (int i = 0; i < 2 * DQ_COLS * (DQ_ROWS / 16) / DQ_THREADS; ++i) {
            const int id = tid + i * DQ_THREADS;
            const int h = id / (DQ_COLS * 4), nn = (id / 4) % DQ_COLS, c = id % 4;
            if (n0 + nn >= N || p0 + 16 * c >= half) continue;  // half % 32 == 0: a chunk lies inside or beyond
            const __nv_bfloat16* src = &t[h][nn][16 * c];
            uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
            for (int j = 0; j < 16; ++j)
                w[j >> 2] |= (uint32_t)((int)__bfloat162float(src[j]) & 0xff) << (8 * (j & 3));
            *reinterpret_cast<uint4*>(w8 + (size_t)(n0 + nn) * (2 * half) + h * half + p0 + 16 * c) =
                make_uint4(w[0], w[1], w[2], w[3]);
        }
    } else {
        // 2 halves x 64 columns x 8 chunks of 8 K values; a warp writes 4 rows of 128 bytes
        __nv_bfloat16* wb = static_cast<__nv_bfloat16*>(wt);
#pragma unroll
        for (int i = 0; i < 2 * DQ_COLS * (DQ_ROWS / 8) / DQ_THREADS; ++i) {
            const int id = tid + i * DQ_THREADS;
            const int h = id / (DQ_COLS * 8), nn = (id / 8) % DQ_COLS, c = id % 8;
            if (n0 + nn >= N || p0 + 8 * c >= half) continue;
            const uint32_t* src = reinterpret_cast<const uint32_t*>(&t[h][nn][8 * c]);
            *reinterpret_cast<uint4*>(wb + (size_t)(n0 + nn) * (2 * half) + h * half + p0 + 8 * c) =
                make_uint4(src[0], src[1], src[2], src[3]);
        }
    }
}

// ---------------------------------------------------------------------------
// The GEMM: its wgmma
// ---------------------------------------------------------------------------

constexpr int BK = 64;        // k slice per ring slot: 64 bf16 = 128 bytes, one swizzle row
constexpr int GROUP_M = 16;   // row tiles walked together (L2 reuse)

// d (64 x 256 f32, the warpgroup's accumulator fragment) += A (64 x 16) . B (256 x 16)^T,
// both bf16 read from shared memory through their descriptors.
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(da), "l"(db), "r"(1));
}

// ---------------------------------------------------------------------------
// The GEMM kernel
// ---------------------------------------------------------------------------

constexpr int CONS = 2;                       // consumer warpgroups, 64 output rows each
constexpr int BM = 64 * CONS;                 // output tile rows
constexpr int BN = 256;                       // output tile columns
constexpr int STAGES = 3;                     // ring slots
constexpr int A_BYTES = BM * BK * 2;
constexpr int B_BYTES = BN * BK * 2;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int SMEM = STAGES * STAGE_BYTES + 1024;  // + slack to align the ring to 1024 bytes
constexpr int THREADS = 128 * (CONS + 1);          // warpgroup 0 produces, the others consume

// tm_x: x (M, K) bf16, box 64 x BM; tm_w: Wt (N, K) bf16, box 64 x BN. K % 64 == 0,
// N % 8 == 0. One block per output tile; out (M, N) bf16.
__global__ void __launch_bounds__(THREADS, 1)
gemm_kernel(__grid_constant__ const CUtensorMap tm_x, __grid_constant__ const CUtensorMap tm_w,
            __nv_bfloat16* __restrict__ out, int M, int N, int K) {
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
    const int k_tiles = K / BK;

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
                uint8_t* a = ring + s * STAGE_BYTES;
                mbar_expect_tx(&full[s], STAGE_BYTES);
                tma_load_2d(a, &tm_x, &full[s], kt * BK, m0);
                tma_load_2d(a + A_BYTES, &tm_w, &full[s], kt * BK, n0);
            }
        }
    } else {
        // consumer warpgroup c: output rows [m0 + 64 c, +64)
        asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
        const int c = wg - 1;
        float d[BN / 2];
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) d[i] = 0.f;
        for (int kt = 0; kt < k_tiles; ++kt) {
            const int s = kt % STAGES;
            mbar_wait(&full[s], (kt / STAGES) & 1);
            const uint8_t* a = ring + s * STAGE_BYTES + c * 64 * BK * 2;
            const uint8_t* b = ring + s * STAGE_BYTES + A_BYTES;
            fence_regs(d);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk) wgmma_n256(d, smem_desc(a + kk * 32), smem_desc(b + kk * 32));
            wgmma_commit();
            wgmma_wait<0>();
            if (t == 0) mbar_arrive(&empty[s]);
            fence_regs(d);
        }
        // the accumulator fragment: warp w holds rows 16 w + lane / 4 (+ 8); register
        // 4 i + e holds column 8 i + 2 (lane % 4) + (e & 1), the row + 8 for e >= 2
        const int warp = t / 32, lane = t % 32;
        const int row = m0 + c * 64 + warp * 16 + lane / 4;
#pragma unroll
        for (int i = 0; i < BN / 8; ++i) {
            const int col = n0 + 8 * i + 2 * (lane % 4);
            if (col >= N) continue;  // N % 8 == 0 and col is even: col + 1 < N too
            if (row < M)
                *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * N + col) =
                    __floats2bfloat162_rn(d[4 * i], d[4 * i + 1]);
            if (row + 8 < M)
                *reinterpret_cast<__nv_bfloat162*>(out + (size_t)(row + 8) * N + col) =
                    __floats2bfloat162_rn(d[4 * i + 2], d[4 * i + 3]);
        }
    }
}

// ---------------------------------------------------------------------------
// The fold GEMM (groupmm and i8mxu at prefill)
// ---------------------------------------------------------------------------

constexpr int F_BN = 128;                          // output tile columns (BM = 128 rows, two consumers)
constexpr int F_STAGES = 3;                        // ring slots
constexpr int F_A = BM * BK * 2;                   // one half's slice of A: 128 rows x 64 bf16
constexpr int F_B = F_BN * BK * 2;                 // one half's slice of Wn: 128 columns x 64 bf16
constexpr int F_SROWS = 4;                         // scale rows a slot holds at most, per half
constexpr int F_SC = 2 * F_A + 2 * F_B;            // offset of the slot's scale rows
constexpr int F_STAGE = F_SC + 2 * F_SROWS * F_BN * 4;
constexpr int F_SMEM = F_STAGES * F_STAGE + 1024;  // + slack to align the ring to 1024 bytes

// Scale rows one slot stages per half: enough for every group whose first k16 step lies in the slot's four
// (KPG = group / 16 steps a group: 1, 2, 4 or 8). The slot kt holds rows [4 kt / KPG, + rows) of each half.
__host__ __device__ constexpr int fold_scale_rows(int kpg) { return kpg < 4 ? 4 / kpg : 1; }

// Issue one half's products of group g into d: KPG wgmma.m64n128k16 over the group's k16 steps, the first
// from zero (scale-d 0), as one commit group, after waiting for the slots they read to fill (the high half
// reads the slots the low half waited for).
template <int KPG>
__device__ __forceinline__ void fold_issue(float (&d)[64], const uint8_t* ring, uint64_t* full, int& waited, int g,
                                           int hi, int c) {
    for (const int last = ((g + 1) * KPG - 1) >> 2; waited <= last; ++waited)
        mbar_wait(&full[waited % F_STAGES], (waited / F_STAGES) & 1);
    fence_regs(d);
    wgmma_fence();
#pragma unroll
    for (int q = 0; q < KPG; ++q) {
        const int j = g * KPG + q, slot = j >> 2;
        const uint8_t* base = ring + (slot % F_STAGES) * F_STAGE;
        const uint8_t* a = base + hi * F_A + c * 64 * BK * 2 + (j & 3) * 32;
        const uint8_t* b = base + 2 * F_A + hi * F_B + (j & 3) * 32;
        wgmma_ss_n128(d, smem_desc(a), smem_desc(b), q != 0);
    }
    wgmma_commit();
}

// Two f32 from shared memory (the scale rows a slot holds).
__device__ __forceinline__ float2 lds_f2(const float* p) {
    float2 v;
    asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(smem_u32(p)));
    return v;
}

// The two consumers take turns to issue their products (named barriers 1 and 2, 256 threads: one consumer
// syncs, the other arrives), so that one warpgroup's products run while the other folds.
__device__ __forceinline__ void turn_wait(int c) {
    if (c == 0) asm volatile("bar.sync 1, 256;\n" ::: "memory");
    else asm volatile("bar.sync 2, 256;\n" ::: "memory");
}
__device__ __forceinline__ void turn_pass(int c) {
    if (c == 0) asm volatile("bar.arrive 2, 256;\n" ::: "memory");
    else asm volatile("bar.arrive 1, 256;\n" ::: "memory");
}

// The register fragment's columns (see gemm_kernel's epilogue): register 4 i + e holds column
// 8 i + 2 (lane % 4) + (e & 1). d *= s, column by column.
__device__ __forceinline__ void scale_cols(float (&d)[64], const float* s, int lane) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
        const float2 v = lds_f2(s + 8 * i + 2 * (lane & 3));
        d[4 * i] = __fmul_rn(d[4 * i], v.x);
        d[4 * i + 1] = __fmul_rn(d[4 * i + 1], v.y);
        d[4 * i + 2] = __fmul_rn(d[4 * i + 2], v.x);
        d[4 * i + 3] = __fmul_rn(d[4 * i + 3], v.y);
    }
}

// d += e * s, column by column, each product rounded before the sum.
__device__ __forceinline__ void add_scaled(float (&d)[64], const float (&e)[64], const float* s, int lane) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
        const float2 v = lds_f2(s + 8 * i + 2 * (lane & 3));
        d[4 * i] = __fadd_rn(d[4 * i], __fmul_rn(e[4 * i], v.x));
        d[4 * i + 1] = __fadd_rn(d[4 * i + 1], __fmul_rn(e[4 * i + 1], v.y));
        d[4 * i + 2] = __fadd_rn(d[4 * i + 2], __fmul_rn(e[4 * i + 2], v.x));
        d[4 * i + 3] = __fadd_rn(d[4 * i + 3], __fmul_rn(e[4 * i + 3], v.y));
    }
}

__device__ __forceinline__ void add_into(float (&acc)[64], const float (&v)[64]) {
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = __fadd_rn(acc[i], v[i]);
}

// The fold's shared state for one consumer warpgroup.
struct FoldState {
    const uint8_t* ring;
    uint64_t* full;
    uint64_t* empty;
    int G, k_tiles, c, lane;
    int waited, released;
};

// Fold group g: lo holds its low-half products (committed first), hi its high-half ones (committed last).
// lo = p_lo * s_lo while hi's products run, then lo = lo + p_hi * s_hi: the group's term, in lo. The slots every one of whose steps lies in groups <= g go back to the producer (each warp arrives
// after its own last read of them).
template <int KPG>
__device__ __forceinline__ void fold_group(FoldState& f, float (&lo)[64], float (&hi)[64], int g) {
    constexpr int SROWS = fold_scale_rows(KPG);
    const int slot = (g * KPG) >> 2, row = g - (4 * slot) / KPG;
    const float* s = reinterpret_cast<const float*>(f.ring + (slot % F_STAGES) * F_STAGE + F_SC);
    wgmma_wait<1>();
    fence_regs(lo);
    scale_cols(lo, s + row * F_BN, f.lane);
    wgmma_wait<0>();
    fence_regs(hi);
    add_scaled(lo, hi, s + (SROWS + row) * F_BN, f.lane);
    const int done = g == f.G - 1 ? f.k_tiles : ((g + 1) * KPG) >> 2;
    if (f.released < done) __syncwarp();
    for (; f.released < done; ++f.released)
        if (f.lane == 0) mbar_arrive(&f.empty[f.released % F_STAGES]);
}

// tm_alo / tm_ahi: A (M, K) bf16 seen as its two halves (M, half), box 64 x BM; tm_blo / tm_bhi: Wn (N, K)
// bf16 the same, box 64 x F_BN; tm_s: scale4 (2G, N) f32, box F_BN x fold_scale_rows(KPG). group = 16 KPG
// divides half,
// half % 8 == 0, N % 8 == 0. One block per output tile. out (M, N) bf16 = bf16(acc), or bf16(acc * xs[row])
// (I8), acc folded group by group in order as _fold_groups does.
template <bool I8, int KPG>
__global__ void __launch_bounds__(THREADS, 1)
fold_gemm_kernel(__grid_constant__ const CUtensorMap tm_alo, __grid_constant__ const CUtensorMap tm_ahi,
                 __grid_constant__ const CUtensorMap tm_blo, __grid_constant__ const CUtensorMap tm_bhi,
                 __grid_constant__ const CUtensorMap tm_s, const float* __restrict__ xs,
                 __nv_bfloat16* __restrict__ out, int M, int N, int half) {
    extern __shared__ uint8_t smem_raw[];
    __shared__ __align__(8) uint64_t full[F_STAGES];
    __shared__ __align__(8) uint64_t empty[F_STAGES];
    uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);

    const int tiles_m = (M + BM - 1) / BM, tiles_n = (N + F_BN - 1) / F_BN;
    const int per_group = GROUP_M * tiles_n;
    const int first_m = (int)(blockIdx.x / per_group) * GROUP_M;
    const int gm = min(tiles_m - first_m, GROUP_M);
    const int in_group = (int)(blockIdx.x % per_group);
    const int m0 = (first_m + in_group % gm) * BM, n0 = (in_group / gm) * F_BN;
    constexpr int SROWS = fold_scale_rows(KPG);
    const int k_tiles = (half + BK - 1) / BK, G = half / (16 * KPG);

    const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
    if (threadIdx.x == 0) {
        for (int s = 0; s < F_STAGES; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], CONS * 4);  // every consumer warp
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (wg == 0) {
        // producer: one thread keeps the ring filled; slot kt holds k columns [64 kt, +64) of both halves of
        // A and Wn, and the scale rows of the groups that start there
        asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
        if (t == 0) {
            constexpr uint32_t bytes = 2 * F_A + 2 * F_B + 2 * SROWS * F_BN * 4;
            for (int kt = 0; kt < k_tiles; ++kt) {
                const int s = kt % F_STAGES;
                if (kt >= F_STAGES) mbar_wait(&empty[s], ((kt / F_STAGES) - 1) & 1);
                uint8_t* a = ring + s * F_STAGE;
                const int g0 = (4 * kt) / KPG;
                mbar_expect_tx(&full[s], bytes);
                tma_load_2d(a, &tm_alo, &full[s], kt * BK, m0);
                tma_load_2d(a + F_A, &tm_ahi, &full[s], kt * BK, m0);
                tma_load_2d(a + 2 * F_A, &tm_blo, &full[s], kt * BK, n0);
                tma_load_2d(a + 2 * F_A + F_B, &tm_bhi, &full[s], kt * BK, n0);
                tma_load_2d(a + F_SC, &tm_s, &full[s], n0, g0);
                tma_load_2d(a + F_SC + SROWS * F_BN * 4, &tm_s, &full[s], n0, G + g0);
            }
        }
        return;
    }

    // consumer warpgroup c: output rows [m0 + 64 c, +64). Per group: its low-half products into x, its
    // high-half ones into y (two commit groups), x scaled while y's run, then folded into acc. The consumers
    // take turns to issue, so one's fold runs beside the other's products: a warpgroup cannot overlap its own
    // fold with its next products (see the header), so every group ends in a full wait before the next issue.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    FoldState f{ring, full, empty, G, k_tiles, wg - 1, t % 32, 0, 0};
    float acc[64], x[64], y[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    if (f.c == 1) turn_pass(1);  // consumer 0 issues first
    for (int g = 0; g < G; ++g) {
        turn_wait(f.c);
        fold_issue<KPG>(x, ring, full, f.waited, g, 0, f.c);
        fold_issue<KPG>(y, ring, full, f.waited, g, 1, f.c);
        if (f.c == 0 || g + 1 < G) turn_pass(f.c);  // every arrival is matched by a sync
        fold_group<KPG>(f, x, y, g);  // x: group g's term
        add_into(acc, x);
    }

    const int warp = t / 32, lane = t % 32;
    const int row = m0 + f.c * 64 + warp * 16 + lane / 4;
    float r0 = 1.f, r1 = 1.f;
    if constexpr (I8) {
        r0 = row < M ? __ldg(xs + row) : 0.f;
        r1 = row + 8 < M ? __ldg(xs + row + 8) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < F_BN / 8; ++i) {
        const int col = n0 + 8 * i + 2 * (lane % 4);
        if (col >= N) continue;  // N % 8 == 0 and col is even: col + 1 < N too
        float v[4] = {acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]};
        if constexpr (I8) {
            v[0] = __fmul_rn(v[0], r0);
            v[1] = __fmul_rn(v[1], r0);
            v[2] = __fmul_rn(v[2], r1);
            v[3] = __fmul_rn(v[3], r1);
        }
        if (row < M)
            *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * N + col) = __floats2bfloat162_rn(v[0], v[1]);
        if (row + 8 < M)
            *reinterpret_cast<__nv_bfloat162*>(out + (size_t)(row + 8) * N + col) = __floats2bfloat162_rn(v[2], v[3]);
    }
}

// The fold GEMM's five tensor maps: A's and Wn's halves, and scale4.
int fold_maps(const void* a, const void* wn, const float* scale4, int M, int N, int half, int group,
              CUtensorMap (&m)[5]) {
    const long long a_dims[2] = {half, M}, w_dims[2] = {half, N}, st[1] = {4LL * half};
    const long long s_dims[2] = {N, 2LL * (half / group)}, s_st[1] = {4LL * N};
    const int a_box[2] = {BK, BM}, w_box[2] = {BK, F_BN}, s_box[2] = {F_BN, fold_scale_rows(group / 16)};
    const char* ab = static_cast<const char*>(a);
    const char* wb = static_cast<const char*>(wn);
    int err = make_map_nd(&m[0], ab, 2, 2, a_dims, st, a_box);
    if (!err) err = make_map_nd(&m[1], ab + 2LL * half, 2, 2, a_dims, st, a_box);
    if (!err) err = make_map_nd(&m[2], wb, 2, 2, w_dims, st, w_box);
    if (!err) err = make_map_nd(&m[3], wb + 2LL * half, 2, 2, w_dims, st, w_box);
    if (!err) err = make_map_nd(&m[4], scale4, 4, 2, s_dims, s_st, s_box);
    return err;
}

bool fold_takes(int M, int N, int half, int group) {
    return M >= 1 && N >= 8 && N % 8 == 0 && half % 8 == 0 && (group == 16 || group == 32 || group == 64 ||
           group == 128) && half % group == 0;
}

template <bool I8, int KPG>
int fold_launch(const CUtensorMap (&m)[5], const float* xs, void* out, int M, int N, int half, cudaStream_t stream) {
    const cudaError_t e =
        cudaFuncSetAttribute(fold_gemm_kernel<I8, KPG>, cudaFuncAttributeMaxDynamicSharedMemorySize, F_SMEM);
    if (e != cudaSuccess) return (int)e;
    const int tiles = ((M + BM - 1) / BM) * ((N + F_BN - 1) / F_BN);
    fold_gemm_kernel<I8, KPG><<<tiles, THREADS, F_SMEM, stream>>>(m[0], m[1], m[2], m[3], m[4], xs,
                                                                  static_cast<__nv_bfloat16*>(out), M, N, half);
    return (int)cudaGetLastError();
}

template <bool I8>
int fold_launch(const CUtensorMap (&m)[5], const float* xs, void* out, int M, int N, int half, int group,
                cudaStream_t stream) {
    switch (group) {
        case 16: return fold_launch<I8, 1>(m, xs, out, M, N, half, stream);
        case 32: return fold_launch<I8, 2>(m, xs, out, M, N, half, stream);
        case 64: return fold_launch<I8, 4>(m, xs, out, M, N, half, stream);
        default: return fold_launch<I8, 8>(m, xs, out, M, N, half, stream);
    }
}

}  // namespace

extern "C" {

// The pre-pass. mode 0 (base): bf16(f32(nib - 8) * scale); 1 (nf4): the codebook's value times the scale;
// 2 (nibbles): bf16(nib - 8), no scale (scale4 unread, may be null); 3 (int8 nibbles): int8(nib - 8), no scale.
// q4 (half, N) uint8, scale4 (2 half / group, N) f32, wt (N, 2 half) bf16 (int8 in mode 3). half % 32 == 0,
// a group of any size dividing half (each packed row reads its own scale row: Gemma3-1B's K 1,152 packs at 8),
// N % 8 == 0, every pointer 16-byte aligned.
int dalm_i4_dequant_t(int mode, const void* q4, const float* scale4, int half, int N, int group, void* wt,
                      cudaStream_t stream) {
    const dim3 grid((N + DQ_COLS - 1) / DQ_COLS, (half + DQ_ROWS - 1) / DQ_ROWS);
    const uint8_t* q = static_cast<const uint8_t*>(q4);
    if (mode == DQ_NF4)
        dequant_t_kernel<DQ_NF4><<<grid, DQ_THREADS, 0, stream>>>(q, scale4, half, N, group, wt);
    else if (mode == DQ_NIBBLES)
        dequant_t_kernel<DQ_NIBBLES><<<grid, DQ_THREADS, 0, stream>>>(q, scale4, half, N, group, wt);
    else if (mode == DQ_NIBBLES_I8)
        dequant_t_kernel<DQ_NIBBLES_I8><<<grid, DQ_THREADS, 0, stream>>>(q, scale4, half, N, group, wt);
    else if (mode == DQ_INT4)
        dequant_t_kernel<DQ_INT4><<<grid, DQ_THREADS, 0, stream>>>(q, scale4, half, N, group, wt);
    else
        return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}

// The GEMM: out (M, N) bf16 = x (M, K) bf16 . wt (N, K)^T bf16, f32 sums. K % 64 == 0,
// N % 8 == 0, x and wt 16-byte aligned. Returns 0, a CUDA error, or 900 / 1000 + CUresult
// when the tensor maps cannot be encoded.
int dalm_bf16_gemm_nt(const void* x, const void* wt, int M, int N, int K, void* out, cudaStream_t stream) {
    CUtensorMap tx, tw;
    int err = make_map(&tx, x, 2, M, K, BM);
    if (err) return err;
    err = make_map(&tw, wt, 2, N, K, BN);
    if (err) return err;
    const cudaError_t e = cudaFuncSetAttribute(gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return (int)e;
    const int tiles = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
    gemm_kernel<<<tiles, THREADS, SMEM, stream>>>(tx, tw, static_cast<__nv_bfloat16*>(out), M, N, K);
    return (int)cudaGetLastError();
}

// The fold GEMM's tensor maps for these operands, encoded and dropped: 0, or what dalm_i4_fold_gemm would
// return before it launches (900 / 1000 + CUresult), so a caller can refuse the route before its first launch.
int dalm_i4_fold_maps(const void* a, const void* wn, const float* scale4, int M, int N, int half, int group) {
    if (!fold_takes(M, N, half, group)) return (int)cudaErrorInvalidValue;
    CUtensorMap m[5];
    return fold_maps(a, wn, scale4, M, N, half, group, m);
}

// The fold GEMM: a (M, K) bf16 (groupmm: x; i8mxu: xq as bf16), wn (N, K) bf16 = nib - 8 (the pre-pass, mode 2),
// scale4 (2 half / group, N) f32; out (M, N) bf16 = bf16(fold) or bf16(fold * xs[row]) (i8 = 1, xs (M,) f32),
// fold = sum over the groups in order of (p_lo * s_lo + p_hi * s_hi), each p a group's f32 product. K = 2 half,
// half % 8 == 0, group % 16 == 0 dividing half, N % 8 == 0, every pointer 16-byte aligned. Returns 0, a CUDA
// error, or 900 / 1000 + CUresult when the tensor maps cannot be encoded.
int dalm_i4_fold_gemm(int i8, const void* a, const void* wn, const float* scale4, const float* xs, int M, int N,
                      int half, int group, void* out, cudaStream_t stream) {
    if (!fold_takes(M, N, half, group) || (i8 && !xs)) return (int)cudaErrorInvalidValue;
    CUtensorMap m[5];
    const int err = fold_maps(a, wn, scale4, M, N, half, group, m);
    if (err) return err;
    return i8 ? fold_launch<true>(m, xs, out, M, N, half, group, stream)
              : fold_launch<false>(m, xs, out, M, N, half, group, stream);
}

}  // extern "C"
