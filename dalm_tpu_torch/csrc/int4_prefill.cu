// K5 at prefill, rebuilt for Hopper (sm_90a): the 4-bit weight is dequantised
// once per call into a bf16 scratch (the pre-pass), then multiplied on wgmma
// with TMA-fed shared-memory rings (the GEMM). Two hand-written kernels.
//
// Replaces dalm_tpu/kernels/int4_matmul.py:_int4_matmul_fwd_pallas
// (pallas_call at :496) for its variants base / floorsplit (_int4_kernel :43,
// _floorsplit :151) and nf4 (_nf4 :341), for bfloat16 activations at many rows
// (prefill). Decode rows, float32 activations and the other instances keep
// csrc/int4_matmul.cu; kernels/int4_matmul.py chooses.
//
// What it computes, as the plain versions in kernels/int4_matmul.py do:
//   pre-pass  Wt (N, K) bf16, Wt[n][k] = bf16(f32(decode(nib(k, n))) * scale4[k / group][n]),
//             decode = nib - 8 (base) or the NormalFloat4 codebook (nf4), from q4 (K/2, N)
//             uint8 in the half-split layout (packed row r holds K-row r in its low nibble
//             and K-row K/2 + r in its high one) and scale4 (K/group, N) f32;
//   GEMM      y (M, N) = bf16(sum over k of f32(x[m][k] * Wt[n][k])), x (M, K) bf16.
// Together they give y = bf16(x) @ bf16(dequant(W)) with f32 sums, K5's base / nf4:
// the weight is rounded to bf16 once, as there, so the split into two launches
// changes nothing but the order of the f32 sums.
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16).
//   pre-pass: bytes. At (K, N) = (11008, 4096), group 16, it reads 22.5 MB of
//   nibbles and 11.3 MB of scales and writes 90.2 MB: 0.037 ms.
//   GEMM: operations, at prefill's M = 8192: 2 M K N = 275 GFLOP at (4096, 4096),
//   0.278 ms (0.747 ms at (4096, 11008) and (11008, 4096)); its bytes (x, Wt, y)
//   take a third of that. csrc/int4_matmul.cu dequantises each weight again in
//   every 64-row block (128 times at M = 8192) on CUDA cores inside its product
//   loop; here each weight is dequantised once, in about 5% of the GEMM's bound.
//
// Design.
//   pre-pass: a block per 64 packed rows x 64 columns. It reads along N (a warp
//   reads 2 rows of 64 contiguous bytes of q4, and their scales), decodes into a
//   shared tile held [n][k] (rows of 66 bf16, so a warp's column of stores spreads
//   over the banks), then writes along K: 16 bytes a thread, 128 contiguous bytes
//   per (n, half). nf4's 16-entry codebook sits in shared memory.
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

#include <cuda_bf16.h>
#include <stdint.h>

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

// q4 (half, N), scale4 (2 half / group, N) -> wt (N, 2 half). half % 32 == 0,
// group divides half, N % 8 == 0; block (bx, by) covers columns [64 bx, +64)
// and packed rows [64 by, +64).
template <bool NF4>
__global__ void __launch_bounds__(DQ_THREADS)
dequant_t_kernel(const uint8_t* __restrict__ q4, const float* __restrict__ scale4, int half, int N, int group,
                 __nv_bfloat16* __restrict__ wt) {
    __shared__ __align__(16) __nv_bfloat16 t[2][DQ_COLS][DQ_LD];
    __shared__ float cb[16];
    const int tid = threadIdx.x;
    if (NF4 && tid < 16) cb[tid] = kNF4[tid];
    __syncthreads();
    const int n0 = blockIdx.x * DQ_COLS, p0 = blockIdx.y * DQ_ROWS;
    const int tx = tid & 15, ty = tid >> 4;
    const int n = n0 + 4 * tx;  // N % 8 == 0: the thread's 4 columns lie all inside N or all beyond it
    const int hi_row = half / group;  // scale row of K-row half + p is half / group + p / group
    if (n < N) {
#pragma unroll
        for (int i = 0; i < DQ_ROWS / 16; ++i) {
            const int r = ty + 16 * i, p = p0 + r;
            if (p >= half) break;
            const uint32_t q = __ldg(reinterpret_cast<const uint32_t*>(q4 + (size_t)p * N + n));
            const float4 sl = __ldg(reinterpret_cast<const float4*>(scale4 + (size_t)(p / group) * N + n));
            const float4 sh = __ldg(reinterpret_cast<const float4*>(scale4 + (size_t)(hi_row + p / group) * N + n));
            const float slo[4] = {sl.x, sl.y, sl.z, sl.w}, shi[4] = {sh.x, sh.y, sh.z, sh.w};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                float dlo, dhi;
                decode_pair<NF4>(q >> (8 * j), cb, dlo, dhi);
                t[0][4 * tx + j][r] = __float2bfloat16_rn(__fmul_rn(dlo, slo[j]));
                t[1][4 * tx + j][r] = __float2bfloat16_rn(__fmul_rn(dhi, shi[j]));
            }
        }
    }
    __syncthreads();
    // 2 halves x 64 columns x 8 chunks of 8 K values; a warp writes 4 rows of 128 bytes
#pragma unroll
    for (int i = 0; i < 2 * DQ_COLS * (DQ_ROWS / 8) / DQ_THREADS; ++i) {
        const int id = tid + i * DQ_THREADS;
        const int h = id / (DQ_COLS * 8), nn = (id / 8) % DQ_COLS, c = id % 8;
        if (n0 + nn >= N || p0 + 8 * c >= half) continue;
        const uint32_t* src = reinterpret_cast<const uint32_t*>(&t[h][nn][8 * c]);
        *reinterpret_cast<uint4*>(wt + (size_t)(n0 + nn) * (2 * half) + h * half + p0 + 8 * c) =
            make_uint4(src[0], src[1], src[2], src[3]);
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

}  // namespace

extern "C" {

// The pre-pass. nf4: decode through the codebook; q4 (half, N) uint8, scale4
// (2 half / group, N) f32, wt (N, 2 half) bf16. half % 32 == 0, group % 16 == 0
// dividing half, N % 8 == 0, every pointer 16-byte aligned.
int dalm_i4_dequant_t(int nf4, const void* q4, const float* scale4, int half, int N, int group, void* wt,
                      cudaStream_t stream) {
    const dim3 grid((N + DQ_COLS - 1) / DQ_COLS, (half + DQ_ROWS - 1) / DQ_ROWS);
    if (nf4)
        dequant_t_kernel<true><<<grid, DQ_THREADS, 0, stream>>>(static_cast<const uint8_t*>(q4), scale4, half, N, group,
                                                                static_cast<__nv_bfloat16*>(wt));
    else
        dequant_t_kernel<false><<<grid, DQ_THREADS, 0, stream>>>(static_cast<const uint8_t*>(q4), scale4, half, N,
                                                                 group, static_cast<__nv_bfloat16*>(wt));
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

}  // extern "C"
