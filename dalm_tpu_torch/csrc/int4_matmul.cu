// K5's fused route: the int4 weight-dequant matmul at decode, hand-written for
// Hopper (sm_90a). One template, five instances, one launch per call.
//
// Replaces dalm_tpu/kernels/int4_matmul.py:
//   _int4_matmul_fwd_pallas, variants base / floorsplit   -> i4_kernel<BASE, T>    (mode 0)
//   _int4_matmul_fwd_pallas, variants groupmm / decomp    -> i4_kernel<GROUPMM, T> (mode 1)
//   _int4_matmul_fwd_pallas, variant nf4                  -> i4_kernel<NF4, T>     (mode 2)
//   _int4_matmul_fwd_pallas, variant i8mxu                -> i4_kernel<I8MXU, T>   (mode 3)
//   _int4pc_matmul_fwd_pallas (_int4_kernel_pcol)         -> i4_kernel<PCOL, T>    (mode 4)
// each for float32 and bfloat16 activations / outputs, and base / nf4 once more
// for groups of 8 (i4_kernel<BASE|NF4, T, true>: Gemma3-1B's K 1,152 packs at 8).
// The wrapper sends here every call of the fused route: decode's few rows, bf16
// calls below M_PREFILL rows and f32 calls at any M (kernels/int4_matmul.py:_route).
//
// What they compute. y (M, N) = x (M, K) . W with W held as q4 (K/2, N) uint8
// in the half-split layout (packed row r: K-row r in the low nibble, K-row
// K/2 + r in the high one) and f32 scales scale4 (K/group, N), or (1, N) per
// column, with the plain versions' arithmetic (kernels/int4_matmul.py):
//   base / nf4   w = bf16(f32(decode(nib)) * scale[g]) before the product
//                (decode: nib - 8, or the NormalFloat4 codebook); bf16 products,
//                f32 sums;
//   groupmm      per group p = bf16(x) . (nib - 8) in f32, then acc += p_lo *
//                s_lo[g] + p_hi * s_hi[g] with __fmul_rn / __fadd_rn, in group
//                order;
//   i8mxu        the same fold on exact int8 x int8 -> int32 products of K2's
//                xq, then acc * xs[row];
//   pcol         one int32 sum over all of K, then (f32(acc) * xs[row]) * s[col].
// f32 x is rounded to bf16 on its way into the products.
//
// What bounds it on an H100. At decode (M = 32) the weight is read once at 0.5
// byte a weight plus its scales, and each weight pair costs 128 operations on
// the tensor cores: bound by bytes (10.0 MB = 0.0030 ms at (K, N) = (4096,
// 4096)). At 3.35 TB/s an SM receives about 13 bytes a cycle, 26 weights, so
// the decode of a weight must stay within about 4-5 thread-instructions.
//
// The design, for those two limits:
//   - Swapped product (yT = W^T xT). The dequantised weight is the 16-row A
//     operand of mma.sync, built in registers from the nibbles (it never goes
//     through shared memory as bf16), and the x rows are the n of the product,
//     8 at a time: n8 tiles wholly beyond M run no product, so decode's 32
//     rows fill 4 n8 tiles and nothing idles. A thread's A rows are 4 adjacent
//     columns, so one 32-bit shared load gives 4 columns of a packed row, 8
//     weights, and its accumulators are 4 adjacent outputs of an x row.
//   - A ring of STAGES stages in shared memory, fed by one producer warp and
//     released by 4 consumer warps through two mbarriers a stage. A stage is
//     64 packed rows of nibbles (128 columns), the two 64-wide K slices of x
//     they meet (all 32 rows of the block) and, for the scaled instances, the
//     group scale rows they touch: 20 KB in bf16 (62,464 bytes for the ring of 3
//     with its alignment slack; 90,112 in f32). At a group of 8 the two 8-row
//     halves of a k-step read a scale row each (rows 2t, 2t + 1 of a thread's A
//     fragment belong to one group, rows 2t + 8, 2t + 9 to the next), so a stage
//     carries BP / 8 = 8 scale rows a half instead of BP / 16: 24 KB, a ring of
//     74,752 bytes in bf16 (three blocks an SM still fit) and 102,400 in f32. The
//     weight is still bf16(f32(decode(nib)) * scale[g]), each with its own row's
//     scale. The producer fills it with
//     five 2-D TMA boxes (128-byte swizzle for the nibbles and bf16 x, 64-byte
//     for int8 x; the tensor maps are encoded by the host per call), and falls
//     back to cp.async into the same layout where a q4 row is not 16-byte
//     aligned (N % 16 != 0) or x is f32. (cp.async throughout, or one bulk copy
//     a row, moved the bytes 1.5-3x slower on an H100.)
//   - The decode within the instruction budget: a prmt picks one column's two packed
//     rows, one lop3 makes bf16 128 + nib of both, one bf16x2 subtraction gives
//     nib - 8 exactly (groupmm's operand); base multiplies each by its f32
//     scale and packs to bf16 (about 4 instructions a weight); nf4 reads the
//     codebook from a 16-entry shared table (conflict-free). The int8
//     instances transpose 4 x 4 bytes with prmt and map a nibble to the int8
//     nib - 8 with an add and an xor on 4 bytes at once. A stage's k-steps run
//     as straight-line code when the stage and the n8 tiles are full.
//   - Split-K in one launch: the wrapper splits K/2 into 1-8 slices of whole
//     k-steps (of whole groups for groupmm / i8mxu) when the N/128 x M/32 tiles
//     alone leave SMs idle. The slices of one output tile form a thread-block
//     cluster along z; after a cluster barrier each block stores its partial
//     of every output into the shared memory of the block that owns it (each
//     owns 1/slices of the tile), and after a second one each owner sums its
//     share over the slices in slice order, applies the epilogue and writes
//     out. No scratch, no atomics, no second pass: the same bits every run.
//     With one slice the outputs leave straight from the registers.
//
// How it differs from the TPU kernels. Those carry an f32 accumulator in VMEM
// across a sequential grid dimension over K and dequantise a (block_k, 512)
// tile at a time. Here the K loop runs inside each block over its slice, and
// the slices of a tile meet in a cluster.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"
#include "int4_decode.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int TN = 128;       // output columns per block: 4 consumer warps x 32
constexpr int TM = 32;        // x rows per block: 4 n8 tiles of the swapped product
constexpr int KS = 16;        // packed rows per k-step: one 16-deep product of each half
constexpr int BP = 64;        // packed rows per ring stage (4 k-steps)
constexpr int STAGES = 3;
constexpr int CONSUMERS = 4;  // consumer warps; warp 4 is the producer
constexpr int THREADS = 32 * (CONSUMERS + 1);
constexpr int MAX_SPLITS = 8; // the portable cluster size

enum Mode { BASE = 0, GROUPMM = 1, NF4 = 2, I8MXU = 3, PCOL = 4 };

// G8: the base / nf4 instances for a group that is a multiple of 8 but not of 16 (Gemma3-1B's K 1,152 packs at 8):
// the two 8-row halves of a k-step may take different scale rows, so a stage carries BP / 8 of them a half.
template <int MODE, typename T, bool G8 = false>
struct Cfg {
    static_assert(!G8 || MODE == BASE || MODE == NF4, "only the instances that scale each weight take groups of 8");
    static constexpr bool I8 = MODE == I8MXU || MODE == PCOL;
    static constexpr bool FOLD = MODE == GROUPMM || MODE == I8MXU;
    static constexpr bool SCALES = MODE != PCOL;  // group scale rows ride in the ring
    static constexpr bool F32X = !I8 && sizeof(T) == 4;  // f32 x: copied as it is, rounded to bf16 when read
    using In = typename std::conditional<I8, int8_t, T>::type;
    using Acc = typename std::conditional<I8, int, float>::type;
    static constexpr int XE = (int)sizeof(In);
    // A stage: the nibble tile (64 packed rows of 128 bytes, the TMA's 128-byte swizzle), x (bf16 / int8: one
    // tile of TM rows x 64 values for each half, 128- / 64-byte swizzle; f32: TM padded rows of both halves) and
    // the scale rows (SG rows of each half: a stage of whole k-steps touches at most BP / 16 groups of 16 or more,
    // BP / 8 groups of 8). Every part 1024-byte aligned.
    static constexpr int SG = G8 ? BP / 8 : BP / KS;
    static constexpr int NIB = BP * TN;
    static constexpr int XH = F32X ? 0 : TM * BP * XE;
    static constexpr int XLD = 2 * BP * 4 + 16;
    static constexpr int XB = F32X ? (TM * XLD + 1023) / 1024 * 1024 : 2 * XH;
    static constexpr int SB = SCALES ? 2 * SG * TN * 4 : 0;
    static constexpr int STAGE = NIB + XB + SB;
    static constexpr int SMEM = STAGES * STAGE + 1024;  // + slack to align the ring to 1024 bytes
    static_assert(TM * TN * 4 + MAX_SPLITS * 16 <= STAGES * STAGE, "the slices' partial tiles must fit in the ring");
};

// Byte offsets in the swizzled tiles: the nibble tile's and bf16 x's rows of 128 bytes (16-byte chunk c of row r
// at chunk c ^ (r % 8)), int8 x's rows of 64 bytes (chunk c ^ (r / 2 % 4)).
__device__ __forceinline__ int swz128(int r, int byte) { return r * 128 + ((((byte >> 4) ^ (r & 7))) << 4) + (byte & 15); }
__device__ __forceinline__ int swz64(int r, int byte) { return r * 64 + ((((byte >> 4) ^ ((r >> 1) & 3))) << 4) + (byte & 15); }

struct Args {
    CUtensorMap tq, tx, ts; // q4, x and scale4 as TMA sees them (tma only)
    const void* a;         // x (M, K) of T, or K2's xq (M, K) int8
    const float* xs;       // K2's row scales (M), int8 instances
    const uint8_t* q4;     // (K/2, N)
    const float* scale4;   // (K/group, N), (1, N) for pcol
    void* out;             // (M, N) of T
    int M, K, N, group, rows_per_split, tma;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_u32(dst)), "l"(src) : "memory");
}

// The barrier's phase counts this arrival once every cp.async the thread started before it has landed.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    asm(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[2], uint32_t b0) {
    asm(
        "mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(b0));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem_ptr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(smem_ptr))
                 : "memory");
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

// bf16x2 (128 + u) -> u - 8, exact.
__device__ __forceinline__ uint32_t minus136(uint32_t v) {
    const uint32_t k = 0x43084308u;  // bf16x2 (136, 136)
    __nv_bfloat162 r = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&v), *reinterpret_cast<const __nv_bfloat162*>(&k));
    return *reinterpret_cast<uint32_t*>(&r);
}

// bf16(f32(v) * s) of both halves of a bf16x2 v, the f32 product rounded once to bf16.
__device__ __forceinline__ uint32_t scale2(uint32_t v, float s) {
    return pack2(__fmul_rn(__uint_as_float(v << 16), s), __fmul_rn(__uint_as_float(v & 0xFFFF0000u), s));
}

// int8 nib - 8 of the four low nibbles of v (bytes u: (u + 0x78) ^ 0x80 = u - 8, no carry between bytes).
__device__ __forceinline__ uint32_t signed_nibbles(uint32_t v) {
    return ((v & 0x0F0F0F0Fu) + 0x78787878u) ^ 0x80808080u;
}

// ---------------------------------------------------------------------------
// The producer warp: stage i holds packed rows [p, p + rows) of the block's
// slice, the x values they meet and their scale rows.
// ---------------------------------------------------------------------------
template <int MODE, typename T, bool G8>
__device__ void produce(const Args& g, char* ring, uint64_t* full, uint64_t* empty, int row0, int n0, int p_begin,
                        int nst, int lane) {
    using C = Cfg<MODE, T, G8>;
    constexpr int XC = BP * C::XE / 16;                 // 16-byte chunks of x per row and half in a full stage
    const int half = g.K / 2;
    const int ncols = min(TN, g.N - n0);                // the tile's columns (a multiple of 8)
    const int xrows = min(TM, g.M - row0);              // the block's x rows
    const int hrow = C::SCALES ? half / g.group : 0;    // the high half's first scale row
    const char* xg = static_cast<const char*>(g.a) + (size_t)row0 * g.K * C::XE;
    const uint8_t* qg = g.q4 + (size_t)p_begin * g.N + n0;
    for (int i = 0; i < nst; ++i) {
        const int slot = i % STAGES;
        if (i >= STAGES) mbar_wait(&empty[slot], ((i / STAGES) - 1) & 1);
        char* st = ring + slot * C::STAGE;
        const int p = p_begin + i * BP;
        const int rows = min(BP, g.rows_per_split - i * BP);
        const int g0 = C::SCALES ? p / g.group : 0;
        if (g.tma) {  // five boxes (three for pcol); rows past the slice are loaded and not read
            if (lane == 0) {
                uint64_t* bar = &full[slot];
                mbar_expect_tx(bar, C::STAGE);
                tma_load_2d(st, &g.tq, bar, n0, p);
                tma_load_2d(st + C::NIB, &g.tx, bar, p, row0);
                tma_load_2d(st + C::NIB + C::XH, &g.tx, bar, half + p, row0);
                if constexpr (C::SCALES) {
                    tma_load_2d(st + C::NIB + C::XB, &g.ts, bar, n0, g0);
                    tma_load_2d(st + C::NIB + C::XB + C::SG * TN * 4, &g.ts, bar, n0, hrow + g0);
                }
            }
            continue;
        }
        // cp.async into the same layout: nibbles in 16-byte chunks (8 where rows are not 16-byte aligned)
        const uint8_t* qs = qg + (size_t)i * BP * g.N;
        if (g.N % 16 == 0) {
            for (int c = lane; c < rows * 8; c += 32) {
                const int r = c >> 3, b = (c & 7) << 4;
                if (b < ncols) cp_async16(st + swz128(r, b), qs + (size_t)r * g.N + b);
            }
        } else {
            for (int c = lane; c < rows * 16; c += 32) {
                const int r = c >> 4, b = (c & 15) << 3;
                if (b < ncols) cp_async8(st + swz128(r, b), qs + (size_t)r * g.N + b);
            }
        }
        // x: the block's rows, k in [p, p + rows) and [half + p, half + p + rows)
        const int xc = rows * C::XE / 16;
        for (int c = lane; c < xrows * 2 * XC; c += 32) {
            const int xr = c / (2 * XC), h = (c / XC) & 1, kc = c % XC;
            if (kc >= xc) continue;
            const char* src = xg + ((size_t)xr * g.K + h * half + p) * C::XE + kc * 16;
            if constexpr (C::F32X) cp_async16(st + C::NIB + xr * C::XLD + h * BP * 4 + kc * 16, src);
            else if constexpr (C::I8) cp_async16(st + C::NIB + h * C::XH + swz64(xr, kc * 16), src);
            else cp_async16(st + C::NIB + h * C::XH + swz128(xr, kc * 16), src);
        }
        // the scale rows of the groups the stage touches, both halves: 32 chunks of 4 columns a row
        if constexpr (C::SCALES) {
            const int ng = (p + rows - 1) / g.group - g0 + 1;
            for (int c = lane; c < ng * 64; c += 32) {
                const int j = c >> 6, h = (c >> 5) & 1, cc = (c & 31) << 2;
                if (cc < ncols)
                    cp_async16(st + C::NIB + C::XB + ((h * C::SG + j) * TN + cc) * 4,
                               g.scale4 + (size_t)(h * hrow + g0 + j) * g.N + n0 + cc);
            }
        }
        cp_async_arrive(&full[slot]);
    }
}

// ---------------------------------------------------------------------------
// One k-step of a consumer warp: the 32 columns [32 warp, +32) of the tile,
// packed rows [kr, kr + 16) of the stage, both halves, n8 tiles [0, nact).
// A thread (g = lane / 4, t = lane % 4) owns columns 4g .. 4g + 3 of the warp's
// 32: A tile 0 rows g, g + 8 are columns 4g, 4g + 1, A tile 1 rows g, g + 8 are
// columns 4g + 2, 4g + 3.
// ---------------------------------------------------------------------------
template <int MODE, typename T>
struct Step {
    using C = Cfg<MODE, T>;

    // B fragments of both halves: x rows 8 nt .. 8 nt + 7, k [kr, kr + 16) of the low and the high slice.
    __device__ static void load_b(uint32_t (&b)[2][4][2], const char* xa, int kr, int nact, int lane) {
        const int g = lane >> 2, t = lane & 3, mi = lane >> 3;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            if constexpr (C::I8) {
                const int row = 8 * mi + (lane & 7);
                uint32_t r[4];
                ldmatrix_x4(r, xa + h * C::XH + swz64(row, kr));
#pragma unroll
                for (int nt = 0; nt < 4; ++nt) b[h][nt][0] = r[nt];
            } else if constexpr (!C::F32X) {
#pragma unroll
                for (int np = 0; np < 4; np += 2) {
                    if (np >= nact) continue;
                    const int row = 8 * (np + (mi >> 1)) + (lane & 7);
                    uint32_t r[4];
                    ldmatrix_x4(r, xa + h * C::XH + swz128(row, 2 * kr + 16 * (mi & 1)));
                    b[h][np][0] = r[0];
                    b[h][np][1] = r[1];
                    b[h][np + 1][0] = r[2];
                    b[h][np + 1][1] = r[3];
                }
            } else {  // f32 x, rounded to bf16 here
#pragma unroll
                for (int nt = 0; nt < 4; ++nt) {
                    if (nt >= nact) continue;
                    const float* row = reinterpret_cast<const float*>(xa + (8 * nt + g) * C::XLD) + h * BP + kr + 2 * t;
                    const float2 v0 = *reinterpret_cast<const float2*>(row);
                    const float2 v1 = *reinterpret_cast<const float2*>(row + 8);
                    b[h][nt][0] = pack2(v0.x, v0.y);
                    b[h][nt][1] = pack2(v1.x, v1.y);
                }
            }
        }
    }

    // The thread's nibble words: 4 columns at each of its 4 packed rows.
    __device__ static void load_w(uint32_t (&w)[4], const char* nib, int kr, int warp, int lane) {
        const int g = lane >> 2, t = lane & 3;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int r = kr + (C::I8 ? 4 * t + q : 2 * t + (q & 1) + 8 * (q >> 1));
            w[q] = *reinterpret_cast<const uint32_t*>(nib + swz128(r, 32 * warp + 4 * g));
        }
    }

    // bf16 A fragments of both halves from the words (rows 2t, 2t + 1, 2t + 8, 2t + 9): rows 2t, 2t + 1 scale by
    // slo[0] / shi[0], rows 2t + 8, 2t + 9 by slo[1] / shi[1] (one group's row twice, but at a group of 8).
    __device__ static void make_a(uint32_t (&alo)[2][4], uint32_t (&ahi)[2][4], const uint32_t (&w)[4],
                                  const float4 (&slo)[2], const float4 (&shi)[2], const float* cb) {
        const float sl[2][4] = {{slo[0].x, slo[0].y, slo[0].z, slo[0].w}, {slo[1].x, slo[1].y, slo[1].z, slo[1].w}};
        const float sh[2][4] = {{shi[0].x, shi[0].y, shi[0].z, shi[0].w}, {shi[1].x, shi[1].y, shi[1].z, shi[1].w}};
#pragma unroll
        for (int tile = 0; tile < 2; ++tile)
#pragma unroll
            for (int rr = 0; rr < 2; ++rr)
#pragma unroll
                for (int kp = 0; kp < 2; ++kp) {
                    const int c = 2 * tile + rr, idx = rr + 2 * kp;
                    const uint32_t w0 = w[2 * kp], w1 = w[2 * kp + 1];
                    if constexpr (MODE == NF4) {
                        const int s0 = 8 * c;
                        alo[tile][idx] = pack2(__fmul_rn(cb[(w0 >> s0) & 15], sl[kp][c]),
                                               __fmul_rn(cb[(w1 >> s0) & 15], sl[kp][c]));
                        ahi[tile][idx] = pack2(__fmul_rn(cb[(w0 >> (s0 + 4)) & 15], sh[kp][c]),
                                               __fmul_rn(cb[(w1 >> (s0 + 4)) & 15], sh[kp][c]));
                    } else {
                        // [w0.byte c, -, w1.byte c, -]: the column's two packed rows in the two bf16 halves
                        const uint32_t x = __byte_perm(w0, w1, c | (c << 4) | ((c + 4) << 8) | ((c + 4) << 12));
                        const uint32_t lo = minus136((x & 0x000F000Fu) | 0x43004300u);
                        const uint32_t hi = minus136(((x >> 4) & 0x000F000Fu) | 0x43004300u);
                        if constexpr (MODE == BASE) {
                            alo[tile][idx] = scale2(lo, sl[kp][c]);
                            ahi[tile][idx] = scale2(hi, sh[kp][c]);
                        } else {
                            alo[tile][idx] = lo;
                            ahi[tile][idx] = hi;
                        }
                    }
                }
    }

    // int8 A fragments of both halves from the words (rows 4t .. 4t + 3): a 4 x 4 byte transpose gives each
    // column's 4 packed rows in one register.
    __device__ static void make_a8(uint32_t (&alo)[2][2], uint32_t (&ahi)[2][2], const uint32_t (&w)[4]) {
        const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140), t1 = __byte_perm(w[2], w[3], 0x5140);
        const uint32_t t2 = __byte_perm(w[0], w[1], 0x7362), t3 = __byte_perm(w[2], w[3], 0x7362);
        const uint32_t col[4] = {__byte_perm(t0, t1, 0x5410), __byte_perm(t0, t1, 0x7632), __byte_perm(t2, t3, 0x5410),
                                 __byte_perm(t2, t3, 0x7632)};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            alo[c >> 1][c & 1] = signed_nibbles(col[c]);
            ahi[c >> 1][c & 1] = signed_nibbles(col[c] >> 4);
        }
    }
};

// The value that leaves the kernel for one output (the slices' sum): the group folds are done; the int8
// instances multiply in their activation (and, for pcol, column) scales.
template <int MODE>
__device__ __forceinline__ float finish(float f, int i, const float* __restrict__ xs, const float* __restrict__ scale4,
                                        int row, int col) {
    if (MODE == PCOL) return __fmul_rn(__fmul_rn((float)i, __ldg(xs + row)), __ldg(scale4 + col));
    if (MODE == I8MXU) return __fmul_rn(f, __ldg(xs + row));
    return f;
}

__device__ __forceinline__ void store4(float* o, const float (&v)[4]) {
    *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* o, const float (&v)[4]) {
    *reinterpret_cast<uint2*>(o) = make_uint2(pack2(v[0], v[1]), pack2(v[2], v[3]));
}

// Block (bx, by, bz) owns output columns [128 bx, +128), x rows [32 by, +32) and packed rows
// [rows_per_split bz, +rows_per_split); the gridDim.z blocks of a tile form one cluster.
template <int MODE, typename T, bool G8>
__global__ void __launch_bounds__(THREADS, 3) i4_kernel(const __grid_constant__ Args g) {
    using C = Cfg<MODE, T, G8>;
    using Acc = typename C::Acc;
    using S = Step<MODE, T>;
    extern __shared__ char smem_raw[];
    __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
    __shared__ float cb[16];

    char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    cg::cluster_group cluster = cg::this_cluster();
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int n0 = blockIdx.x * TN, row0 = blockIdx.y * TM;
    const int p_begin = blockIdx.z * g.rows_per_split;
    const int nst = (g.rows_per_split + BP - 1) / BP;
    if (tid < 16) cb[tid] = kNF4[tid];
    if (tid == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(&full[s], g.tma ? 1 : 32);  // the TMA's one arrival, or every producer lane's cp.async
            mbar_init(&empty[s], CONSUMERS);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    Acc c[2][4][4] = {};   // the products: the sum itself, or one group's low-half part
    Acc ch[2][4][4] = {};  // one group's high-half part (FOLD)
    float acc[2][4][4] = {};
    const int nact = min(4, (g.M - row0 + 7) / 8);  // n8 tiles that hold rows below M

    if (warp == CONSUMERS) {
        if (g.tma && lane == 0) {
            tma_prefetch_map(&g.tq);
            tma_prefetch_map(&g.tx);
            if (C::SCALES) tma_prefetch_map(&g.ts);
        }
        produce<MODE, T, G8>(g, ring, full, empty, row0, n0, p_begin, nst, lane);
    } else {
        const int gq = lane >> 2;
        int gpos = C::SCALES ? p_begin % g.group : 0;  // packed rows into the current group
        // One stage: its k-steps [0, nks) over the n8 tiles [0, nact); FULL (every k-step, every n8 tile, as at
        // decode's 32 rows) is straight-line code the compiler can schedule across k-steps.
        auto run_stage = [&](auto full_tag, const char* st, int nks) {
            constexpr bool FULL = decltype(full_tag)::value;
            const char* xa = st + C::NIB;
            const float* sa = reinterpret_cast<const float*>(st + C::NIB + C::XB) + 32 * warp + 4 * gq;
            const int na = FULL ? 4 : nact;
            int gl = 0;  // the stage's scale row of the current group
#pragma unroll
            for (int j = 0; j < BP / KS; ++j) {
                if (!FULL && j >= nks) break;
                uint32_t w[4], b[2][4][2];
                S::load_w(w, st, j * KS, warp, lane);
                S::load_b(b, xa, j * KS, na, lane);
                float4 slo = make_float4(0.f, 0.f, 0.f, 0.f), shi = slo;
                if constexpr (C::SCALES) {
                    slo = *reinterpret_cast<const float4*>(sa + gl * TN);
                    shi = *reinterpret_cast<const float4*>(sa + (C::SG + gl) * TN);
                }
                float4 slo2[2] = {slo, slo}, shi2[2] = {shi, shi};  // the scales of rows 0-7 and 8-15 of the k-step
                if constexpr (G8) {  // the group may end after the k-step's first 8 rows: move on to the next row
                    gpos += KS / 2;
                    if (gpos == g.group) {
                        ++gl;
                        gpos = 0;
                    }
                    slo2[1] = *reinterpret_cast<const float4*>(sa + gl * TN);
                    shi2[1] = *reinterpret_cast<const float4*>(sa + (C::SG + gl) * TN);
                }
                if constexpr (C::I8) {
                    uint32_t alo[2][2], ahi[2][2];
                    S::make_a8(alo, ahi, w);
#pragma unroll
                    for (int tile = 0; tile < 2; ++tile)
#pragma unroll
                        for (int nt = 0; nt < 4; ++nt) {
                            if (nt >= na) continue;
                            mma_s8(c[tile][nt], alo[tile], b[0][nt][0]);
                            if constexpr (C::FOLD) mma_s8(ch[tile][nt], ahi[tile], b[1][nt][0]);
                            else mma_s8(c[tile][nt], ahi[tile], b[1][nt][0]);
                        }
                } else {
                    uint32_t alo[2][4], ahi[2][4];
                    S::make_a(alo, ahi, w, slo2, shi2, cb);
#pragma unroll
                    for (int tile = 0; tile < 2; ++tile)
#pragma unroll
                        for (int nt = 0; nt < 4; ++nt) {
                            if (nt >= na) continue;
                            mma_bf16(c[tile][nt], alo[tile], b[0][nt][0], b[0][nt][1]);
                            if constexpr (C::FOLD) mma_bf16(ch[tile][nt], ahi[tile], b[1][nt][0], b[1][nt][1]);
                            else mma_bf16(c[tile][nt], ahi[tile], b[1][nt][0], b[1][nt][1]);
                        }
                }
                if constexpr (C::SCALES) {
                    gpos += G8 ? KS / 2 : KS;
                    const bool end = gpos == g.group;
                    if constexpr (C::FOLD) {
                        if (end) {  // end of a group: acc += p_lo * s_lo + p_hi * s_hi, as the plain version
                            const float sl[4] = {slo.x, slo.y, slo.z, slo.w}, sh[4] = {shi.x, shi.y, shi.z, shi.w};
#pragma unroll
                            for (int tile = 0; tile < 2; ++tile)
#pragma unroll
                                for (int nt = 0; nt < 4; ++nt)
#pragma unroll
                                    for (int e = 0; e < 4; ++e) {
                                        const int col = 2 * tile + (e >> 1);
                                        const float u = __fadd_rn(__fmul_rn((float)c[tile][nt][e], sl[col]),
                                                                  __fmul_rn((float)ch[tile][nt][e], sh[col]));
                                        acc[tile][nt][e] = __fadd_rn(acc[tile][nt][e], u);
                                        c[tile][nt][e] = 0;
                                        ch[tile][nt][e] = 0;
                                    }
                        }
                    }
                    gl += end;
                    gpos = end ? 0 : gpos;
                }
            }
        };
        for (int i = 0; i < nst; ++i) {
            const int slot = i % STAGES;
            mbar_wait(&full[slot], (i / STAGES) & 1);
            const char* st = ring + slot * C::STAGE;
            const int nks = min(BP, g.rows_per_split - i * BP) / KS;
            if (nks == BP / KS && nact == 4) run_stage(std::true_type{}, st, nks);
            else run_stage(std::false_type{}, st, nks);
            __syncwarp();
            if (lane == 0) mbar_arrive(&empty[slot]);
        }
    }

    // The epilogue. The tile's 32 x 32 quads of 4 outputs (x row r, columns 4 c4 .. 4 c4 + 3): quad r * 32 + c4.
    // A thread holds the quads of x rows 8 nt + 2 t + h at c4 = 8 warp + gq.
    T* out = static_cast<T*>(g.out);
    const int splits = (int)cluster.num_blocks();
    auto quad = [&](int nt, int h, float (&v)[4]) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {  // column 4 gq + q: tile q / 2, accumulator entry h + 2 (q % 2)
            const int tile = q >> 1, e = h + 2 * (q & 1);
            if constexpr (C::FOLD) v[q] = acc[tile][nt][e];
            else if constexpr (C::I8) v[q] = __int_as_float(c[tile][nt][e]);
            else v[q] = c[tile][nt][e];
        }
    };
    auto finish4 = [&](const float (&f)[4], const int (&iv)[4], int grow, int gcol) {
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = finish<MODE>(f[e], iv[e], g.xs, g.scale4, grow, gcol + e);
        store4(out + (size_t)grow * g.N + gcol, v);
    };
    if (splits == 1) {  // one slice: straight from the registers
        if (warp < CONSUMERS) {
            const int gq = lane >> 2, t = lane & 3, gcol = n0 + 32 * warp + 4 * gq;
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int grow = row0 + 8 * nt + 2 * t + h;
                    if (nt >= nact || grow >= g.M || gcol >= g.N) continue;
                    float f[4];
                    quad(nt, h, f);
                    const int iv[4] = {__float_as_int(f[0]), __float_as_int(f[1]), __float_as_int(f[2]),
                                       __float_as_int(f[3])};
                    finish4(f, iv, grow, gcol);
                }
        }
        return;
    }
    // Split K: block `rank` owns quads [rank * per, +per). Once every block of the cluster is done with its ring,
    // each stores its partial of every quad into the owner's ring ([slice][quad of the share]); after a second
    // cluster barrier no block touches another's memory, and each owner sums its share over the slices in slice
    // order.
    const int rank = (int)cluster.block_rank();
    const int per = (TM * TN / 4 + splits - 1) / splits;
    float4* share = reinterpret_cast<float4*>(ring);
    cluster.sync();
    if (warp < CONSUMERS) {
        const int gq = lane >> 2, t = lane & 3;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
            if (nt >= nact) continue;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int qd = (8 * nt + 2 * t + h) * (TN / 4) + 8 * warp + gq, owner = qd / per;
                float v[4];
                quad(nt, h, v);
                *cluster.map_shared_rank(share + rank * per + (qd - owner * per), owner) =
                    make_float4(v[0], v[1], v[2], v[3]);
            }
        }
    }
    cluster.sync();
    for (int j = tid; j < per; j += THREADS) {
        const int qd = rank * per + j, r = qd / (TN / 4), col = 4 * (qd % (TN / 4));
        const int grow = row0 + r, gcol = n0 + col;
        if (qd >= TM * TN / 4 || grow >= g.M || gcol >= g.N) continue;
        const float4 p0 = share[j];
        float f[4] = {p0.x, p0.y, p0.z, p0.w};
        int iv[4] = {__float_as_int(f[0]), __float_as_int(f[1]), __float_as_int(f[2]), __float_as_int(f[3])};
        for (int sl = 1; sl < splits; ++sl) {
            const float4 p = share[sl * per + j];
            const float q[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                f[e] = __fadd_rn(f[e], q[e]);
                iv[e] += __float_as_int(q[e]);
            }
        }
        finish4(f, iv, grow, gcol);
    }
}

template <int MODE, typename T, bool G8 = false>
int launch(const Args& args, int splits, cudaStream_t stream) {
    using C = Cfg<MODE, T, G8>;
    static bool configured = false;
    if (!configured) {
        const cudaError_t e =
            cudaFuncSetAttribute(i4_kernel<MODE, T, G8>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
        if (e != cudaSuccess) return (int)e;
        configured = true;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((args.N + TN - 1) / TN, (args.M + TM - 1) / TM, splits);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = C::SMEM;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = splits;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(&cfg, i4_kernel<MODE, T, G8>, args);
    return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// K2's xq (M, K) int8 as boxes of 64 values x TM rows with the 64-byte swizzle.
int make_map_x8(CUtensorMap* map, const void* base, int rows, int cols) {
    const EncodeTiled fn = encode_tiled();
    if (!fn) return ERR_NO_ENCODER;
    const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows}, strides[1] = {(cuuint64_t)cols};
    const cuuint32_t box[2] = {BP, TM}, step[2] = {1, 1};
    const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides, box, step,
                          CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : ERR_ENCODE + (int)r;
}

template <typename T>
int dispatch(int mode, bool g8, const Args& args, int splits, cudaStream_t stream) {
    switch (mode) {
        case BASE: return g8 ? launch<BASE, T, true>(args, splits, stream) : launch<BASE, T>(args, splits, stream);
        case GROUPMM: return launch<GROUPMM, T>(args, splits, stream);
        case NF4: return g8 ? launch<NF4, T, true>(args, splits, stream) : launch<NF4, T>(args, splits, stream);
        case I8MXU: return launch<I8MXU, T>(args, splits, stream);
        case PCOL: return launch<PCOL, T>(args, splits, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

// mode: 0 base, 1 groupmm, 2 nf4, 3 i8mxu, 4 pcol. is_bf16: the output type (and, for modes 0-2, the type of
// x). a: x (M, K), or xq (M, K) int8 for modes 3-4 with xs (M) f32. q4 (K/2, N) uint8, scale4 (K/group, N) f32
// ((1, N) for mode 4). K/2 % 16 == 0, a group dividing K/2 (modes 0-3) that is a multiple of 16 (of 8 for modes 0
// and 2, whose instances for groups of 8 scale each 8-row half of a k-step on its own), N % 8 == 0; splits (1-8)
// slices of K/2 run as one cluster, each (K/2) / splits packed rows, a multiple of 16 (and of group for modes 1, 3).
// Every pointer 16-byte aligned. One launch; returns its CUDA error.
int dalm_i4_matmul(int mode, int is_bf16, const void* a, const float* xs, const void* q4, const float* scale4, int M,
                   int K, int N, int group, int splits, void* out, cudaStream_t stream) {
    const int half = K / 2;
    if (M < 1 || N < 8 || N % 8 || half < KS || half % KS || splits < 1 || splits > MAX_SPLITS || half % splits)
        return (int)cudaErrorInvalidValue;
    const int rows = half / splits;
    const bool fold = mode == GROUPMM || mode == I8MXU;
    const bool g8 = (mode == BASE || mode == NF4) && group % KS != 0;  // the instances for groups of 8
    const int unit = g8 ? KS / 2 : KS;
    if (rows % KS || (mode != PCOL && (group < unit || group % unit || half % group)) || (fold && rows % group))
        return (int)cudaErrorInvalidValue;
    Args args{};
    args.a = a;
    args.xs = xs;
    args.q4 = static_cast<const uint8_t*>(q4);
    args.scale4 = scale4;
    args.out = out;
    args.M = M;
    args.K = K;
    args.N = N;
    args.group = mode == PCOL ? K : group;
    args.rows_per_split = rows;
    // TMA where every row is 16-byte aligned and x needs no rounding on the way; cp.async otherwise
    args.tma = N % 16 == 0 && (is_bf16 || mode == I8MXU || mode == PCOL);
    if (args.tma) {
        int err = make_map(&args.tq, q4, 1, half, N, BP);
        if (!err) err = mode >= I8MXU ? make_map_x8(&args.tx, a, M, K) : make_map(&args.tx, a, 2, M, K, TM);
        if (!err && mode != PCOL) {
            const long long dims[2] = {N, K / group}, strides[1] = {(long long)N * 4};
            const int box[2] = {TN, g8 ? Cfg<BASE, float, true>::SG : Cfg<BASE, float>::SG};
            err = make_map_nd(&args.ts, scale4, 4, 2, dims, strides, box);
        }
        if (err) return err;
    }
    if (is_bf16) return dispatch<__nv_bfloat16>(mode, g8, args, splits, stream);
    return dispatch<float>(mode, g8, args, splits, stream);
}

}  // extern "C"
