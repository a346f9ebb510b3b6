// K5: int4 weight-dequant matmul of the 4-bit serving tiers, hand-written for
// Hopper (sm_90a). One template, five instances.
//
// Replaces dalm_tpu/kernels/int4_matmul.py:
//   _int4_matmul_fwd_pallas, variants base / floorsplit   -> i4_kernel<LINEAR, BEFORE, false>   (mode 0)
//   _int4_matmul_fwd_pallas, variants groupmm / decomp    -> i4_kernel<LINEAR, AFTER_GROUP, false> (mode 1)
//   _int4_matmul_fwd_pallas, variant nf4                  -> i4_kernel<NF4, BEFORE, false>      (mode 2)
//   _int4_matmul_fwd_pallas, variant i8mxu                -> i4_kernel<LINEAR, AFTER_GROUP, true> (mode 3)
//   _int4pc_matmul_fwd_pallas (_int4_kernel_pcol)         -> i4_kernel<LINEAR, AT_WRITE, true>  (mode 4)
// each for float32 and bfloat16 activations / outputs.
//
// What they compute. y (M, N) = x (M, K) . W with W held as q4 (K/2, N) uint8
// in the half-split layout (packed row r: K-row r in the low nibble, K-row
// K/2 + r in the high one) and f32 scales scale4 (K/group, N), or (1, N) per
// column. The template's three parameters:
//   Decode   LINEAR: nib - 8;  NF4: the NormalFloat4 codebook, a 16-entry table
//            copied into shared memory (divergent reads from __constant__ would
//            serialise);
//   ScaleAt  BEFORE: w = bf16(f32(decode(nib)) * scale[g]) is formed before the
//            product (base, nf4); AFTER_GROUP: each group's product
//            p = x . decode(nib) is folded in as acc += p_lo * s_lo[g] + p_hi *
//            s_hi[g] after the product (groupmm, i8mxu); AT_WRITE: one int32
//            sum over all of K, (f32(acc) * xs[row]) * s[col] at the write (pcol);
//   operand  bf16 x bf16 -> f32 on mma.sync m16n8k16 (x is rounded to bf16 on
//            its way into shared memory), or int8 x int8 -> int32 on
//            mma.sync m16n8k16 (.s8): x arrives row-quantised by K2 (xq, xs), and
//            a 16-deep step never spans two scale groups, whose smallest size
//            on the Llama shapes is 16 (the down-projection, K/2 = 5504).
// The arithmetic follows the plain PyTorch versions in kernels/int4_matmul.py:
// the weight is rounded once, as there; the folds use __fmul_rn / __fadd_rn so
// that no fused multiply-add changes a rounding; the int8 products are exact.
//
// What bounds it on an H100. Decode (M = 32 rows) reads 0.5 byte a weight
// plus the scales and does 64 operations a weight pair: bound by bytes (9.4 MB
// = 0.0028 ms at 4096 x 4096). The output tiles alone (N / 128 of them) leave
// most of the 132 SMs idle there, so the wrapper splits K/2 into slices of
// whole groups run by separate blocks (gridDim.z), each writing an f32 (int32
// for pcol) partial that a second kernel sums in slice order: no atomics, the
// same result every run. Prefill (M = 8192) does 2 M K N operations on the
// same bytes: bound by operations (0.278 ms at 4096 x 4096 in bf16).
//
// How it differs from the TPU kernels. Those carry an f32 accumulator in VMEM
// across a sequential grid dimension over K and dequantise a (block_k, 512)
// tile at a time. Here one block owns a 64 x 128 output tile and loops over K/2
// (or its slice of it) in steps of 32 packed rows itself. A step stages the
// packed bytes, the 32 low- and 32 high-half columns of x and, for the float
// instances, the scales in registers one step ahead (the loads of step i + 1
// fly while step i runs on the tensor cores), then dequantises into shared
// memory: bf16 W as [k][n] rows read through ldmatrix.trans, int8 W as [n][k]
// (4 x 4 byte blocks transposed in registers with __byte_perm) read as
// 32-bit fragments. 8 warps, 2 along M x 4 along N, each 32 x 32; a warp whose
// rows all lie beyond M skips its products (decode has 32 rows). wgmma, TMA
// and a deeper pipeline are left for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "int4_decode.cuh"

namespace {

constexpr int BM = 64;           // output tile rows
constexpr int BN = 128;          // output tile columns
constexpr int BH = 32;           // packed rows per k-step: 32 low-half and 32 high-half K values
constexpr int THREADS = 256;     // 8 warps: 2 along M x 4 along N, each 32 x 32
constexpr int LDA = 2 * BH + 8;  // bf16 x tile row: 64 values + 8 pad (144 bytes: ldmatrix without conflicts)
constexpr int LDB = BN + 8;      // bf16 W tile row [k][n]: 128 + 8 (272 bytes)
constexpr int LD8 = 2 * BH + 16; // int8 tile rows, [m][k] and [n][k]: 64 bytes + 16 pad (80 bytes)

enum Decode { LINEAR = 0, NF4 = 1 };
enum ScaleAt { BEFORE = 0, AFTER_GROUP = 1, AT_WRITE = 2 };

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1, uint32_t b0) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a0), "r"(a1), "r"(b0));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem_ptr) {
    const uint32_t addr = (uint32_t)__cvta_generic_to_shared(smem_ptr);
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr)
                 : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem_ptr) {
    const uint32_t addr = (uint32_t)__cvta_generic_to_shared(smem_ptr);
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr)
                 : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
    __nv_bfloat162 v = __floats2bfloat162_rn(a, b);  // a in the low half
    return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void store2(float* o, float a, float b) { *reinterpret_cast<float2*>(o) = make_float2(a, b); }
__device__ __forceinline__ void store2(__nv_bfloat16* o, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(a, b);
}

// ---------------------------------------------------------------------------
// Registers that carry one k-step's inputs from global memory to the dequant.
// ---------------------------------------------------------------------------
template <bool I8, typename T>
struct Stage;

// Float instances: two 8-value chunks of x, two 8-column runs of packed bytes
// and, for ScaleAt BEFORE, their 8 low-half and 8 high-half scales.
template <typename T>
struct Stage<false, T> {
    uint4 x[2][2];      // [chunk][16-byte part]; a bf16 chunk uses part 0 only
    uint2 q[2];         // packed bytes of rows r and r + 16
    float4 s[2][2][2];  // [row][lo, hi][4 columns]
};

// int8 instances: 16 bytes of xq, a 4 x 4 block of packed bytes.
template <typename T>
struct Stage<true, T> {
    uint4 x;
    uint32_t q[4];
};

template <int DEC, int SC, bool I8, typename T>
struct Tile {
    // Where each thread's share of the step lies.
    __device__ static void load(Stage<false, T>& st, const T* __restrict__ x, const uint8_t* __restrict__ q4,
                                const float* __restrict__ scale4, int M, int K, int N, int group, int row0,
                                int n0, int p0, int tid) {
        const int half = K / 2;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int id = tid + i * THREADS;
            const int row = id >> 3, ch = id & 7;
            const int h = ch >> 2, c = (ch & 3) * 8;
            st.x[i][0] = st.x[i][1] = make_uint4(0, 0, 0, 0);
            if (row0 + row < M) {
                const T* p = x + (size_t)(row0 + row) * K + h * half + p0 + c;
                st.x[i][0] = __ldg(reinterpret_cast<const uint4*>(p));
                if (sizeof(T) == 4) st.x[i][1] = __ldg(reinterpret_cast<const uint4*>(p) + 1);
            }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int id = tid + i * THREADS;
            const int r = id >> 4, c = (id & 15) * 8;
            const int n = n0 + c;
            st.q[i] = make_uint2(0, 0);
            if (n < N) {
                const int p = p0 + r;
                st.q[i] = __ldg(reinterpret_cast<const uint2*>(q4 + (size_t)p * N + n));
                if (SC == BEFORE) {
                    const float* slo = scale4 + (size_t)(p / group) * N + n;
                    const float* shi = scale4 + (size_t)(half / group + p / group) * N + n;
                    st.s[i][0][0] = __ldg(reinterpret_cast<const float4*>(slo));
                    st.s[i][0][1] = __ldg(reinterpret_cast<const float4*>(slo) + 1);
                    st.s[i][1][0] = __ldg(reinterpret_cast<const float4*>(shi));
                    st.s[i][1][1] = __ldg(reinterpret_cast<const float4*>(shi) + 1);
                }
            }
        }
    }

    __device__ static void load(Stage<true, T>& st, const int8_t* __restrict__ xq, const uint8_t* __restrict__ q4,
                                const float* __restrict__, int M, int K, int N, int, int row0, int n0, int p0,
                                int tid) {
        const int half = K / 2;
        {
            const int row = tid >> 2, part = tid & 3;
            const int h = part >> 1, c = (part & 1) * 16;
            st.x = make_uint4(0, 0, 0, 0);
            if (row0 + row < M)
                st.x = __ldg(reinterpret_cast<const uint4*>(xq + (size_t)(row0 + row) * K + h * half + p0 + c));
        }
        int nq, kq;
        coords8(tid, nq, kq);
        const int n = n0 + nq * 4;
#pragma unroll
        for (int j = 0; j < 4; ++j)
            st.q[j] = n < N ? __ldg(reinterpret_cast<const uint32_t*>(q4 + (size_t)(p0 + kq * 4 + j) * N + n)) : 0u;
    }

    // The thread's 4 x 4 block of packed bytes in the int8 instances: the
    // column quad nq (of 32) and the row quad kq (of 8).
    __device__ static void coords8(int tid, int& nq, int& kq) {
        const int lane = tid & 31, warp = tid >> 5;
        nq = (warp & 3) * 8 + (lane & 7);
        kq = (warp >> 2) * 4 + (lane >> 3);
    }

    // Registers -> shared memory: x as bf16 [m][k]; W as bf16 [k][n].
    __device__ static void store(const Stage<false, T>& st, __nv_bfloat16* As, __nv_bfloat16* Bs, const float* cb,
                                 int tid) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int id = tid + i * THREADS;
            const int row = id >> 3, ch = id & 7;
            const int h = ch >> 2, c = (ch & 3) * 8;
            uint4 v;
            if (sizeof(T) == 2) {
                v = st.x[i][0];
            } else {
                const float* f0 = reinterpret_cast<const float*>(&st.x[i][0]);
                const float* f1 = reinterpret_cast<const float*>(&st.x[i][1]);
                v = make_uint4(pack_bf16(f0[0], f0[1]), pack_bf16(f0[2], f0[3]), pack_bf16(f1[0], f1[1]),
                               pack_bf16(f1[2], f1[3]));
            }
            *reinterpret_cast<uint4*>(As + row * LDA + h * BH + c) = v;
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int id = tid + i * THREADS;
            const int r = id >> 4, c = (id & 15) * 8;
            const uint8_t* b = reinterpret_cast<const uint8_t*>(&st.q[i]);
            float lo[8], hi[8];
#pragma unroll
            for (int j = 0; j < 8; ++j) decode_pair<DEC == NF4>(b[j], cb, lo[j], hi[j]);
            if (SC == BEFORE) {
                const float* sl = reinterpret_cast<const float*>(&st.s[i][0][0]);
                const float* sh = reinterpret_cast<const float*>(&st.s[i][1][0]);
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    lo[j] = __fmul_rn(lo[j], sl[j]);
                    hi[j] = __fmul_rn(hi[j], sh[j]);
                }
            }
            *reinterpret_cast<uint4*>(Bs + r * LDB + c) =
                make_uint4(pack_bf16(lo[0], lo[1]), pack_bf16(lo[2], lo[3]), pack_bf16(lo[4], lo[5]), pack_bf16(lo[6], lo[7]));
            *reinterpret_cast<uint4*>(Bs + (BH + r) * LDB + c) =
                make_uint4(pack_bf16(hi[0], hi[1]), pack_bf16(hi[2], hi[3]), pack_bf16(hi[4], hi[5]), pack_bf16(hi[6], hi[7]));
        }
    }

    // Registers -> shared memory: xq as int8 [m][k]; W = nib - 8 as int8 [n][k].
    __device__ static void store(const Stage<true, T>& st, int8_t* As, int8_t* Bs, const float*, int tid) {
        {
            const int row = tid >> 2, part = tid & 3;
            const int h = part >> 1, c = (part & 1) * 16;
            *reinterpret_cast<uint4*>(As + row * LD8 + h * BH + c) = st.x;
        }
        int nq, kq;
        coords8(tid, nq, kq);
        uint32_t lo[4], hi[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            lo[j] = st.q[j] & 0x0F0F0F0Fu;
            hi[j] = (st.q[j] >> 4) & 0x0F0F0F0Fu;
        }
#pragma unroll
        for (int part = 0; part < 2; ++part) {
            const uint32_t* v = part ? hi : lo;
            // rows j = 0..3 hold 4 columns each; transpose to 4 columns of 4 rows
            const uint32_t t0 = __byte_perm(v[0], v[1], 0x5140), t1 = __byte_perm(v[2], v[3], 0x5140);
            const uint32_t t2 = __byte_perm(v[0], v[1], 0x7362), t3 = __byte_perm(v[2], v[3], 0x7362);
            const uint32_t col[4] = {__byte_perm(t0, t1, 0x5410), __byte_perm(t0, t1, 0x7632),
                                     __byte_perm(t2, t3, 0x5410), __byte_perm(t2, t3, 0x7632)};
#pragma unroll
            for (int c = 0; c < 4; ++c)
                *reinterpret_cast<uint32_t*>(Bs + (nq * 4 + c) * LD8 + part * BH + kq * 4) = __vsub4(col[c], 0x08080808u);
        }
    }
};

// One 16-deep step of the warp's 32 x 32 tile at tile column koff.
__device__ __forceinline__ void warp_step(float (&c)[2][4][4], const __nv_bfloat16* As, const __nv_bfloat16* Bs,
                                          int koff, int wm, int wn, int lane) {
    const int r8 = lane & 7, hi8 = (lane >> 3) & 1, top = lane >> 4;
    uint32_t a[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) ldmatrix_x4(a[mt], As + (wm * 32 + mt * 16 + r8 + hi8 * 8) * LDA + koff + top * 8);
#pragma unroll
    for (int np = 0; np < 4; np += 2) {
        uint32_t b[4];  // b0, b1 of n-tile np, then of n-tile np + 1
        ldmatrix_x4_trans(b, Bs + (koff + r8 + hi8 * 8) * LDB + wn * 32 + (np + top) * 8);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
            mma_bf16(c[mt][np], a[mt], b[0], b[1]);
            mma_bf16(c[mt][np + 1], a[mt], b[2], b[3]);
        }
    }
}

__device__ __forceinline__ void warp_step(int (&c)[2][4][4], const int8_t* As, const int8_t* Bs, int koff, int wm,
                                          int wn, int lane) {
    const int g = lane >> 2, tig = lane & 3;
    uint32_t a0[2], a1[2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
        const int8_t* p = As + (wm * 32 + mt * 16 + g) * LD8 + koff + tig * 4;
        a0[mt] = *reinterpret_cast<const uint32_t*>(p);
        a1[mt] = *reinterpret_cast<const uint32_t*>(p + 8 * LD8);
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(Bs + (wn * 32 + nt * 8 + g) * LD8 + koff + tig * 4);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_s8(c[mt][nt], a0[mt], a1[mt], b0);
    }
}

template <typename A>
__device__ __forceinline__ void zero(A (&c)[2][4][4]) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) c[i][j][e] = 0;
}

template <bool I8> struct Smem;
template <> struct Smem<false> { __nv_bfloat16 a[BM * LDA]; __nv_bfloat16 b[2 * BH * LDB]; };
template <> struct Smem<true> { int8_t a[BM * LD8]; int8_t b[BN * LD8]; };

// The value that leaves the kernel for one accumulator entry (or for one
// slice-ordered sum of them): the group folds are done; the int8 instances
// multiply in their activation (and, for pcol, column) scales.
template <int SC, bool I8>
__device__ __forceinline__ float finish(float facc, int iacc, const float* __restrict__ xs,
                                        const float* __restrict__ scale4, int row, int col) {
    if (SC == AT_WRITE) return __fmul_rn(__fmul_rn((float)iacc, __ldg(xs + row)), __ldg(scale4 + col));
    if (I8) return __fmul_rn(facc, __ldg(xs + row));
    return facc;
}

// a: x (M, K) of type T (float instances) or xq (M, K) int8; xs (M) f32 row
// scales (int8 instances); block (bx, by, bz) owns output rows [64 bx, +64),
// columns [128 by, +128) and packed rows [rows_per_split bz, +rows_per_split).
// With ws == nullptr it writes out (M, N) in T, else its partial into
// ws[bz] (M, N): f32 accumulators, or the int32 sums' bits for AT_WRITE.
template <int DEC, int SC, bool I8, typename T>
__global__ void __launch_bounds__(THREADS)
i4_kernel(const void* __restrict__ a, const float* __restrict__ xs, const uint8_t* __restrict__ q4,
          const float* __restrict__ scale4, int M, int K, int N, int group, int rows_per_split,
          float* __restrict__ ws, T* __restrict__ out) {
    using Op = typename std::conditional<I8, int8_t, __nv_bfloat16>::type;
    using Acc = typename std::conditional<I8, int, float>::type;
    using TileT = Tile<DEC, SC, I8, T>;
    using In = typename std::conditional<I8, int8_t, T>::type;
    __shared__ __align__(16) Smem<I8> sm;
    __shared__ float cb[16];

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int wm = warp >> 2, wn = warp & 3, g = lane >> 2, tig = lane & 3;
    const int row0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
    const int p_begin = blockIdx.z * rows_per_split, p_end = p_begin + rows_per_split;
    const int half = K / 2;
    const bool active = row0 + wm * 32 < M;  // warp-uniform
    if (DEC == NF4 && tid < 16) cb[tid] = kNF4[tid];

    constexpr bool FOLD = SC == AFTER_GROUP;
    Acc c[2][4][4];   // the products: the accumulator itself, or one group's low-half part
    Acc ch[2][4][4];  // one group's high-half part (FOLD only)
    float acc[2][4][4];
    zero(c);
    zero(ch);
    zero(acc);

    const In* x = static_cast<const In*>(a);
    Stage<I8, T> st;
    TileT::load(st, x, q4, scale4, M, K, N, group, row0, n0, p_begin, tid);
    for (int p0 = p_begin; p0 < p_end; p0 += BH) {
        __syncthreads();
        TileT::store(st, reinterpret_cast<Op*>(sm.a), reinterpret_cast<Op*>(sm.b), cb, tid);
        __syncthreads();
        if (p0 + BH < p_end) TileT::load(st, x, q4, scale4, M, K, N, group, row0, n0, p0 + BH, tid);
        if (!active) continue;
#pragma unroll
        for (int kk = 0; kk < BH / 16; ++kk) {
            const Op* As = reinterpret_cast<const Op*>(sm.a);
            const Op* Bs = reinterpret_cast<const Op*>(sm.b);
            warp_step(c, As, Bs, kk * 16, wm, wn, lane);
            if (FOLD) warp_step(ch, As, Bs, BH + kk * 16, wm, wn, lane);
            else warp_step(c, As, Bs, BH + kk * 16, wm, wn, lane);
            if (FOLD && (p0 + (kk + 1) * 16) % group == 0) {
                // End of a group: acc += p_lo * s_lo + p_hi * s_hi, two products and
                // two sums rounded as the plain version rounds them.
                const int j = (p0 + kk * 16) / group;
#pragma unroll
                for (int nt = 0; nt < 4; ++nt) {
                    const int col = n0 + wn * 32 + nt * 8 + tig * 2;
                    float2 sl = make_float2(0.f, 0.f), sh = make_float2(0.f, 0.f);
                    if (col < N) {
                        sl = __ldg(reinterpret_cast<const float2*>(scale4 + (size_t)j * N + col));
                        sh = __ldg(reinterpret_cast<const float2*>(scale4 + (size_t)(half / group + j) * N + col));
                    }
#pragma unroll
                    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
                        for (int e = 0; e < 4; ++e) {
                            const float s_lo = (e & 1) ? sl.y : sl.x, s_hi = (e & 1) ? sh.y : sh.x;
                            const float t = __fadd_rn(__fmul_rn((float)c[mt][nt][e], s_lo),
                                                      __fmul_rn((float)ch[mt][nt][e], s_hi));
                            acc[mt][nt][e] = __fadd_rn(acc[mt][nt][e], t);
                            c[mt][nt][e] = 0;
                            ch[mt][nt][e] = 0;
                        }
                }
            }
        }
    }
    if (!active) return;

#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int row = row0 + wm * 32 + mt * 16 + g + h * 8;
                const int col = n0 + wn * 32 + nt * 8 + tig * 2;
                if (row >= M || col >= N) continue;  // N % 8 == 0 and col is even: col + 1 < N too
                float v[2];
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int i = h * 2 + e;
                    if (ws) {
                        v[e] = SC == AT_WRITE ? __int_as_float((int)c[mt][nt][i]) : (FOLD ? acc[mt][nt][i] : (float)c[mt][nt][i]);
                    } else {
                        const float f = FOLD ? acc[mt][nt][i] : (float)c[mt][nt][i];
                        v[e] = finish<SC, I8>(f, (int)c[mt][nt][i], xs, scale4, row, col + e);
                    }
                }
                if (ws) store2(ws + ((size_t)blockIdx.z * M + row) * N + col, v[0], v[1]);
                else store2(out + (size_t)row * N + col, v[0], v[1]);
            }
}

// out[m][n] = finish(sum over slices z = 0, 1, ... of ws[z][m][n]), in that order.
template <int SC, bool I8, typename T>
__global__ void __launch_bounds__(256)
i4_reduce_kernel(const float* __restrict__ ws, int splits, int M, int N, const float* __restrict__ xs,
                 const float* __restrict__ scale4, T* __restrict__ out) {
    const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    const size_t total = (size_t)M * N;
    if (idx >= total) return;
    float f = ws[idx];
    int i = __float_as_int(ws[idx]);
    for (int z = 1; z < splits; ++z) {
        const float w = ws[(size_t)z * total + idx];
        if (SC == AT_WRITE) i += __float_as_int(w);
        else f = __fadd_rn(f, w);
    }
    const int row = (int)(idx / N), col = (int)(idx % N);
    const float v = finish<SC, I8>(f, i, xs, scale4, row, col);
    if (sizeof(T) == 4) reinterpret_cast<float*>(out)[idx] = v;
    else reinterpret_cast<__nv_bfloat16*>(out)[idx] = __float2bfloat16_rn(v);
}

template <int DEC, int SC, bool I8, typename T>
int launch(const void* a, const float* xs, const void* q4, const float* scale4, int M, int K, int N, int group,
           int splits, float* ws, void* out, cudaStream_t stream) {
    const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, splits);
    i4_kernel<DEC, SC, I8, T><<<grid, THREADS, 0, stream>>>(
        a, xs, static_cast<const uint8_t*>(q4), scale4, M, K, N, group, (K / 2) / splits,
        splits > 1 ? ws : nullptr, static_cast<T*>(out));
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || splits == 1) return (int)err;
    const size_t total = (size_t)M * N;
    i4_reduce_kernel<SC, I8, T><<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
        ws, splits, M, N, xs, scale4, static_cast<T*>(out));
    return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int mode, const void* a, const float* xs, const void* q4, const float* scale4, int M, int K, int N,
             int group, int splits, float* ws, void* out, cudaStream_t stream) {
    switch (mode) {
        case 0: return launch<LINEAR, BEFORE, false, T>(a, xs, q4, scale4, M, K, N, group, splits, ws, out, stream);
        case 1: return launch<LINEAR, AFTER_GROUP, false, T>(a, xs, q4, scale4, M, K, N, group, splits, ws, out, stream);
        case 2: return launch<NF4, BEFORE, false, T>(a, xs, q4, scale4, M, K, N, group, splits, ws, out, stream);
        case 3: return launch<LINEAR, AFTER_GROUP, true, T>(a, xs, q4, scale4, M, K, N, group, splits, ws, out, stream);
        case 4: return launch<LINEAR, AT_WRITE, true, T>(a, xs, q4, scale4, M, K, N, group, splits, ws, out, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

// mode: 0 base, 1 groupmm, 2 nf4, 3 i8mxu, 4 pcol. is_bf16: the output type
// (and, for modes 0-2, the type of x). a: x (M, K), or xq (M, K) int8 for
// modes 3-4 with xs (M) f32. q4 (K/2, N) uint8, scale4 (K/group, N) f32
// ((1, N) for mode 4). K/2 % 32 == 0, group % 16 == 0 dividing K/2 (modes
// 0-3), N % 8 == 0, (K/2) / splits a multiple of 32 (and of group for modes
// 1, 3). ws: (splits, M, N) f32 scratch when splits > 1.
int dalm_i4_matmul(int mode, int is_bf16, const void* a, const float* xs, const void* q4, const float* scale4, int M,
                   int K, int N, int group, int splits, float* ws, void* out, cudaStream_t stream) {
    if (is_bf16) return dispatch<__nv_bfloat16>(mode, a, xs, q4, scale4, M, K, N, group, splits, ws, out, stream);
    return dispatch<float>(mode, a, xs, q4, scale4, M, K, N, group, splits, ws, out, stream);
}

}  // extern "C"
