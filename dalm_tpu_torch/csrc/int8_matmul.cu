// K1 + K2: W8A8 int8 matmul for the frozen QLoRA base, and the per-row int8
// quantiser, hand-written for Hopper (sm_90a).
//
// Replaces dalm_tpu/kernels/int8_matmul.py:
//   K2  _rowquant_pallas / _rowquant_kernel      -> dalm_i8_rowquant
//   K1  _w8a8_fused_pallas / _w8a8_fused_kernel  -> dalm_i8_w8a8_fused
// and carries the two int8 x int8 -> int32 products that the TPU version left
// to the compiler (_i8_dot_last): the unfused forward (dalm_i8_gemm_kn) and
// the dx product of the int8 backward (dalm_i8_gemm_nt).
//
// What bounds them on an H100. K2 moves R*K input bytes (2 or 4 each) and
// R*K output bytes and does a handful of operations per element: bytes. It is
// one block per row: an absmax pass, then a quantise pass that re-reads the
// row while it is still in L1/L2, so device memory sees each byte once.
// K1 and the GEMMs at the Llama shapes (M = 4608, K and N in the thousands) do
// thousands of int8 operations per byte: operations. They run on the tensor
// cores through mma.sync m16n8k32 (s8 x s8 -> s32), 128 x 128 output tiles,
// 64-deep k tiles staged through shared memory with the next tile prefetched
// into registers. wgmma and TMA are left for a later change.
//
// The TPU K1 quantises an M-stripe of x once and keeps it in VMEM across a
// sequential sweep over N. Blocks here run in no order, and quantising a
// stripe again in each of the N / 128 blocks that need it cost six times the
// product itself. So K1 is one cooperative launch in two phases around a
// grid barrier: a prologue in which all warps quantise x once, per
// (row, k-block): absmax, s = absmax / 127 (1 for a zero block),
// q = clip(rint(x / s)), into a scratch that stays in L2; then persistent
// blocks run each k-block on the tensor cores into an int32 accumulator and
// fold acc += float(p) * s in k-block order, times the weight scale at the end.
// Arithmetic is kept identical to the plain PyTorch version: true division,
// round-half-even, no fused multiply-add in the fold (__fmul_rn, __fadd_rn).
//
// Layouts: x (M, K) row-major; q (K, N) int8 row-major, one copy for both
// directions. The forward contracts K, the strided axis of q, so its tile is
// transposed through registers (__byte_perm) on the way into shared memory;
// dx contracts N, contiguous in both operands.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;       // output tile rows
constexpr int BN = 128;       // output tile columns
constexpr int BK = 64;        // contraction depth of one shared-memory tile
constexpr int LDS = 80;       // bytes per shared-memory tile row (64 + 16: conflict-free fragments)
constexpr int THREADS = 256;  // 8 warps: 2 along M x 4 along N, each 64 x 32
constexpr int RQ_THREADS = 256;

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ int quant1(float v, float s) {
    float r = rintf(__fdiv_rn(v, s));
    return (int)fminf(fmaxf(r, -127.f), 127.f);
}

// ---------------------------------------------------------------------------
// Tile loaders. Every loader zero-fills what lies outside the matrix.
// ---------------------------------------------------------------------------

// int8 rows with the contraction axis contiguous: rows [row0, row0 + 128) x
// bytes [k0, k0 + 64) of a (R, C) matrix, C % 16 == 0. Two 16-byte chunks a thread.
// NC = true reads through the read-only path; false (plain loads) is for data
// written earlier in the same kernel.
template <bool NC>
__device__ __forceinline__ void load_rows(const int8_t* g, int R, int C, int row0, int k0, int tid,
                                          uint4 (&v)[2]) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        int id = tid + i * THREADS;
        int row = row0 + (id >> 2);
        int k = k0 + (id & 3) * 16;
        const uint4* p = reinterpret_cast<const uint4*>(g + (size_t)row * C + k);
        v[i] = (row < R && k < C) ? (NC ? __ldg(p) : *p) : make_uint4(0, 0, 0, 0);
    }
}

__device__ __forceinline__ void store_rows(int8_t* s, int tid, const uint4 (&v)[2]) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        int id = tid + i * THREADS;
        *reinterpret_cast<uint4*>(s + (id >> 2) * LDS + (id & 3) * 16) = v[i];
    }
}

// int8 (K, N) row-major weights, N % 4 == 0: rows [k0, k0 + 64) x columns
// [n0, n0 + 128), transposed into [n][k] on the way. A thread takes two
// 4 (k) x 4 (n) byte blocks and transposes each in registers.
__device__ __forceinline__ void kn_coords(int id, int& nq, int& kq) {
    int lane = id & 31, wid = id >> 5;  // wid 0..15 over both blocks
    nq = (wid & 3) * 8 + (lane & 7);    // 0..31, four columns each
    kq = (wid >> 2) * 4 + (lane >> 3);  // 0..15, four k each
}

__device__ __forceinline__ void load_kn(const int8_t* __restrict__ q, int K, int N, int k0, int n0, int tid,
                                        uint32_t (&v)[8]) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        int nq, kq;
        kn_coords(tid + i * THREADS, nq, kq);
        int n = n0 + nq * 4, k = k0 + kq * 4;
        uint32_t r[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
            r[j] = (n < N && k + j < K) ? __ldg(reinterpret_cast<const uint32_t*>(q + (size_t)(k + j) * N + n)) : 0u;
        uint32_t t0 = __byte_perm(r[0], r[1], 0x5140), t1 = __byte_perm(r[2], r[3], 0x5140);
        uint32_t t2 = __byte_perm(r[0], r[1], 0x7362), t3 = __byte_perm(r[2], r[3], 0x7362);
        v[i * 4 + 0] = __byte_perm(t0, t1, 0x5410);
        v[i * 4 + 1] = __byte_perm(t0, t1, 0x7632);
        v[i * 4 + 2] = __byte_perm(t2, t3, 0x5410);
        v[i * 4 + 3] = __byte_perm(t2, t3, 0x7632);
    }
}

__device__ __forceinline__ void store_kn(int8_t* s, int tid, const uint32_t (&v)[8]) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        int nq, kq;
        kn_coords(tid + i * THREADS, nq, kq);
#pragma unroll
        for (int j = 0; j < 4; ++j)
            *reinterpret_cast<uint32_t*>(s + (nq * 4 + j) * LDS + kq * 4) = v[i * 4 + j];
    }
}

// One 64-deep shared-memory tile through the tensor cores.
__device__ __forceinline__ void mma_tile(const int8_t* As, const int8_t* Bs, int wm, int wn, int g, int tig,
                                         int (&acc)[4][4][4]) {
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
        uint32_t af[4][4], bf[4][2];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
            const int8_t* p = As + (wm * 64 + mt * 16 + g) * LDS + ks * 32 + tig * 4;
            af[mt][0] = *reinterpret_cast<const uint32_t*>(p);
            af[mt][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS);
            af[mt][2] = *reinterpret_cast<const uint32_t*>(p + 16);
            af[mt][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS + 16);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
            const int8_t* p = Bs + (wn * 32 + nt * 8 + g) * LDS + ks * 32 + tig * 4;
            bf[nt][0] = *reinterpret_cast<const uint32_t*>(p);
            bf[nt][1] = *reinterpret_cast<const uint32_t*>(p + 16);
        }
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) mma_s8(acc[mt][nt], af[mt], bf[nt]);
    }
}

// ---------------------------------------------------------------------------
// int8 x int8 -> int32 GEMM. B_KN = false: b is (N, C), contraction contiguous
// (out = a . b^T). B_KN = true: b is (C, N) row-major (out = a . b).
// ---------------------------------------------------------------------------
template <bool B_KN>
__global__ void __launch_bounds__(THREADS)
i8_gemm_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b, int M, int C, int N,
               int32_t* __restrict__ out) {
    __shared__ __align__(16) int8_t As[BM * LDS];
    __shared__ __align__(16) int8_t Bs[BN * LDS];
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int wm = warp >> 2, wn = warp & 3, g = lane >> 2, tig = lane & 3;
    const int row0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

    int acc[4][4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

    uint4 av[2];
    uint4 bv[2];
    uint32_t bt[8];
    load_rows<true>(a, M, C, row0, 0, tid, av);
    if (B_KN) load_kn(b, C, N, 0, n0, tid, bt);
    else load_rows<true>(b, N, C, n0, 0, tid, bv);

    for (int k0 = 0; k0 < C; k0 += BK) {
        __syncthreads();
        store_rows(As, tid, av);
        if (B_KN) store_kn(Bs, tid, bt);
        else store_rows(Bs, tid, bv);
        __syncthreads();
        if (k0 + BK < C) {
            load_rows<true>(a, M, C, row0, k0 + BK, tid, av);
            if (B_KN) load_kn(b, C, N, k0 + BK, n0, tid, bt);
            else load_rows<true>(b, N, C, n0, k0 + BK, tid, bv);
        }
        mma_tile(As, Bs, wm, wn, g, tig, acc);
    }

#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                int row = row0 + wm * 64 + mt * 16 + g + h * 8;
                int col = n0 + wn * 32 + nt * 8 + tig * 2;
                if (row >= M) continue;
                int32_t* o = out + (size_t)row * N + col;
                if (col + 1 < N && (N & 1) == 0) {
                    *reinterpret_cast<int2*>(o) = make_int2(acc[mt][nt][h * 2], acc[mt][nt][h * 2 + 1]);
                } else {
                    if (col < N) o[0] = acc[mt][nt][h * 2];
                    if (col + 1 < N) o[1] = acc[mt][nt][h * 2 + 1];
                }
            }
}

// ---------------------------------------------------------------------------
// K1: x (M, K) float . q (K, N) int8, activation quantised in the kernel per
// (row, k-block of bk), bk % 64 == 0, K % bk == 0, N % 4 == 0. One cooperative
// launch of one persistent block per SM, in two phases around a grid barrier:
// first all warps quantise x into the scratch xq (M, K) int8 and xs
// (M, K / bk) f32, one warp per (row, k-block); then the blocks walk the
// output tiles and run the int8 product on the scratch (L2-resident at these
// sizes), folding every k-block's int32 sum into the f32 accumulator.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void store_out2(float* o, float a, float b) { *reinterpret_cast<float2*>(o) = make_float2(a, b); }
__device__ __forceinline__ void store_out2(__nv_bfloat16* o, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(o) = __halves2bfloat162(__float2bfloat16_rn(a), __float2bfloat16_rn(b));
}

__device__ __forceinline__ void store_packed(int8_t* o, const uint32_t (&w)[2], float) { *reinterpret_cast<uint32_t*>(o) = w[0]; }
__device__ __forceinline__ void store_packed(int8_t* o, const uint32_t (&w)[2], __nv_bfloat16) {
    *reinterpret_cast<uint2*>(o) = make_uint2(w[0], w[1]);
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
w8a8_fused_kernel(const T* __restrict__ x, const int8_t* __restrict__ q, const float* __restrict__ wscale,
                  int M, int K, int N, int bk, int8_t* xq, float* xs, T* __restrict__ out) {
    __shared__ __align__(16) int8_t As[BM * LDS];
    __shared__ __align__(16) int8_t Bs[BN * LDS];
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int wm = warp >> 2, wn = warp & 3, g = lane >> 2, tig = lane & 3;
    const int nkb = K / bk;
    constexpr int PER = 16 / (int)sizeof(T);  // elements in one 16-byte load

    // Phase 1: quantise. A warp takes one (row, k-block) at a time: absmax,
    // then the quantised bytes (the second read of the block comes from L1).
    {
        const long long items = (long long)M * nkb;
        const long long stride = (long long)gridDim.x * (THREADS / 32);
        for (long long item = (long long)blockIdx.x * (THREADS / 32) + warp; item < items; item += stride) {
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
            if (lane == 0) xs[(size_t)row * nkb + kb] = s;
            int8_t* o = xq + (size_t)row * K + (size_t)kb * bk;
            for (int c = lane * PER; c < bk; c += 32 * PER) {
                uint4 raw = __ldg(reinterpret_cast<const uint4*>(p + c));
                const T* e = reinterpret_cast<const T*>(&raw);
                uint32_t w[2] = {0u, 0u};
#pragma unroll
                for (int j = 0; j < PER; ++j) w[j >> 2] |= (uint32_t)(quant1(to_float(e[j]), s) & 0xff) << (8 * (j & 3));
                store_packed(o + c, w, T());
            }
        }
    }
    cooperative_groups::this_grid().sync();

    // Phase 2: the product, over the output tiles this block owns. M tiles
    // vary fastest, so the blocks running together share the same few column
    // tiles of q.
    const int m_tiles = (M + BM - 1) / BM, n_tiles = (N + BN - 1) / BN;
    for (int tile = blockIdx.x; tile < m_tiles * n_tiles; tile += gridDim.x) {
        const int row0 = (tile % m_tiles) * BM, n0 = (tile / m_tiles) * BN;
        float facc[4][4][4];
        int acc[4][4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) { facc[i][j][e] = 0.f; acc[i][j][e] = 0; }

        uint4 av[2];
        uint32_t bt[8];
        load_rows<false>(xq, M, K, row0, 0, tid, av);
        load_kn(q, K, N, 0, n0, tid, bt);
        for (int k0 = 0; k0 < K; k0 += BK) {
            __syncthreads();
            store_rows(As, tid, av);
            store_kn(Bs, tid, bt);
            __syncthreads();
            if (k0 + BK < K) {
                load_rows<false>(xq, M, K, row0, k0 + BK, tid, av);
                load_kn(q, K, N, k0 + BK, n0, tid, bt);
            }
            mma_tile(As, Bs, wm, wn, g, tig, acc);
            if ((k0 + BK) % bk == 0) {
                // End of a k-block: acc_f32 += float(p) * s, two roundings as
                // the plain version makes, then start the next block from 0.
                const int kb = k0 / bk;
#pragma unroll
                for (int mt = 0; mt < 4; ++mt)
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        const int row = row0 + wm * 64 + mt * 16 + g + h * 8;
                        const float s = row < M ? xs[(size_t)row * nkb + kb] : 1.f;
#pragma unroll
                        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
                            for (int e = 0; e < 2; ++e) {
                                facc[mt][nt][h * 2 + e] = __fadd_rn(
                                    facc[mt][nt][h * 2 + e], __fmul_rn((float)acc[mt][nt][h * 2 + e], s));
                                acc[mt][nt][h * 2 + e] = 0;
                            }
                    }
            }
        }

#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int row = row0 + wm * 64 + mt * 16 + g + h * 8;
                    const int col = n0 + wn * 32 + nt * 8 + tig * 2;
                    if (row >= M || col >= N) continue;  // N % 4 == 0 and col is even: col + 1 < N too
                    store_out2(out + (size_t)row * N + col,
                               __fmul_rn(facc[mt][nt][h * 2], __ldg(wscale + col)),
                               __fmul_rn(facc[mt][nt][h * 2 + 1], __ldg(wscale + col + 1)));
                }
    }
}

// ---------------------------------------------------------------------------
// K2: per-row symmetric int8. One block per row; the optional column scale
// (1, K) is multiplied in at the load (the backward's dy * weight scale).
// ---------------------------------------------------------------------------
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

template <typename T>
__global__ void __launch_bounds__(RQ_THREADS)
rowquant_kernel(const T* __restrict__ x, const float* __restrict__ cs, int K, int8_t* __restrict__ q,
                float* __restrict__ s) {
    __shared__ float red[RQ_THREADS / 32];
    __shared__ float scale_sh;
    const T* xr = x + (size_t)blockIdx.x * K;
    int8_t* qr = q + (size_t)blockIdx.x * K;
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
            uint32_t w = 0u;
#pragma unroll
            for (int j = 0; j < 4; ++j) w |= (uint32_t)(quant1(v[j], sc) & 0xff) << (8 * j);
            *reinterpret_cast<uint32_t*>(qr + c) = w;
        }
    } else {
        for (int c = tid; c < K; c += RQ_THREADS) qr[c] = (int8_t)quant1(rq_value(xr, cs, c), sc);
    }
}

inline dim3 tile_grid(int M, int N) { return dim3((M + BM - 1) / BM, (N + BN - 1) / BN); }

}  // namespace

extern "C" {

int dalm_i8_tile_m() { return BM; }
int dalm_i8_tile_n() { return BN; }
int dalm_i8_tile_k() { return BK; }

// x (R, K) float32 (is_bf16 = 0) or bfloat16 (1); colscale (K,) float32 or null.
int dalm_i8_rowquant(const void* x, int is_bf16, const float* colscale, int R, int K, void* q, float* s,
                     cudaStream_t stream) {
    if (is_bf16)
        rowquant_kernel<__nv_bfloat16><<<R, RQ_THREADS, 0, stream>>>(
            static_cast<const __nv_bfloat16*>(x), colscale, K, static_cast<int8_t*>(q), s);
    else
        rowquant_kernel<float><<<R, RQ_THREADS, 0, stream>>>(
            static_cast<const float*>(x), colscale, K, static_cast<int8_t*>(q), s);
    return (int)cudaGetLastError();
}

// xq (M, K) int8 and xs (M, K / bk) float32 are scratch. The launch is
// cooperative: as many blocks as fit the card at once (one per SM).
int dalm_i8_w8a8_fused(const void* x, int is_bf16, const void* q, const float* wscale, int M, int K, int N,
                       int bk, void* xq, float* xs, void* out, cudaStream_t stream) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const void* fn = is_bf16 ? (const void*)w8a8_fused_kernel<__nv_bfloat16> : (const void*)w8a8_fused_kernel<float>;
    cudaError_t err = is_bf16
        ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, w8a8_fused_kernel<__nv_bfloat16>, THREADS, 0)
        : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, w8a8_fused_kernel<float>, THREADS, 0);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1 || sms < 1) return (int)cudaErrorLaunchOutOfResources;
    void* args[] = {(void*)&x, (void*)&q, (void*)&wscale, &M, &K, &N, &bk, &xq, &xs, &out};
    err = cudaLaunchCooperativeKernel(fn, dim3(sms * per_sm), dim3(THREADS), args, 0, stream);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

// a (M, K) int8 . q (K, N) int8 -> (M, N) int32.
int dalm_i8_gemm_kn(const void* a, const void* q, int M, int K, int N, void* out, cudaStream_t stream) {
    i8_gemm_kernel<true><<<tile_grid(M, N), THREADS, 0, stream>>>(
        static_cast<const int8_t*>(a), static_cast<const int8_t*>(q), M, K, N, static_cast<int32_t*>(out));
    return (int)cudaGetLastError();
}

// a (M, C) int8 . b (N, C)^T int8 -> (M, N) int32.
int dalm_i8_gemm_nt(const void* a, const void* b, int M, int C, int N, void* out, cudaStream_t stream) {
    i8_gemm_kernel<false><<<tile_grid(M, N), THREADS, 0, stream>>>(
        static_cast<const int8_t*>(a), static_cast<const int8_t*>(b), M, C, N, static_cast<int32_t*>(out));
    return (int)cudaGetLastError();
}

}  // extern "C"
