// K4: flash attention, forward and backward, hand-written for Hopper (sm_90a).
//
// Replaces dalm_tpu/kernels/flash_attention.py:
//   _flash_fwd / _fwd_kernel                   -> fa_fwd_kernel          (dalm_fa_fwd): float32 inputs and
//                                                 head dims other than 64 / 128; bfloat16 at 64 / 128 takes
//                                                 csrc/flash_fwd_wgmma.cu (kernels/flash_attention.py:fwd_route)
//   _flash_bwd / _bwd_dq_kernel                -> fa_bwd_kernel<.., false> (dalm_fa_bwd_dq)
//   _flash_bwd / _bwd_dkv_kernel               -> fa_bwd_kernel<.., true>  (dalm_fa_bwd_dkv)
//                                                 both for float32 inputs and head dims other than 64 / 128
//                                                 (16 to 256 in steps of 16);
//                                                 bfloat16 at 64 / 128 takes csrc/flash_bwd_wgmma.cu (the
//                                                 same route rule), which also holds the dsum pre-pass
//                                                 that both routes' dq and dk/dv read
//
// What they compute. out = softmax(q k^T * scale [softcap] [causal with
// q_offset, window, segments]) v without ever holding the (Sq, Sk) scores in
// device memory, and lse = log sum exp of each row (the residual that lets
// two partial results over disjoint key sets be merged, and that the backward
// recomputes p = exp(s - lse) from). A row with no visible key gives out = 0
// and lse = -1e30 (a finite "minus infinity", so merges stay NaN-free).
// Backward: ds = p * (do v^T - dsum) * [1 - (s/cap)^2] * scale, dq = ds k,
// dk = ds^T q, dv = p^T do, with dsum = rowsum(do * out) supplied by the
// caller (the wrapper computes it with the dsum pre-pass). GQA: query head h reads kv head h / (H / Hk); dk and dv come back at
// the kv head count.
//
// What bounds them on an H100. At the SFT shape (H = 32, S = 2560, D = 128,
// causal) the forward does 2 * S^2 * D useful operations per head against
// 4 * S * D * 2 bytes of q, k, v, out: about 640 operations per byte, far
// above the card's ~295, so all three are bound by operations (tensor cores).
// The design keeps both products of a tile on the tensor cores and everything
// between them (scale, cap, mask, online max and sum, exp) in registers.
//
// How it differs from the TPU kernels. Those carry the online-softmax state
// (m, l, acc) in VMEM scratch across a sequential innermost grid dimension and
// use 512 x 512 blocks. Here blocks run in no order, so one thread block owns
// one (batch, head, 64-row tile) and LOOPS over the 64-wide tiles of the other
// sequence itself, state in registers:
//   forward  one block per (b, h, q tile), loop over k tiles;
//   dq       one block per (b, h, q tile), loop over k tiles;
//   dk/dv    one block per (b, kv head, k tile), loop over the query heads of
//            the group and their q tiles, so the GQA sum needs no atomics and
//            is the same from run to run.
// Tiles that are wholly invisible (above the causal diagonal, beyond the
// window band) are skipped by a block-uniform test; tiles that are wholly
// visible (most of a long causal row: inside the matrix, below the diagonal,
// inside the band, one segment on both sides by a block vote) skip the
// per-element tests; the rest is masked element by element. The ragged edge (any Sq, Sk; D a multiple of 16 up to 256) is
// zero-filled on load and masked, so no length needs padding.
//
// A block has 4 warps; warp w owns rows [16 w, 16 w + 16) of the block's tile
// and all columns, so a row's max and sum need only a 4-lane shuffle. bf16
// products run on mma.sync m16n8k16 (f32 accumulate), every fragment read
// from padded shared-memory tiles through ldmatrix (conflict-free; .trans for
// the n-contiguous operand of p v, ds k, ds^T q and p^T do). The
// probabilities / ds are cast to the input type (as the TPU kernels cast them
// before their second product) and handed to the second product through a
// per-warp shared-memory strip. float32 inputs take the same code with the
// products on the CUDA cores (fmaf, in the mma accumulator layout): exact f32
// but slow, meant for tests and small models. Tiles come in through cp.async
// (16 bytes a copy, zero-filled outside the matrix). The forward keeps two
// copy groups in flight without a second buffer: the next K tile arrives
// while the current tile's softmax and p v run, the next V tile while the
// next q k^T runs. The backward kernels need both of a tile's operands until
// their last product, so they wait for each tile and lean on the other blocks
// of the SM to cover the copy. At bfloat16 and head dim 64 / 128 the forward and
// the backward have their own kernels on wgmma with warp-specialised TMA rings
// (csrc/flash_fwd_wgmma.cu, csrc/flash_bwd_wgmma.cu); this file serves the rest.
// The argument block, the mask and its tile classes live in flash_attention.cuh,
// which both files include.
//
// The dk/dv kernel is the dq kernel with the roles swapped: it computes
// s^T = k q^T and dp^T = v do^T directly, so no operand is ever needed
// transposed in shared memory.
//
// Head dims 129-256 (Gemma's 256) have instances of their own, padded to 256. A warp's accumulators are
// 16 rows x DP columns, DP / 8 registers a thread each: the forward's one (128 registers) and dq's one still fit
// beside their score tiles, dq with 32-wide key tiles instead of 64. dk/dv holds two (256 registers), which do
// not: at DP = 256 its output columns are split across two thread blocks (NSPLIT = 2). Both blocks of a k tile
// load the same rows and compute the same s^T and dp^T over all 256 columns of the contraction, and each
// accumulates and writes its own 128 columns of dk and dv. That costs the two score products once more (4 of
// the 6 products of a tile run twice) and keeps every accumulator in registers. Shared memory at DP = 256:
// forward 110 KB (bf16) / 212 KB (f32), dq and dk/dv 105-213 KB, each under the 227 KB a block may take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_attention.cuh"

namespace {

constexpr int BR = 64;        // rows of the tile a block owns: 4 warps x 16
constexpr int THREADS = 128;

template <typename T> struct Pad { static constexpr int v = 16 / (int)sizeof(T); };

__device__ __forceinline__ void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// 16 bytes global -> shared without passing through registers; `valid` false writes zeros
// (src-size 0: nothing is read, so any mapped address will do).
__device__ __forceinline__ void cp_async16(void* smem_dst, const void* src, bool valid) {
    const uint32_t dst = (uint32_t)__cvta_generic_to_shared(smem_dst);
    const int bytes = valid ? 16 : 0;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
// Wait until at most N of this thread's most recent groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

// rows [row0, row0 + ROWS) x columns [0, DP) of a (nrows, D) matrix with row stride
// `stride` into dst[ROWS][DP + Pad], 16 bytes a copy, asynchronously (the caller commits
// and waits); zero outside the matrix.
template <typename T, int ROWS, int DP>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long stride, int row0, int nrows, int D,
                                          int tid) {
    constexpr int VEC = Pad<T>::v, CPR = DP / VEC, LD = DP + VEC;
#pragma unroll
    for (int c = tid; c < ROWS * CPR; c += THREADS) {
        const int r = c / CPR, cc = (c % CPR) * VEC;
        const bool valid = row0 + r < nrows && cc < D;
        cp_async16(dst + r * LD + cc, valid ? src + (long long)(row0 + r) * stride + cc : src, valid);
    }
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem_ptr) {
    const uint32_t addr = (uint32_t)__cvta_generic_to_shared(smem_ptr);
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr)
                 : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem_ptr) {
    const uint32_t addr = (uint32_t)__cvta_generic_to_shared(smem_ptr);
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr)
                 : "memory");
}

// One warp: acc[16 x 8 NT] += A[16 x KD] . B, operands in shared memory.
// A[m][k] = A[m * lda + k]. B_NK: B[n][k] = B[n * ldb + k] (contraction contiguous);
// otherwise B[k][n] = B[k * ldb + n]. The accumulator has the layout of
// mma.sync m16n8k16: with g = lane / 4, t = lane % 4, acc[nt] holds
// C[g][8 nt + 2 t], C[g][8 nt + 2 t + 1], C[g + 8][8 nt + 2 t], C[g + 8][8 nt + 2 t + 1].
// Every fragment comes through ldmatrix, four 8 x 8 blocks a load: lane l gives the
// address of row l % 8 of block l / 8. Rows must be 16-byte aligned (lda, ldb multiples of 8).
template <int NT, int KD, bool B_NK>
__device__ __forceinline__ void warp_gemm(float (&acc)[NT][4], const __nv_bfloat16* A, int lda,
                                          const __nv_bfloat16* B, int ldb, int lane) {
    static_assert(NT % 2 == 0 && KD % 16 == 0, "tile shape");
    const int r8 = lane & 7, hi = (lane >> 3) & 1, top = lane >> 4;
#pragma unroll
    for (int k0 = 0; k0 < KD; k0 += 16) {
        uint32_t a[4];  // blocks: rows 0-7 / 8-15 of k [k0, k0 + 8), then of k [k0 + 8, k0 + 16)
        ldmatrix_x4(a, A + (r8 + hi * 8) * lda + k0 + top * 8);
#pragma unroll
        for (int nt = 0; nt < NT; nt += 2) {
            uint32_t r[4];  // b0, b1 of n-tile nt, then of n-tile nt + 1
            if (B_NK) ldmatrix_x4(r, B + ((nt + top) * 8 + r8) * ldb + k0 + hi * 8);
            else ldmatrix_x4_trans(r, B + (k0 + r8 + hi * 8) * ldb + (nt + top) * 8);
            mma_bf16(acc[nt], a, r[0], r[1]);
            mma_bf16(acc[nt + 1], a, r[2], r[3]);
        }
    }
}

// float32: the same contract on the CUDA cores.
template <int NT, int KD, bool B_NK>
__device__ __forceinline__ void warp_gemm(float (&acc)[NT][4], const float* A, int lda, const float* B, int ldb,
                                          int lane) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll 4
    for (int k = 0; k < KD; ++k) {
        const float a_lo = A[g * lda + k], a_hi = A[(g + 8) * lda + k];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
            const int n = nt * 8 + 2 * t;
            const float b0 = B_NK ? B[n * ldb + k] : B[k * ldb + n];
            const float b1 = B_NK ? B[(n + 1) * ldb + k] : B[k * ldb + n + 1];
            acc[nt][0] = fmaf(a_lo, b0, acc[nt][0]);
            acc[nt][1] = fmaf(a_lo, b1, acc[nt][1]);
            acc[nt][2] = fmaf(a_hi, b0, acc[nt][2]);
            acc[nt][3] = fmaf(a_hi, b1, acc[nt][3]);
        }
    }
}

// acc rows (g, g + 8 of the warp's 16) -> dst rows r0, r0 + 8 of a (nrows, D) matrix.
template <typename T, int DP>
__device__ __forceinline__ void store_rows(T* dst, long long stride, const float (&acc)[DP / 8][4], int r0,
                                           int nrows, int D, int t, float mul_lo, float mul_hi) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int r = r0 + 8 * i;
        if (r >= nrows) continue;
        const float mul = i ? mul_hi : mul_lo;
#pragma unroll
        for (int dt = 0; dt < DP / 8; ++dt) {
            const int col = dt * 8 + 2 * t;
            if (col < D) store2(dst + (long long)r * stride + col, acc[dt][2 * i] * mul, acc[dt][2 * i + 1] * mul);
        }
    }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------
// One tile of the online softmax for a warp's 16 rows: scale, cap and mask the scores,
// update the running maximum m and sum l, rescale the output accumulator o, and leave
// p (cast to the input type) in the warp's strip Pw. MASKED = false is for a tile in
// which every element is attended to.
template <typename T, int BC, int DP, bool MASKED>
__device__ __forceinline__ void fwd_softmax(float (&s)[BC / 8][4], float (&o)[DP / 8][4], float (&m)[2], float (&l)[2],
                                            T* Pw, const Mask& mk, int r0, int k0, const int (&sq)[2],
                                            const int* segk_s, float scale, float cap, float inv_cap, int g, int t) {
    constexpr int LDP = BC + Pad<T>::v;
    // scale, cap, mask; the row maxima of this tile
    uint32_t keepbits = 0xffffffffu;
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int nt = 0; nt < BC / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int i = e >> 1, col = nt * 8 + 2 * t + (e & 1);
            float val = s[nt][e] * scale;
            if (cap > 0.f) val = tanhf(val * inv_cap) * cap;  // cap before masking
            if (MASKED) {
                const bool keep = keep_at(mk, r0 + 8 * i, k0 + col, sq[i], mk.has_seg ? segk_s[col] : 0);
                val = keep ? val : NEG_INF;
                if (!keep) keepbits &= ~(1u << (nt * 4 + e));
            }
            s[nt][e] = val;
            mx[i] = fmaxf(mx[i], val);
        }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const float m_new = fmaxf(m[i], quad_max(mx[i]));
        alpha[i] = expf(m[i] - m_new);
        m[i] = m_new;
    }
    // p = exp(s - m), SELECTED to 0 where masked: a row with nothing visible so far
    // has m = NEG_INF and exp(s - m) = 1 there.
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < BC / 8; ++nt)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            float p0 = expf(s[nt][2 * i] - m[i]), p1 = expf(s[nt][2 * i + 1] - m[i]);
            if (MASKED) {
                p0 = ((keepbits >> (nt * 4 + 2 * i)) & 1u) ? p0 : 0.f;
                p1 = ((keepbits >> (nt * 4 + 2 * i + 1)) & 1u) ? p1 : 0.f;
            }
            sum[i] += p0 + p1;
            store2(Pw + (g + 8 * i) * LDP + nt * 8 + 2 * t, p0, p1);  // cast to the input type
        }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + quad_sum(sum[i]);
#pragma unroll
    for (int dt = 0; dt < DP / 8; ++dt) {
        o[dt][0] *= alpha[0]; o[dt][1] *= alpha[0];
        o[dt][2] *= alpha[1]; o[dt][3] *= alpha[1];
    }
}

template <typename T, int DP>
constexpr int fwd_smem_bytes() {
    return (int)sizeof(T) * (3 * BR * (DP + Pad<T>::v) + BR * (BR + Pad<T>::v)) + BR * (int)sizeof(int);
}

template <typename T, int DP>
__global__ void __launch_bounds__(THREADS) fa_fwd_kernel(const Args a) {
    constexpr int BC = BR;  // keys a tile
    constexpr int LD = DP + Pad<T>::v, LDP = BC + Pad<T>::v;
    extern __shared__ __align__(16) unsigned char smem[];
    T* Qs = reinterpret_cast<T*>(smem);   // [BR][LD]
    T* Ks = Qs + BR * LD;                 // [BC][LD]
    T* Vs = Ks + BC * LD;                 // [BC][LD]
    T* Ps = Vs + BC * LD;                 // 4 warps x [16][LDP]
    int* segk_s = reinterpret_cast<int*>(Ps + BR * LDP);  // [BC]

    const Mask mk = make_mask(a);
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int D = (int)a.D, H = (int)a.H;
    const int q0 = ((int)gridDim.x - 1 - (int)blockIdx.x) * BR;  // the longest causal rows first
    const int h = blockIdx.y, b = blockIdx.z, hk = h / (H / (int)a.Hk);
    const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
    const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
    const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;
    const float scale = (float)a.scale, cap = (float)a.softcap;
    const float inv_cap = cap > 0.f ? 1.0f / cap : 0.f;

    const int r0 = q0 + warp * 16 + g;  // this thread's rows: r0 and r0 + 8
    int sq[2] = {0, 0};
    if (mk.has_seg) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
            if (r0 + 8 * i < mk.Sq) sq[i] = a.seg_q[(long long)b * mk.Sq + r0 + 8 * i];
    }
    // Segments cost a test per element only where a tile mixes them: one vote over the block's
    // rows here, one over each k tile's keys (folded into that tile's first barrier).
    const int seg_first = mk.has_seg ? a.seg_q[(long long)b * mk.Sq + min(q0, mk.Sq - 1)] : 0;
    const bool q_one_seg = mk.has_seg ? __syncthreads_and(sq[0] == seg_first && sq[1] == seg_first) != 0 : true;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    float o[DP / 8][4];
#pragma unroll
    for (int dt = 0; dt < DP / 8; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
    T* Pw = Ps + warp * 16 * LDP;

    // The visible k tiles are one range: the window band cuts its low end, causality its high end.
    int j_lo = 0, j_hi = (mk.Sk + BC - 1) / BC;
    while (j_lo < j_hi && !tile_visible(mk, q0, BR, j_lo * BC, BC)) ++j_lo;
    while (j_hi > j_lo && !tile_visible(mk, q0, BR, (j_hi - 1) * BC, BC)) --j_hi;

    // Two copy groups are in flight at any time, K then V: while a tile's softmax and p v run, the next
    // K tile arrives; while the next q k^T runs, the next V tile does. Every point that may start a copy commits a group
    // (an empty one after the last tile), so "all but the newest group" always names the tile needed next.
    if (j_lo < j_hi) {
        load_tile<T, BR, DP>(Qs, qp, a.q_ss, q0, mk.Sq, D, tid);
        load_tile<T, BC, DP>(Ks, kp, a.k_ss, j_lo * BC, mk.Sk, D, tid);
        cp_async_commit();
        load_tile<T, BC, DP>(Vs, vp, a.v_ss, j_lo * BC, mk.Sk, D, tid);
        cp_async_commit();
    }
    for (int j = j_lo; j < j_hi; ++j) {
        const int k0 = j * BC;
        // the last readers of segk_s passed the barrier before the previous p v
        int my_segk = seg_first;
        if (mk.has_seg && tid < BC) {
            my_segk = (k0 + tid < mk.Sk) ? a.seg_k[(long long)b * mk.Sk + k0 + tid] : 0;
            segk_s[tid] = my_segk;
        }
        cp_async_wait<1>();  // K (and, the first time, Q) has landed
        const bool k_same_seg = __syncthreads_and(my_segk == seg_first) != 0;

        float s[BC / 8][4];
#pragma unroll
        for (int nt = 0; nt < BC / 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
        warp_gemm<BC / 8, DP, true>(s, Qs + warp * 16 * LD, LD, Ks, LD, lane);
        __syncthreads();  // every warp is done with Ks
        if (j + 1 < j_hi) load_tile<T, BC, DP>(Ks, kp, a.k_ss, k0 + BC, mk.Sk, D, tid);
        cp_async_commit();

        // most tiles of a long causal row are wholly visible: they skip the per-element tests
        const bool full = tile_full(mk, q0, BR, k0, BC) && (!mk.has_seg || (q_one_seg && k_same_seg));
        if (full) fwd_softmax<T, BC, DP, false>(s, o, m, l, Pw, mk, r0, k0, sq, segk_s, scale, cap, inv_cap, g, t);
        else fwd_softmax<T, BC, DP, true>(s, o, m, l, Pw, mk, r0, k0, sq, segk_s, scale, cap, inv_cap, g, t);
        cp_async_wait<1>();  // V has landed (the K copy just issued may still fly)
        __syncthreads();     // also orders this warp's Pw stores before its loads
        warp_gemm<DP / 8, BC, false>(o, Pw, LDP, Vs, LD, lane);
        __syncthreads();  // every warp is done with Vs
        if (j + 1 < j_hi) load_tile<T, BC, DP>(Vs, vp, a.v_ss, k0 + BC, mk.Sk, D, tid);
        cp_async_commit();
    }
    cp_async_wait<0>();

    T* op = static_cast<T*>(a.out) + b * a.o_sb + h * a.o_sh;
    store_rows<T, DP>(op, a.o_ss, o, r0, mk.Sq, D, t, 1.0f / fmaxf(l[0], 1e-30f), 1.0f / fmaxf(l[1], 1e-30f));
    if (t == 0) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
            if (r0 + 8 * i < mk.Sq)
                a.lse[((long long)b * H + h) * mk.Sq + r0 + 8 * i] = l[i] > 0.f ? m[i] + logf(l[i]) : NEG_INF;
    }
}

// ---------------------------------------------------------------------------
// backward. The block owns 64 "rows" and loops over tiles of BC "columns":
//   dq   (DKV = false): rows are queries (X = q, Y = do), columns keys (U = k, W = v);
//   dkdv (DKV = true):  rows are keys (X = k, Y = v), columns the queries of every
//                       head of the group (U = q, W = do).
// Either way s = X U^T, dp = Y W^T, acc1 += ds U (dq, or dk) and, for dkdv,
// acc2 += p W (dv).
// ---------------------------------------------------------------------------
// One tile of the backward for a warp's 16 rows: from the scores s and dp = do v^T,
// p = exp(s - lse) and ds = p (dp - dsum) [1 - (s / cap)^2] scale, both cast to the
// input type into the warp's strips (p only for dk/dv). MASKED = false is for a tile in
// which every element is attended to.
template <typename T, int BC, bool DKV, bool MASKED>
__device__ __forceinline__ void bwd_probs(const float (&s)[BC / 8][4], const float (&dp)[BC / 8][4], T* dSw, T* Pw,
                                          const Mask& mk, int r0, int c0, const int (&row_seg)[2], const int* col_seg,
                                          const float (&row_lse)[2], const float (&row_dsum)[2], const float* col_lse,
                                          const float* col_dsum, float scale, float cap, float inv_cap, int g, int t) {
    constexpr int LDP = BC + Pad<T>::v;
#pragma unroll
    for (int nt = 0; nt < BC / 8; ++nt)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            float pv[2], dsv[2];
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                const int col = nt * 8 + 2 * t + j;
                float val = s[nt][2 * i + j] * scale;
                if (cap > 0.f) val = tanhf(val * inv_cap) * cap;
                const float lse_v = DKV ? col_lse[col] : row_lse[i];
                const float dsum_v = DKV ? col_dsum[col] : row_dsum[i];
                float p = expf(val - lse_v);
                if (MASKED) {
                    const int r = r0 + 8 * i, c = c0 + col;
                    const int cs = mk.has_seg ? col_seg[col] : 0;
                    const bool keep = DKV ? keep_at(mk, c, r, cs, row_seg[i]) : keep_at(mk, r, c, row_seg[i], cs);
                    // exp(s - lse) overflows on a fully masked row (lse = -1e30): select, never multiply by 0
                    p = keep ? p : 0.f;
                }
                float ds = p * (dp[nt][2 * i + j] - dsum_v);
                if (cap > 0.f) {
                    const float th = val * inv_cap;  // d tanh: 1 - (capped s / cap)^2
                    ds = ds * (1.f - th * th);
                }
                pv[j] = p;
                dsv[j] = (!MASKED || p != 0.f) ? ds * scale : 0.f;
            }
            store2(dSw + (g + 8 * i) * LDP + nt * 8 + 2 * t, dsv[0], dsv[1]);
            if constexpr (DKV) store2(Pw + (g + 8 * i) * LDP + nt * 8 + 2 * t, pv[0], pv[1]);
        }
}

template <typename T, int DP, int BC, bool DKV>
constexpr int bwd_smem_bytes() {
    return (int)sizeof(T) * (2 * BR * (DP + Pad<T>::v) + 2 * BC * (DP + Pad<T>::v) + (DKV ? 2 : 1) * BR * (BC + Pad<T>::v))
           + BC * (2 * (int)sizeof(float) + (int)sizeof(int));
}

// NSPLIT (dk/dv only): the block writes columns [d0, d0 + DP / NSPLIT) of dk and dv, d0 from blockIdx.x.
template <typename T, int DP, int BC, bool DKV, int NSPLIT>
__global__ void __launch_bounds__(THREADS) fa_bwd_kernel(const Args a) {
    static_assert(DKV || NSPLIT == 1, "only dk/dv splits its output columns");
    constexpr int LD = DP + Pad<T>::v, LDP = BC + Pad<T>::v, DO = DP / NSPLIT;
    extern __shared__ __align__(16) unsigned char smem[];
    T* Xs = reinterpret_cast<T*>(smem);  // [BR][LD]
    T* Ys = Xs + BR * LD;                // [BR][LD]
    T* Us = Ys + BR * LD;                // [BC][LD]
    T* Ws = Us + BC * LD;                // [BC][LD]
    T* dSs = Ws + BC * LD;               // 4 warps x [16][LDP]: ds in the input type
    T* Pss = dSs + BR * LDP;             // the same for p (dkdv only)
    float* col_lse = reinterpret_cast<float*>(Pss + (DKV ? BR * LDP : 0));  // [BC] (dkdv: per query column)
    float* col_dsum = col_lse + BC;                                        // [BC]
    int* col_seg = reinterpret_cast<int*>(col_dsum + BC);                  // [BC]

    const Mask mk = make_mask(a);
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int D = (int)a.D, H = (int)a.H, group = H / (int)a.Hk;
    const int b = blockIdx.z;
    const int row0 = (DKV ? (int)blockIdx.x / NSPLIT : (int)gridDim.x - 1 - (int)blockIdx.x) * BR;
    const int d0 = ((int)blockIdx.x % NSPLIT) * DO;  // the first output column of this block
    const int hk = DKV ? (int)blockIdx.y : (int)blockIdx.y / group;
    const int h_first = DKV ? hk * group : (int)blockIdx.y, h_last = DKV ? h_first + group : h_first + 1;
    const int n_rows = DKV ? mk.Sk : mk.Sq, n_cols = DKV ? mk.Sq : mk.Sk;
    const float scale = (float)a.scale, cap = (float)a.softcap;
    const float inv_cap = cap > 0.f ? 1.0f / cap : 0.f;

    const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
    const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;
    if (DKV) {
        load_tile<T, BR, DP>(Xs, kp, a.k_ss, row0, n_rows, D, tid);
        load_tile<T, BR, DP>(Ys, vp, a.v_ss, row0, n_rows, D, tid);
    } else {
        const int h = h_first;
        load_tile<T, BR, DP>(Xs, static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh, a.q_ss, row0, n_rows, D, tid);
        load_tile<T, BR, DP>(Ys, static_cast<const T*>(a.dout) + b * a.do_sb + h * a.do_sh, a.do_ss, row0, n_rows,
                             D, tid);
    }
    cp_async_commit();
    const int r0 = row0 + warp * 16 + g;  // this thread's rows: r0 and r0 + 8
    int row_seg[2] = {0, 0};
    float row_lse[2] = {0.f, 0.f}, row_dsum[2] = {0.f, 0.f};  // dq only
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int r = r0 + 8 * i;
        if (r >= n_rows) continue;
        if (mk.has_seg) row_seg[i] = DKV ? a.seg_k[(long long)b * mk.Sk + r] : a.seg_q[(long long)b * mk.Sq + r];
        if (!DKV) {
            row_lse[i] = a.lse[((long long)b * H + h_first) * mk.Sq + r];
            row_dsum[i] = a.dsum[((long long)b * H + h_first) * mk.Sq + r];
        }
    }
    // as in the forward: a vote over the block's rows here, one over each tile's columns below
    const int seg_first = !mk.has_seg ? 0 : (DKV ? a.seg_k[(long long)b * mk.Sk + min(row0, n_rows - 1)]
                                                 : a.seg_q[(long long)b * mk.Sq + min(row0, n_rows - 1)]);
    const bool row_one_seg =
        mk.has_seg ? __syncthreads_and(row_seg[0] == seg_first && row_seg[1] == seg_first) != 0 : true;
    float acc1[DO / 8][4], acc2[DKV ? DO / 8 : 1][4];
#pragma unroll
    for (int dt = 0; dt < DO / 8; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            acc1[dt][e] = 0.f;
            if constexpr (DKV) acc2[dt][e] = 0.f;
        }
    T* dSw = dSs + warp * 16 * LDP;
    T* Pw = Pss + warp * 16 * LDP;

    for (int h = h_first; h < h_last; ++h) {
        const T* up = DKV ? static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh : kp;
        const T* wp = DKV ? static_cast<const T*>(a.dout) + b * a.do_sb + h * a.do_sh : vp;
        const long long u_ss = DKV ? a.q_ss : a.k_ss, w_ss = DKV ? a.do_ss : a.v_ss;
        for (int c0 = 0; c0 < n_cols; c0 += BC) {
            if (!(DKV ? tile_visible(mk, c0, BC, row0, BR) : tile_visible(mk, row0, BR, c0, BC))) continue;
            __syncthreads();
            load_tile<T, BC, DP>(Us, up, u_ss, c0, n_cols, D, tid);
            load_tile<T, BC, DP>(Ws, wp, w_ss, c0, n_cols, D, tid);
            int my_seg = seg_first;
            if (tid < BC) {
                const int c = c0 + tid;
                const bool in = c < n_cols;
                if (DKV) {
                    const long long at = ((long long)b * H + h) * mk.Sq + c;
                    col_lse[tid] = in ? a.lse[at] : 0.f;
                    col_dsum[tid] = in ? a.dsum[at] : 0.f;
                }
                if (mk.has_seg) {
                    my_seg = !in ? 0 : (DKV ? a.seg_q[(long long)b * mk.Sq + c] : a.seg_k[(long long)b * mk.Sk + c]);
                    col_seg[tid] = my_seg;
                }
            }
            cp_async_commit();
            cp_async_wait<0>();  // this tile and, the first time, the block's own rows
            const bool col_same_seg = __syncthreads_and(my_seg == seg_first) != 0;

            float s[BC / 8][4], dp[BC / 8][4];
#pragma unroll
            for (int nt = 0; nt < BC / 8; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
            warp_gemm<BC / 8, DP, true>(s, Xs + warp * 16 * LD, LD, Us, LD, lane);
            warp_gemm<BC / 8, DP, true>(dp, Ys + warp * 16 * LD, LD, Ws, LD, lane);

            const bool full = (DKV ? tile_full(mk, c0, BC, row0, BR) : tile_full(mk, row0, BR, c0, BC)) &&
                              (!mk.has_seg || (row_one_seg && col_same_seg));
            if (full)
                bwd_probs<T, BC, DKV, false>(s, dp, dSw, Pw, mk, r0, c0, row_seg, col_seg, row_lse, row_dsum, col_lse,
                                             col_dsum, scale, cap, inv_cap, g, t);
            else
                bwd_probs<T, BC, DKV, true>(s, dp, dSw, Pw, mk, r0, c0, row_seg, col_seg, row_lse, row_dsum, col_lse,
                                            col_dsum, scale, cap, inv_cap, g, t);
            __syncwarp();
            warp_gemm<DO / 8, BC, false>(acc1, dSw, LDP, Us + d0, LD, lane);
            if constexpr (DKV) warp_gemm<DO / 8, BC, false>(acc2, Pw, LDP, Ws + d0, LD, lane);
        }
    }

    if constexpr (DKV) {
        store_rows<T, DO>(static_cast<T*>(a.dk) + b * a.dk_sb + hk * a.dk_sh + d0, a.dk_ss, acc1, r0, n_rows, D - d0,
                          t, 1.f, 1.f);
        store_rows<T, DO>(static_cast<T*>(a.dv) + b * a.dv_sb + hk * a.dv_sh + d0, a.dv_ss, acc2, r0, n_rows, D - d0,
                          t, 1.f, 1.f);
    } else {
        store_rows<T, DP>(static_cast<T*>(a.dq) + b * a.dq_sb + h_first * a.dq_sh, a.dq_ss, acc1, r0, n_rows, D, t,
                          1.f, 1.f);
    }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------
template <typename K>
cudaError_t launch(K kernel, int smem_bytes, dim3 grid, const Args& a, cudaStream_t stream) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return err;
    kernel<<<grid, THREADS, smem_bytes, stream>>>(a);
    return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_one(int which, const Args& a, cudaStream_t stream) {
    const unsigned B = (unsigned)a.B, H = (unsigned)a.H, Hk = (unsigned)a.Hk;
    const unsigned nq = (unsigned)((a.Sq + BR - 1) / BR), nk = (unsigned)((a.Sk + BR - 1) / BR);
    // the dk/dv block holds two D-wide accumulators: narrower column tiles at D > 64 keep it in registers, and
    // at D > 128 each block takes half of the output columns; dq's one accumulator takes 32-wide key tiles there
    constexpr int BC_DKV = DP > 64 ? 32 : 64, NSPLIT = DP > 128 ? 2 : 1, BC_DQ = DP > 128 ? 32 : 64;
    if (which == 0) return launch(fa_fwd_kernel<T, DP>, fwd_smem_bytes<T, DP>(), dim3(nq, H, B), a, stream);
    if (which == 1)
        return launch(fa_bwd_kernel<T, DP, BC_DQ, false, 1>, bwd_smem_bytes<T, DP, BC_DQ, false>(), dim3(nq, H, B), a,
                      stream);
    return launch(fa_bwd_kernel<T, DP, BC_DKV, true, NSPLIT>, bwd_smem_bytes<T, DP, BC_DKV, true>(),
                  dim3(nk * NSPLIT, Hk, B), a, stream);
}

int dispatch(int which, const Args* args, void* stream) {
    const Args& a = *args;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (a.D < 16 || a.D > 256 || a.D % 16 || a.B < 1 || a.H < 1 || a.Hk < 1 || a.H % a.Hk || a.Sq < 1 || a.Sk < 1)
        return (int)cudaErrorInvalidValue;
    const int dp = a.D <= 32 ? 32 : (a.D <= 64 ? 64 : (a.D <= 128 ? 128 : 256));
    cudaError_t err;
    if (a.is_bf16) {
        err = dp == 32 ? launch_one<__nv_bfloat16, 32>(which, a, st)
            : dp == 64 ? launch_one<__nv_bfloat16, 64>(which, a, st)
            : dp == 128 ? launch_one<__nv_bfloat16, 128>(which, a, st)
                        : launch_one<__nv_bfloat16, 256>(which, a, st);
    } else {
        err = dp == 32 ? launch_one<float, 32>(which, a, st)
            : dp == 64 ? launch_one<float, 64>(which, a, st)
            : dp == 128 ? launch_one<float, 128>(which, a, st)
                        : launch_one<float, 256>(which, a, st);
    }
    return (int)err;
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch (0 = launched).
int dalm_fa_fwd(const void* args, void* stream) { return dispatch(0, static_cast<const Args*>(args), stream); }
int dalm_fa_bwd_dq(const void* args, void* stream) { return dispatch(1, static_cast<const Args*>(args), stream); }
int dalm_fa_bwd_dkv(const void* args, void* stream) { return dispatch(2, static_cast<const Args*>(args), stream); }
int dalm_fa_args_bytes() { return (int)sizeof(Args); }
int dalm_fa_tile_rows() { return BR; }

}  // extern "C"
