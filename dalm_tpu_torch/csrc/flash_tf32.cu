// K4's float32 route on the tensor cores: flash attention forward and backward
// for float32 inputs at head dim 64 and 128, every product split 3xTF32,
// hand-written for Hopper (sm_90a).
//
// Replaces dalm_tpu/kernels/flash_attention.py, for float32 inputs at head dim
// 64 / 128 (kernels/flash_attention.py:fwd_route names this route "tf32x3"):
//   _flash_fwd / _fwd_kernel                   -> fa_tf32_fwd_kernel<DP>             (dalm_fa_fwd_tf32)
//   _flash_bwd / _bwd_dq_kernel                -> fa_tf32_bwd_kernel<DP, BC, false>  (dalm_fa_bwd_dq_tf32)
//   _flash_bwd / _bwd_dkv_kernel               -> fa_tf32_bwd_kernel<DP, BC, true>   (dalm_fa_bwd_dkv_tf32)
// The other float32 head dims (16-48, 80-112, 144-256) stay on csrc/flash_attention.cu's exact
// mma.sync kernels; the dsum pre-pass every route's dq and dk/dv read is csrc/flash_bwd_wgmma.cu's.
//
// What they compute: the function of csrc/flash_attention.cu's kernels, with the same argument
// block (flash_attention.cuh), strides, masks (causal with q_offset, window, segments, softcap),
// GQA (dk / dv summed over the group's query heads inside one block, no atomics) and lse / NEG_INF
// contract. Only the products differ: each f32 operand x of a product is split into
// hi = tf32(x) (cvt.rna: 10 mantissa bits, rounded to nearest) and lo = tf32(x - hi), and a.b is
// taken as lo(a).hi(b) + hi(a).lo(b) + hi(a).hi(b) by mma.sync m16n8k8 .tf32, the two small
// terms first. The dropped lo.lo term and the rounding of lo leave under 2^-20 of each product
// (3 x 2^-22 at worst): this is how a TPU's MXU does an f32 product in bf16 passes. p and ds are
// split the same way before their products. The tensor cores sum a short chunk from zero (two
// k-steps of a first product, one 32- or 64-wide tile of a second), and an f32 add rounded to
// nearest joins it to the running sum: their own f32 additions are not round-to-nearest, and a
// sum carried through them over a 2,560-key row drifts toward zero (on an H100, accumulating every
// product in the tensor cores put the forward's out at 1.75x and dq at 1.38x their bounds at the
// RC pipeline's geometry). The CPU tests emulate this arithmetic against the exact formulas
// (tests/test_torch_flash_attention.py).
//
// What bounds them on an H100. At the RC pipeline's SFT geometry (B 1, H 32 / Hk 8, S 2,560,
// D 128, causal) the forward does 2 products of 2 S^2 D per head over the visible half: 54 GFLOP,
// 0.80 ms at the 67 TFLOP/s of the CUDA cores (csrc/flash_attention.cu's route), 3 x 54 GFLOP
// = 0.33 ms at the 495 TFLOP/s of TF32 on the tensor cores. Bytes are far below either. So it is
// bound by operations, and the design keeps every product on the tensor cores and the splits
// (five instructions an operand value) in registers.
//
// The design.
//   - mma.sync m16n8k8 .tf32, not wgmma. wgmma reads 32-bit operands from shared memory
//     K-major only (no transpose for .tf32), so the second product of every kernel (p v,
//     ds k, ds^T q, p^T do) would need its tile transposed in shared memory, and a hi / lo pair
//     doubles every 33 KB f32 tile: K, V and their splits alone would pass a block's 227 KB.
//   - The first products (q k^T, do v^T; k q^T, v do^T for dk/dv) read both fragments through
//     ldmatrix: an 8 x 8 b16 block is an 8 x 4 f32 block, of which lane l takes row l / 4,
//     value l % 4, which is the m16n8k8 tf32 fragment layout.
//   - Operands are split with two integer operations each (cvt.rna.tf32 made the forward 1.45x
//     slower); the k-loop of a first product is unrolled a chunk at a time (unrolled whole, the
//     kernels spilled at 255 registers and the forward took 1.42x as long).
//   - The second products take p / ds straight from the registers the scores were computed in:
//     an m16n8 accumulator tile is an m16n8k8 A fragment once the contraction is reordered
//     (within each 8 columns the fragment's column t is the tile's column 2 t and its column
//     t + 4 the tile's 2 t + 1), so no probability strip goes through shared memory and no
//     value moves between lanes; the B rows are read in the same order, one 32-bit load each.
//   - Every tile row is DP + 4 floats: ldmatrix's 8 rows fall on distinct 16-byte bank groups,
//     and the second products' loads (rows 2 t / 2 t + 1, column g) on 32 distinct banks.
//   - Tiles come through cp.async (16 bytes a copy, zero-filled outside the matrix). Without
//     the probability strips a block takes 101 KB at D 128 (q, k, v; dq with 32-key tiles; dk/dv
//     with 32-query tiles), so two blocks share an SM. The forward keeps the next K tile in flight
//     while the softmax and p v run, and the next V tile while the next q k^T runs, as the
//     mma.sync forward does; the backward waits for each tile and leans on the SM's other block.
//   - Blocks as in csrc/flash_attention.cu: forward and dq one (b, h, 64-row tile) each, the
//     longest causal rows first; dk/dv one (b, kv head, 64-key tile), looping over the group's
//     query heads, but as a cluster of KV_SPLIT = 2 blocks that take the tile's visible (head,
//     query tile) pairs in turns and add their partial dk / dv through distributed shared memory
//     at the end, in rank order. One block a key tile left 320 long blocks for 264 places at the RC
//     pipeline's geometry, the longest (key tile 0, every query) setting the kernel's time: 3.99 ms
//     against 3.49 with the cluster, on an H100.
//     Tiles masked whole are skipped, tiles visible whole skip the element tests.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_attention.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int BR = 64;  // rows of the tile a block owns: 4 warps x 16
constexpr int THREADS = 128;
constexpr int PAD = 4;  // floats of padding a tile row (rows 16 bytes apart modulo 128 bytes)
constexpr int KV_SPLIT = 2;  // dk/dv: the blocks of one key tile, one cluster, that share its (head, query tile) work

// 16 bytes global -> shared; `valid` false writes zeros (src-size 0: nothing is read).
__device__ __forceinline__ void cp_async16(void* smem_dst, const void* src, bool valid) {
    const uint32_t dst = (uint32_t)__cvta_generic_to_shared(smem_dst);
    const int bytes = valid ? 16 : 0;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

// rows [row0, row0 + ROWS) x columns [0, DP) of a (nrows, D) f32 matrix with row stride `stride` into
// dst[ROWS][DP + PAD], asynchronously (the caller commits and waits); zero outside the matrix.
template <int ROWS, int DP>
__device__ __forceinline__ void load_tile(float* dst, const float* src, long long stride, int row0, int nrows, int D,
                                          int tid) {
    constexpr int CPR = DP / 4, LD = DP + PAD;
#pragma unroll
    for (int c = tid; c < ROWS * CPR; c += THREADS) {
        const int r = c / CPR, cc = (c % CPR) * 4;
        const bool valid = row0 + r < nrows && cc < D;
        cp_async16(dst + r * LD + cc, valid ? src + (long long)(row0 + r) * stride + cc : src, valid);
    }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem_ptr) {
    const uint32_t addr = (uint32_t)__cvta_generic_to_shared(smem_ptr);
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr)
                 : "memory");
}

// tf32(x) rounded to nearest, ties away from zero, as cvt.rna.tf32.f32 gives it: half a tf32 ulp added to the
// magnitude bits, the 13 low bits cleared. Two integer operations on the full-rate pipes (cvt took 1.45x the
// forward's time on an H100).
__device__ __forceinline__ uint32_t tf32_rna(uint32_t bits) { return (bits + 0x1000u) & 0xFFFFE000u; }

// x = hi + lo + (at most 2^-22 of x): hi = tf32(x), lo = tf32(x - hi), both rounded to nearest.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
    hi = tf32_rna(__float_as_uint(x));
    lo = tf32_rna(__float_as_uint(x - __uint_as_float(hi)));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b in 3xTF32 on the tensor cores: lo(a) hi(b) + hi(a) lo(b), then hi(a) hi(b).
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4], const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0, uint32_t bl1) {
    mma_tf32(d, al, bh0, bh1);
    mma_tf32(d, ah, bl0, bl1);
    mma_tf32(d, ah, bh0, bh1);
}

// c += d in f32, rounded to nearest: how a chunk's tensor-core sum joins the running one.
template <int N>
__device__ __forceinline__ void add_rn(float (&c)[N][4], float (&d)[N][4]) {
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            c[n][i] = __fadd_rn(c[n][i], d[n][i]);
            d[n][i] = 0.f;
        }
}

// k-steps of a first product summed from zero by the tensor cores before add_rn joins them to the running sum
constexpr int NK_CHUNK = 2;

// One warp, the first products: acc[16 x 8 NT] += A[16 x KD] . B^T (NK_CHUNK k-steps at a time summed apart, then
// added with add_rn) with A[m][k] = A[m * lda + k] and
// B[n][k] = B[n * ldb + k] (both contiguous along the contraction) in shared memory. The accumulator has the
// layout of mma.sync m16n8: with g = lane / 4, t = lane % 4, acc[nt] holds C[g][8 nt + 2 t], C[g][8 nt + 2 t + 1],
// C[g + 8][8 nt + 2 t], C[g + 8][8 nt + 2 t + 1]. Every fragment comes through ldmatrix, four 8 x 4 f32 blocks a
// load (lane l gives the address of row l % 8 of block l / 8): A's blocks are rows 0-7 / 8-15 at k0, then at
// k0 + 4 (a0..a3 of m16n8k8: (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)); B's are n-tile nt at k0, k0 + 4,
// then n-tile nt + 1 (b0, b1: (k t, n g), (k t + 4, n g)).
template <int NT, int KD>
__device__ __forceinline__ void gemm_nk(float (&acc)[NT][4], const float* A, int lda, const float* B, int ldb,
                                        int lane) {
    static_assert(NT % 2 == 0 && KD % (8 * NK_CHUNK) == 0, "tile shape");
    const int r8 = lane & 7, hi = (lane >> 3) & 1, top = lane >> 4;
    float d[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) d[nt][i] = 0.f;
#pragma unroll 1
    for (int kc = 0; kc < KD; kc += 8 * NK_CHUNK) {
#pragma unroll
        for (int k0 = kc; k0 < kc + 8 * NK_CHUNK; k0 += 8) {
            uint32_t a[4], ah[4], al[4];
            ldmatrix_x4(a, A + (r8 + hi * 8) * lda + k0 + top * 4);
#pragma unroll
            for (int i = 0; i < 4; ++i) split(__uint_as_float(a[i]), ah[i], al[i]);
#pragma unroll
            for (int nt = 0; nt < NT; nt += 2) {
                uint32_t r[4], bh[4], bl[4];
                ldmatrix_x4(r, B + ((nt + top) * 8 + r8) * ldb + k0 + hi * 4);
#pragma unroll
                for (int i = 0; i < 4; ++i) split(__uint_as_float(r[i]), bh[i], bl[i]);
                mma3(d[nt], ah, al, bh[0], bh[1], bl[0], bl[1]);
                mma3(d[nt + 1], ah, al, bh[2], bh[3], bl[2], bl[3]);
            }
        }
        add_rn(acc, d);
    }
}

// One warp, the second products: acc[16 x 8 NT] += P[16 x 8 KT] . B with P the warp's own tile in the accumulator
// layout (p[j] holds P's columns 8 j .. 8 j + 7 as acc does) and B[k][n] = B[k * ldb + n] in shared memory. Within
// each 8 columns the A fragment's column t is P's column 2 t and its column t + 4 is P's column 2 t + 1, so
// a0..a3 = p[j][0], p[j][2], p[j][1], p[j][3]; B's rows follow the same order: b0 = B[8 j + 2 t][n],
// b1 = B[8 j + 2 t + 1][n] with n = 8 nt + g. p is split once; each output tile sums its KT k-steps apart, then
// joins acc with an f32 add.
template <int NT, int KT>
__device__ __forceinline__ void gemm_pk(float (&acc)[NT][4], const float (&p)[KT][4], const float* B, int ldb,
                                        int lane) {
    const int g = lane >> 2, t = lane & 3;
    uint32_t ph[KT][4], pl[KT][4];
#pragma unroll
    for (int j = 0; j < KT; ++j) {
        split(p[j][0], ph[j][0], pl[j][0]);
        split(p[j][2], ph[j][1], pl[j][1]);
        split(p[j][1], ph[j][2], pl[j][2]);
        split(p[j][3], ph[j][3], pl[j][3]);
    }
    const float* b = B + 2 * t * ldb + g;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
        float d[4] = {0.f, 0.f, 0.f, 0.f};  // this output tile's sum over the KT k-steps
#pragma unroll
        for (int j = 0; j < KT; ++j) {
            uint32_t bh0, bl0, bh1, bl1;
            split(b[8 * j * ldb + 8 * nt], bh0, bl0);
            split(b[(8 * j + 1) * ldb + 8 * nt], bh1, bl1);
            mma3(d, ph[j], pl[j], bh0, bh1, bl0, bl1);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[nt][i] = __fadd_rn(acc[nt][i], d[i]);
    }
}

// acc rows (g, g + 8 of the warp's 16) -> dst rows r0, r0 + 8 of a (nrows, D) matrix.
template <int DP>
__device__ __forceinline__ void store_rows(float* dst, long long stride, const float (&acc)[DP / 8][4], int r0,
                                           int nrows, int D, int t, float mul_lo, float mul_hi) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int r = r0 + 8 * i;
        if (r >= nrows) continue;
        const float mul = i ? mul_hi : mul_lo;
#pragma unroll
        for (int dt = 0; dt < DP / 8; ++dt) {
            const int col = dt * 8 + 2 * t;
            if (col < D)
                *reinterpret_cast<float2*>(dst + (long long)r * stride + col) =
                    make_float2(acc[dt][2 * i] * mul, acc[dt][2 * i + 1] * mul);
        }
    }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------
// One tile of the online softmax for a warp's 16 rows: scale, cap and mask the scores, update the running
// maximum m and sum l, rescale the output accumulator o, and leave p in s. MASKED = false is for a tile in
// which every element is attended to.
template <int BC, int DP, bool MASKED>
__device__ __forceinline__ void fwd_softmax(float (&s)[BC / 8][4], float (&o)[DP / 8][4], float (&m)[2], float (&l)[2],
                                            const Mask& mk, int r0, int k0, const int (&sq)[2], const int* segk_s,
                                            float scale, float cap, float inv_cap, int t) {
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
    // p = exp(s - m), SELECTED to 0 where masked: a row with nothing visible so far has m = NEG_INF and
    // exp(s - m) = 1 there.
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < BC / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int i = e >> 1;
            float p = expf(s[nt][e] - m[i]);
            if (MASKED) p = ((keepbits >> (nt * 4 + e)) & 1u) ? p : 0.f;
            sum[i] += p;
            s[nt][e] = p;
        }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + quad_sum(sum[i]);
#pragma unroll
    for (int dt = 0; dt < DP / 8; ++dt) {
        o[dt][0] *= alpha[0]; o[dt][1] *= alpha[0];
        o[dt][2] *= alpha[1]; o[dt][3] *= alpha[1];
    }
}

template <int DP>
constexpr int fwd_smem_bytes() {
    return (int)sizeof(float) * 3 * BR * (DP + PAD) + BR * (int)sizeof(int);
}

template <int DP>
__global__ void __launch_bounds__(THREADS, 2) fa_tf32_fwd_kernel(const Args a) {
    constexpr int BC = BR;  // keys a tile
    constexpr int LD = DP + PAD;
    extern __shared__ __align__(16) unsigned char smem[];
    float* Qs = reinterpret_cast<float*>(smem);  // [BR][LD]
    float* Ks = Qs + BR * LD;                    // [BC][LD]
    float* Vs = Ks + BC * LD;                    // [BC][LD]
    int* segk_s = reinterpret_cast<int*>(Vs + BC * LD);  // [BC]

    const Mask mk = make_mask(a);
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int D = (int)a.D, H = (int)a.H;
    const int q0 = ((int)gridDim.x - 1 - (int)blockIdx.x) * BR;  // the longest causal rows first
    const int h = blockIdx.y, b = blockIdx.z, hk = h / (H / (int)a.Hk);
    const float* qp = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
    const float* kp = static_cast<const float*>(a.k) + b * a.k_sb + hk * a.k_sh;
    const float* vp = static_cast<const float*>(a.v) + b * a.v_sb + hk * a.v_sh;
    const float scale = (float)a.scale, cap = (float)a.softcap;
    const float inv_cap = cap > 0.f ? 1.0f / cap : 0.f;

    const int r0 = q0 + warp * 16 + g;  // this thread's rows: r0 and r0 + 8
    int sq[2] = {0, 0};
    if (mk.has_seg) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
            if (r0 + 8 * i < mk.Sq) sq[i] = a.seg_q[(long long)b * mk.Sq + r0 + 8 * i];
    }
    // Segments cost a test per element only where a tile mixes them: one vote over the block's rows here, one
    // over each k tile's keys (folded into that tile's first barrier).
    const int seg_first = mk.has_seg ? a.seg_q[(long long)b * mk.Sq + min(q0, mk.Sq - 1)] : 0;
    const bool q_one_seg = mk.has_seg ? __syncthreads_and(sq[0] == seg_first && sq[1] == seg_first) != 0 : true;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    float o[DP / 8][4];
#pragma unroll
    for (int dt = 0; dt < DP / 8; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;

    // The visible k tiles are one range: the window band cuts its low end, causality its high end.
    int j_lo = 0, j_hi = (mk.Sk + BC - 1) / BC;
    while (j_lo < j_hi && !tile_visible(mk, q0, BR, j_lo * BC, BC)) ++j_lo;
    while (j_hi > j_lo && !tile_visible(mk, q0, BR, (j_hi - 1) * BC, BC)) --j_hi;

    // Two copy groups are in flight at any time, K then V (as in csrc/flash_attention.cu): every point that may
    // start a copy commits a group (an empty one after the last tile), so "all but the newest group" always names
    // the tile needed next.
    if (j_lo < j_hi) {
        load_tile<BR, DP>(Qs, qp, a.q_ss, q0, mk.Sq, D, tid);
        load_tile<BC, DP>(Ks, kp, a.k_ss, j_lo * BC, mk.Sk, D, tid);
        cp_async_commit();
        load_tile<BC, DP>(Vs, vp, a.v_ss, j_lo * BC, mk.Sk, D, tid);
        cp_async_commit();
    }
    for (int j = j_lo; j < j_hi; ++j) {
        const int k0 = j * BC;
        int my_segk = seg_first;  // the last readers of segk_s passed the barrier before the previous p v
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
        gemm_nk<BC / 8, DP>(s, Qs + warp * 16 * LD, LD, Ks, LD, lane);
        __syncthreads();  // every warp is done with Ks
        if (j + 1 < j_hi) load_tile<BC, DP>(Ks, kp, a.k_ss, k0 + BC, mk.Sk, D, tid);
        cp_async_commit();

        // most tiles of a long causal row are wholly visible: they skip the per-element tests
        const bool full = tile_full(mk, q0, BR, k0, BC) && (!mk.has_seg || (q_one_seg && k_same_seg));
        if (full) fwd_softmax<BC, DP, false>(s, o, m, l, mk, r0, k0, sq, segk_s, scale, cap, inv_cap, t);
        else fwd_softmax<BC, DP, true>(s, o, m, l, mk, r0, k0, sq, segk_s, scale, cap, inv_cap, t);
        cp_async_wait<1>();  // V has landed (the K copy just issued may still fly)
        __syncthreads();
        gemm_pk<DP / 8, BC / 8>(o, s, Vs, LD, lane);
        __syncthreads();  // every warp is done with Vs
        if (j + 1 < j_hi) load_tile<BC, DP>(Vs, vp, a.v_ss, k0 + BC, mk.Sk, D, tid);
        cp_async_commit();
    }
    cp_async_wait<0>();

    float* op = static_cast<float*>(a.out) + b * a.o_sb + h * a.o_sh;
    store_rows<DP>(op, a.o_ss, o, r0, mk.Sq, D, t, 1.0f / fmaxf(l[0], 1e-30f), 1.0f / fmaxf(l[1], 1e-30f));
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
// Either way s = X U^T, dp = Y W^T, acc1 += ds U (dq, or dk) and, for dkdv, acc2 += p W (dv).
// ---------------------------------------------------------------------------
// One tile of the backward for a warp's 16 rows, in registers: from the scores s and dp = do v^T,
// p = exp(s - lse) (left in dp) and ds = p (dp - dsum) [1 - (s / cap)^2] scale (left in s). MASKED = false is for
// a tile in which every element is attended to.
template <int BC, bool DKV, bool MASKED>
__device__ __forceinline__ void bwd_probs(float (&s)[BC / 8][4], float (&dp)[BC / 8][4], const Mask& mk, int r0,
                                          int c0, const int (&row_seg)[2], const int* col_seg,
                                          const float (&row_lse)[2], const float (&row_dsum)[2], const float* col_lse,
                                          const float* col_dsum, float scale, float cap, float inv_cap, int t) {
#pragma unroll
    for (int nt = 0; nt < BC / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int i = e >> 1, col = nt * 8 + 2 * t + (e & 1);
            float val = s[nt][e] * scale;
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
            float ds = p * (dp[nt][e] - dsum_v);
            if (cap > 0.f) {
                const float th = val * inv_cap;  // d tanh: 1 - (capped s / cap)^2
                ds = ds * (1.f - th * th);
            }
            s[nt][e] = (!MASKED || p != 0.f) ? ds * scale : 0.f;
            dp[nt][e] = p;
        }
}

template <int DP, int BC>
constexpr int bwd_smem_bytes() {
    return (int)sizeof(float) * (2 * BR + 2 * BC) * (DP + PAD) + BC * (2 * (int)sizeof(float) + (int)sizeof(int));
}

// dk/dv (DKV): the KV_SPLIT blocks of a key tile form a cluster and take its visible (head, query tile) pairs in
// turns; at the end each passes its two accumulators to the cluster's first block through distributed shared
// memory, which adds them in rank order and writes dk and dv (no atomics: the same bits every run).
template <int DP, int BC, bool DKV>
__global__ void __launch_bounds__(THREADS, 2) fa_tf32_bwd_kernel(const Args a) {
    constexpr int LD = DP + PAD;
    extern __shared__ __align__(16) unsigned char smem[];
    float* Xs = reinterpret_cast<float*>(smem);  // [BR][LD]
    float* Ys = Xs + BR * LD;                    // [BR][LD]
    float* Us = Ys + BR * LD;                    // [BC][LD]
    float* Ws = Us + BC * LD;                    // [BC][LD]
    float* col_lse = Ws + BC * LD;               // [BC] (dkdv: per query column)
    float* col_dsum = col_lse + BC;              // [BC]
    int* col_seg = reinterpret_cast<int*>(col_dsum + BC);  // [BC]

    const Mask mk = make_mask(a);
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int D = (int)a.D, H = (int)a.H, group = H / (int)a.Hk;
    const int b = blockIdx.z;
    const int row0 = (DKV ? (int)blockIdx.x / KV_SPLIT : (int)gridDim.x - 1 - (int)blockIdx.x) * BR;
    const int rank = DKV ? (int)blockIdx.x % KV_SPLIT : 0;  // the block's rank in its cluster
    const int hk = DKV ? (int)blockIdx.y : (int)blockIdx.y / group;
    const int h_first = DKV ? hk * group : (int)blockIdx.y, h_last = DKV ? h_first + group : h_first + 1;
    const int n_rows = DKV ? mk.Sk : mk.Sq, n_cols = DKV ? mk.Sq : mk.Sk;
    const float scale = (float)a.scale, cap = (float)a.softcap;
    const float inv_cap = cap > 0.f ? 1.0f / cap : 0.f;

    const float* kp = static_cast<const float*>(a.k) + b * a.k_sb + hk * a.k_sh;
    const float* vp = static_cast<const float*>(a.v) + b * a.v_sb + hk * a.v_sh;
    if (DKV) {
        load_tile<BR, DP>(Xs, kp, a.k_ss, row0, n_rows, D, tid);
        load_tile<BR, DP>(Ys, vp, a.v_ss, row0, n_rows, D, tid);
    } else {
        const int h = h_first;
        load_tile<BR, DP>(Xs, static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh, a.q_ss, row0, n_rows, D, tid);
        load_tile<BR, DP>(Ys, static_cast<const float*>(a.dout) + b * a.do_sb + h * a.do_sh, a.do_ss, row0, n_rows,
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
    float acc1[DP / 8][4], acc2[DKV ? DP / 8 : 1][4];
#pragma unroll
    for (int dt = 0; dt < DP / 8; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            acc1[dt][e] = 0.f;
            if constexpr (DKV) acc2[dt][e] = 0.f;
        }

    int turn = 0;  // visible tiles so far: the cluster's blocks take them in turns
    for (int h = h_first; h < h_last; ++h) {
        const float* up = DKV ? static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh : kp;
        const float* wp = DKV ? static_cast<const float*>(a.dout) + b * a.do_sb + h * a.do_sh : vp;
        const long long u_ss = DKV ? a.q_ss : a.k_ss, w_ss = DKV ? a.do_ss : a.v_ss;
        for (int c0 = 0; c0 < n_cols; c0 += BC) {
            if (!(DKV ? tile_visible(mk, c0, BC, row0, BR) : tile_visible(mk, row0, BR, c0, BC))) continue;
            if (DKV && turn++ % KV_SPLIT != rank) continue;
            __syncthreads();  // every warp is done with the previous tile
            load_tile<BC, DP>(Us, up, u_ss, c0, n_cols, D, tid);
            load_tile<BC, DP>(Ws, wp, w_ss, c0, n_cols, D, tid);
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
            gemm_nk<BC / 8, DP>(s, Xs + warp * 16 * LD, LD, Us, LD, lane);
            gemm_nk<BC / 8, DP>(dp, Ys + warp * 16 * LD, LD, Ws, LD, lane);

            const bool full = (DKV ? tile_full(mk, c0, BC, row0, BR) : tile_full(mk, row0, BR, c0, BC)) &&
                              (!mk.has_seg || (row_one_seg && col_same_seg));
            if (full)
                bwd_probs<BC, DKV, false>(s, dp, mk, r0, c0, row_seg, col_seg, row_lse, row_dsum, col_lse, col_dsum,
                                          scale, cap, inv_cap, t);
            else
                bwd_probs<BC, DKV, true>(s, dp, mk, r0, c0, row_seg, col_seg, row_lse, row_dsum, col_lse, col_dsum,
                                         scale, cap, inv_cap, t);
            gemm_pk<DP / 8, BC / 8>(acc1, s, Us, LD, lane);            // dq += ds k, or dk += ds^T q
            if constexpr (DKV) gemm_pk<DP / 8, BC / 8>(acc2, dp, Ws, LD, lane);  // dv += p^T do
        }
    }

    if constexpr (DKV) {
        // every thread's acc1 and acc2 as DP / 4 float4s, [rank - 1][i][tid], over the tile buffers of rank 0
        constexpr int V4 = DP / 8;
        static_assert((KV_SPLIT - 1) * 2 * V4 * THREADS * 16 <= (2 * BR + 2 * BC) * (DP + PAD) * 4, "partials fit");
        cg::cluster_group cluster = cg::this_cluster();
        float4* part = reinterpret_cast<float4*>(smem);
        cluster.sync();  // every block of the cluster is done with its tiles: rank 0's buffers are free
        if (rank != 0) {
            float4* dst = cluster.map_shared_rank(part, 0) + (rank - 1) * 2 * V4 * THREADS;
#pragma unroll
            for (int i = 0; i < V4; ++i) {
                dst[i * THREADS + tid] = make_float4(acc1[i][0], acc1[i][1], acc1[i][2], acc1[i][3]);
                dst[(V4 + i) * THREADS + tid] = make_float4(acc2[i][0], acc2[i][1], acc2[i][2], acc2[i][3]);
            }
        }
        cluster.sync();
        if (rank != 0) return;
        for (int r = 1; r < KV_SPLIT; ++r) {
            const float4* src = part + (r - 1) * 2 * V4 * THREADS;
#pragma unroll
            for (int i = 0; i < V4; ++i) {
                const float4 u = src[i * THREADS + tid], w = src[(V4 + i) * THREADS + tid];
                acc1[i][0] = __fadd_rn(acc1[i][0], u.x); acc1[i][1] = __fadd_rn(acc1[i][1], u.y);
                acc1[i][2] = __fadd_rn(acc1[i][2], u.z); acc1[i][3] = __fadd_rn(acc1[i][3], u.w);
                acc2[i][0] = __fadd_rn(acc2[i][0], w.x); acc2[i][1] = __fadd_rn(acc2[i][1], w.y);
                acc2[i][2] = __fadd_rn(acc2[i][2], w.z); acc2[i][3] = __fadd_rn(acc2[i][3], w.w);
            }
        }
        store_rows<DP>(static_cast<float*>(a.dk) + b * a.dk_sb + hk * a.dk_sh, a.dk_ss, acc1, r0, n_rows, D, t, 1.f,
                       1.f);
        store_rows<DP>(static_cast<float*>(a.dv) + b * a.dv_sb + hk * a.dv_sh, a.dv_ss, acc2, r0, n_rows, D, t, 1.f,
                       1.f);
    } else {
        store_rows<DP>(static_cast<float*>(a.dq) + b * a.dq_sb + h_first * a.dq_sh, a.dq_ss, acc1, r0, n_rows, D, t,
                       1.f, 1.f);
    }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------
// cluster: blocks a cluster along x (1: none)
template <typename K>
cudaError_t launch(K kernel, int smem_bytes, dim3 grid, const Args& a, cudaStream_t stream, int cluster = 1) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem_bytes;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, a);
    return err != cudaSuccess ? err : cudaGetLastError();
}

template <int DP>
cudaError_t launch_one(int which, const Args& a, cudaStream_t stream) {
    const unsigned B = (unsigned)a.B, H = (unsigned)a.H, Hk = (unsigned)a.Hk;
    const unsigned nq = (unsigned)((a.Sq + BR - 1) / BR), nk = (unsigned)((a.Sk + BR - 1) / BR);
    // at D 128 the backward's column tiles are 32 wide: 101 KB a block, two blocks an SM, and dk/dv's two
    // accumulators stay in registers
    constexpr int BC = DP > 64 ? 32 : 64;
    if (which == 0) return launch(fa_tf32_fwd_kernel<DP>, fwd_smem_bytes<DP>(), dim3(nq, H, B), a, stream);
    if (which == 1)
        return launch(fa_tf32_bwd_kernel<DP, BC, false>, bwd_smem_bytes<DP, BC>(), dim3(nq, H, B), a, stream);
    return launch(fa_tf32_bwd_kernel<DP, BC, true>, bwd_smem_bytes<DP, BC>(), dim3(nk * KV_SPLIT, Hk, B), a, stream,
                  KV_SPLIT);
}

int dispatch(int which, const Args* args, void* stream) {
    const Args& a = *args;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (a.is_bf16 || (a.D != 64 && a.D != 128) || a.B < 1 || a.H < 1 || a.Hk < 1 || a.H % a.Hk || a.Sq < 1 ||
        a.Sk < 1)
        return (int)cudaErrorInvalidValue;
    return (int)(a.D == 64 ? launch_one<64>(which, a, st) : launch_one<128>(which, a, st));
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch (0 = launched); float32 inputs at head dim 64 or 128 only.
int dalm_fa_fwd_tf32(const void* args, void* stream) { return dispatch(0, static_cast<const Args*>(args), stream); }
int dalm_fa_bwd_dq_tf32(const void* args, void* stream) { return dispatch(1, static_cast<const Args*>(args), stream); }
int dalm_fa_bwd_dkv_tf32(const void* args, void* stream) { return dispatch(2, static_cast<const Args*>(args), stream); }
int dalm_fa_tf32_args_bytes() { return (int)sizeof(Args); }

}  // extern "C"
