// K4's forward rebuilt for Hopper (sm_90a): flash attention on wgmma, fed by a
// warp-specialised TMA ring, with the online softmax in registers. One
// hand-written kernel, the route of bfloat16 inputs at head dim 64, 128 or 256
// (Gemma's); float32 inputs and other head dims keep the mma.sync forward of
// csrc/flash_attention.cu, and kernels/flash_attention.py:fwd_route chooses.
//
// Replaces dalm_tpu/kernels/flash_attention.py:_flash_fwd (pallas_call at :221,
// body _fwd_kernel :130-183), as csrc/flash_attention.cu's fa_fwd_kernel does,
// computing exactly its function (kernels/flash_attention.py:flash_fwd_ref):
// out = softmax(q k^T * scale [softcap] [causal with q_offset, window,
// segments]) v with the probabilities cast to bf16 before the p v product and
// their sum kept in f32; lse in f32; a row with no visible key gives out = 0
// and lse = -1e30; masked entries are selected to 0, never multiplied by 0;
// GQA (query head h reads kv head h / (H / Hk)); any Sq, Sk; q, k, v and out
// read and written through their own strides ((B, H, S, D) views of
// (B, S, H, D) storage are taken as they are).
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s). At the SFT shape
// (B 2, H 32, S 2560, D 128, causal) it needs 2 products of 2 S^2 D / 2 operations
// a head, 107 GFLOP, against 42 MB of q, k, v and out: 0.109 ms of tensor time
// and 0.013 ms of memory time, so operations. The tensor cores reach their
// rate only through wgmma, and wgmma only when its operands arrive without the
// issuing warps spending instructions on them and the softmax between the two
// products is hidden behind the other warpgroup's products.
//
// Design.
//   A block owns a 128-row q tile of one (batch, head): three warpgroups, the
//   first a producer trimmed to 40 registers a thread (setmaxnreg), of which one
//   warp works; the two others consumers with 232, each owning 64 query rows.
//   The longest causal rows go first (q tiles in reverse order).
//   The producer loads the q tile once, then the k and v tiles of 128 keys
//   through a 2-slot ring in shared memory: TMA copies of 64-column boxes
//   (D 128: two boxes a tile) with the 128-byte swizzle, each slot gated by a
//   full and an empty mbarrier. The tensor maps are 4-D, (D, S, H, B) with the
//   tensor's own strides, so a tile that overhangs the sequence is zero-filled
//   within its (b, h) and never reads the next batch's rows. With segment ids
//   the producer warp also stages the tile's key segments in shared memory
//   (read from device memory before the slot is free, stored after its copy is
//   issued) and votes whether they are all one segment.
//   Each consumer, per k tile: S = Q K^T on wgmma.m64n128k16 with both operands
//   K-major in shared memory; then, in the accumulator's registers, scale (with
//   log2 e folded in), softcap, mask, the running row maximum and sum (4-lane
//   shuffles), 2^x on the special-function unit (ex2.approx), the rescale of O
//   (skipped when no row's maximum moved); P is packed to bf16 straight into
//   the A fragment of the next product, O += P V on wgmma.m64n128k16
//   (m64n64k16 at D 64) with A from registers and V read MN-major (keys x D, D
//   contiguous) through the transpose bit, so V needs no transposed copy. Its
//   last product done, the consumer frees the slot. The two consumers do not
//   wait for each other, so one's softmax may overlap the other's products.
//   Masks keep csrc/flash_attention.cuh's tile classes: k tiles wholly above the
//   causal diagonal or outside the window band are never loaded (producer and
//   consumers walk one k-tile range, computed once per block). Each warp then
//   classes the tile for its 16 rows: whole (inside the matrix, below the
//   diagonal, inside the band, and with segments one segment on both sides) skips
//   the per-element test and takes the maximum on the raw scores; dead (every
//   element masked, by geometry or by two different segments) sets P = 0 and
//   skips the softmax; the rest is masked element by element against per-row
//   column bounds and the staged key segments.
//   Epilogue: out = O / max(l, 1e-30), stored in out's own layout;
//   lse = m + log l, or -1e30 where l = 0.
//   Not done here: a persistent tile scheduler, skipping tiles that segments
//   alone mask. Two schedules were tried and measured slower at sft-gemma2's
//   global layer (PERF.md §6): ping-pong (the consumers issuing a tile's P V
//   with the next Q K^T in turns behind named barriers), 1.015 ms against 0.70,
//   and overlap inside a warpgroup (the next Q K^T issued before this P V, the
//   softmax run under it, P double-buffered), 1.07 ms (D 128: 0.43 against 0.29).
//
// Head dim 256 (Gemma, Gemma2, Gemma3). At sft-gemma2's global layer (B 1, H 8,
// Hk 4, S 8192, causal, softcap 50) the visible half of the scores costs 2 S^2 D / 2
// operations a head and product: 275 GFLOP, 0.278 ms of tensor time, against
// 0.03 ms for its 101 MB of q, k, v, out, lse; so operations (window 4096: 0.209 ms).
// The D-128 geometry does not carry over: a consumer's O is 64 x 256 f32, 128
// registers a thread, and a 128-key tile adds 64 for S and 32 for the bf16 P
// fragment, which spills under the consumers' 232. So the same kernel, with:
//   k tiles of 64 keys (key_tile): S = Q K^T on wgmma.m64n64k16, 16 k steps over
//   four 64-column boxes (32 registers), P 16 registers, O += P V on
//   wgmma.m64n256k16 with V MN-major, four k steps of 16 keys, each reading the
//   tile's four 64-column boxes 8 KB apart (the descriptor's leading offset);
//   registers a consumer thread: O 128 + S 32 + P 16 + the row state, under 232
//   (chip_smoke.py prints ptxas's counts and spills);
//   shared memory: the 128-row q tile 64 KB, a 2-slot ring of 64-key k and v
//   tiles 2 x 64 KB: 193 KB with the alignment slack (Layout<256>, checked against
//   the 227 KB a block may have by a static_assert); TMA boxes stay 64 columns (128
//   bytes, the swizzle), four to a 256-wide row.
//   A k tile's products are 4 x fewer per score than at D 64, so the softmax
//   costs less beside them; Q K^T at n = 64 reads 4 KB of shared memory a k step,
//   which is what the SM's shared memory gives in that step's time at the full
//   tensor rate, for one consumer. Measured (PERF.md §6): 0.70 ms at
//   sft-gemma2's global layer, 0.555 ms without its softcap.

#include <cuda_bf16.h>
#include <stdint.h>

#include "flash_attention.cuh"
#include "flash_wgmma.cuh"
#include "hopper.cuh"

namespace {

constexpr int BM = 128;                   // query rows a block: two consumer warpgroups of 64
constexpr int SLOTS = 2;                  // ring slots, each one k tile and one v tile
constexpr int THREADS = 384;              // warpgroup 0 produces, 1 and 2 consume
constexpr int Q_BOX = BM * 128;           // one TMA box of q: 128 rows x 64 bf16 (128 bytes, one swizzle row)
constexpr float LN2 = 0.6931471805599453f;

// Keys a tile: 128 at head dim 64 / 128; 64 at 256, where a consumer's O alone holds 128 registers a thread.
template <int D>
constexpr int key_tile() { return D == 256 ? 64 : 128; }

// Dynamic shared memory of the head dim D: the q tile, then the k and v tiles of the ring.
template <int D>
struct Layout {
    static constexpr int BN = key_tile<D>();
    static constexpr int BOXES = D / 64;             // 64-column boxes a row
    static constexpr int KV_BOX = BN * 128;          // one TMA box of k or v: BN rows x 64 bf16
    static constexpr int QT = BOXES * Q_BOX;         // the q tile
    static constexpr int KVT = BOXES * KV_BOX;       // a k or a v tile
    static constexpr int Q = 0, K = QT, V = K + SLOTS * KVT;
    static constexpr int BYTES = V + SLOTS * KVT + 1024;  // + slack to align the tiles to 1024 bytes
    // D 64: 81 KB, D 128: 161 KB, D 256: 193 KB, with 512 (D 256) or 1,024 bytes of static key segments beside
    static_assert(BYTES + SLOTS * BN * 4 + 64 <= 232448, "more shared memory than a block may have");
    static_assert(BYTES + 4096 < (1 << 18), "a descriptor's address field holds addresses below 2^18");
};

// One k tile of the online softmax for a thread's two rows r0 and r0 + 8, in the wgmma accumulator
// layout: register 4 i + e of s holds column 8 i + 2 tq + (e & 1), row r0 (e < 2) or r0 + 8. Scores become
// x = s scale log2(e) (or cap tanh(s scale / cap) log2(e)), masked ones NEG_INF; m is the running maximum
// of x, l this thread's share of the running sum of 2^(x - m) (its quad sums it at the end). P, cast to
// bf16, leaves in the A fragment of the p v product: register 4 kk + f of p holds keys 16 kk + 2 tq
// (+ 8 for f >= 2), row r0 (f even) or r0 + 8.
// MASKED: row r sees columns [lo[r], hi[r]] of the tile (ragged edges, causality, window) and, with
// segments, the keys of its own segment sq[r]; otherwise every element is attended to, and without a
// softcap (CAP false) the maximum is taken on the raw scores and the scale folded into the exponent
// (the caller takes this path only for scale > 0).
template <int D, int BN, bool MASKED, bool CAP>
__device__ __forceinline__ void softmax_tile(float (&s)[BN / 2], uint32_t (&p)[BN / 4], float (&o)[D / 2], float (&m)[2],
                                             float (&l)[2], const int (&lo)[2], const int (&hi)[2],
                                             const int (&sq)[2], const int* segk, bool has_seg, float scale2,
                                             float cap_in, float cap_out, int tq) {
    constexpr bool RAW = !MASKED && !CAP;
    uint32_t keep[2] = {0xffffffffu, 0xffffffffu};  // bit 2 i + (e & 1) of row e >> 1
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
        int2 seg = make_int2(0, 0);  // the segments of this thread's two columns of group i
        if (MASKED && has_seg) seg = *reinterpret_cast<const int2*>(segk + 8 * i + 2 * tq);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int r = e >> 1, col = 8 * i + 2 * tq + (e & 1);
            float x = s[4 * i + e];
            if (!RAW) x = CAP ? tanh_fast(x * cap_in) * cap_out : x * scale2;
            if (MASKED && !(col >= lo[r] && col <= hi[r] && (!has_seg || ((e & 1) ? seg.y : seg.x) == sq[r]))) {
                x = NEG_INF;
                keep[r] &= ~(1u << (2 * i + (e & 1)));
            }
            s[4 * i + e] = x;
            mx[r] = fmaxf(mx[r], x);
        }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const float tile_max = quad_max(mx[r]);
        const float m_new = fmaxf(m[r], RAW ? tile_max * scale2 : tile_max);
        alpha[r] = exp2_fast(m[r] - m_new);  // a row that saw nothing so far: 2^(NEG_INF - m_new) = 0, or 2^0
        m[r] = m_new;
    }
    // p = 2^(x - m), SELECTED to 0 where masked: a row with nothing visible yet has m = NEG_INF and 2^0 = 1 there.
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < BN / 8; ++i)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const float x0 = s[4 * i + 2 * r], x1 = s[4 * i + 2 * r + 1];
            float p0 = exp2_fast(RAW ? fmaf(x0, scale2, -m[r]) : x0 - m[r]);
            float p1 = exp2_fast(RAW ? fmaf(x1, scale2, -m[r]) : x1 - m[r]);
            if (MASKED) {
                p0 = ((keep[r] >> (2 * i)) & 1u) ? p0 : 0.f;
                p1 = ((keep[r] >> (2 * i + 1)) & 1u) ? p1 : 0.f;
            }
            sum[r] += p0 + p1;
            // 8-column group i is half (i & 1) of the 16 keys of k step i / 2
            p[4 * (i >> 1) + 2 * (i & 1) + r] = pack_bf16(p0, p1);
        }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
    if (__all_sync(0xffffffffu, alpha[0] == 1.f && alpha[1] == 1.f)) return;  // no row's maximum moved
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
        o[4 * i] *= alpha[0]; o[4 * i + 1] *= alpha[0];
        o[4 * i + 2] *= alpha[1]; o[4 * i + 3] *= alpha[1];
    }
}

// tm_q: (D, Sq, H, B), tm_k / tm_v: (D, Sk, Hk, B), boxes of 64 x 128 x 1 x 1 (q) and 64 x BN x 1 x 1 (k, v).
// Grid (q tiles, H, B).
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
fa_fwd_wgmma_kernel(__grid_constant__ const CUtensorMap tm_q, __grid_constant__ const CUtensorMap tm_k,
                    __grid_constant__ const CUtensorMap tm_v, const Args a) {
    using L = Layout<D>;
    constexpr int BN = L::BN;
    extern __shared__ uint8_t smem_raw[];
    __shared__ __align__(8) uint64_t q_full;
    __shared__ __align__(8) uint64_t full[SLOTS];
    __shared__ __align__(8) uint64_t empty[SLOTS];
    __shared__ __align__(16) int segk_s[SLOTS][BN];  // the k tile's segment ids
    __shared__ int segk_one[SLOTS][2];   // {every key of the tile in one segment, that segment}
    uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);

    const Mask mk = make_mask(a);
    const int H = (int)a.H;
    const int q0 = ((int)gridDim.x - 1 - (int)blockIdx.x) * BM;  // the longest causal rows first
    const int h = blockIdx.y, b = blockIdx.z, hk = h / (H / (int)a.Hk);
    // The visible k tiles are one range: the window band cuts its low end, causality its high end.
    int j_lo = 0, j_hi = (mk.Sk + BN - 1) / BN;
    while (j_lo < j_hi && !tile_visible(mk, q0, BM, j_lo * BN, BN)) ++j_lo;
    while (j_hi > j_lo && !tile_visible(mk, q0, BM, (j_hi - 1) * BN, BN)) --j_hi;

    const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
    if (threadIdx.x == 0) {
        mbar_init(&q_full, 1);
        for (int s = 0; s < SLOTS; ++s) {
            mbar_init(&full[s], 32);  // the producer warp's lanes, after their segment stores; and the copy's bytes
            mbar_init(&empty[s], 2);  // the two consumers
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (wg == 0) {
        // producer: one warp keeps the ring filled
        asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
        if (t < 32) {
            const int lane = t;
            if (lane == 0) {
                tma_prefetch_map(&tm_q);
                tma_prefetch_map(&tm_k);
                tma_prefetch_map(&tm_v);
            }
            if (j_lo < j_hi && lane == 0) {
                mbar_expect_tx(&q_full, L::QT);
                for (int x = 0; x < L::BOXES; ++x)
                    tma_load_4d(base + L::Q + x * Q_BOX, &tm_q, &q_full, 64 * x, q0, h, b);
            }
            const int* sk = a.seg_k + (long long)b * mk.Sk;
            for (int j = j_lo; j < j_hi; ++j) {
                const int it = j - j_lo, s = it % SLOTS, k0 = j * BN;
                // the tile's key segments are read before the slot is free, stored after
                int seg[BN / 32], first = 0;
                if (mk.has_seg) {
                    first = sk[k0];
#pragma unroll
                    for (int i = 0; i < BN / 32; ++i) {
                        const int kj = k0 + lane + 32 * i;
                        seg[i] = kj < mk.Sk ? sk[kj] : first;  // keys past the end are masked anyway
                    }
                }
                if (it >= SLOTS) mbar_wait(&empty[s], (it / SLOTS - 1) & 1);
                if (lane == 0) {
                    mbar_expect_tx_only(&full[s], 2 * L::KVT);
                    uint8_t* kd = base + L::K + s * L::KVT;
                    uint8_t* vd = base + L::V + s * L::KVT;
                    for (int x = 0; x < L::BOXES; ++x) {
                        tma_load_4d(kd + x * L::KV_BOX, &tm_k, &full[s], 64 * x, k0, hk, b);
                        tma_load_4d(vd + x * L::KV_BOX, &tm_v, &full[s], 64 * x, k0, hk, b);
                    }
                }
                if (mk.has_seg) {
                    bool same = true;
#pragma unroll
                    for (int i = 0; i < BN / 32; ++i) {
                        segk_s[s][lane + 32 * i] = seg[i];
                        same = same && seg[i] == first;
                    }
                    same = __all_sync(0xffffffffu, same);
                    if (lane == 0) {
                        segk_one[s][0] = same;
                        segk_one[s][1] = first;
                    }
                }
                mbar_arrive(&full[s]);  // every lane, after its segment stores
            }
        }
    } else {
        // consumer warpgroup c: query rows [q0 + 64 c, +64); warp w of it rows [+16 w, +16)
        asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
        const int c = wg - 1, warp = t / 32, lane = t % 32, tq = lane % 4;
        const int wq0 = q0 + 64 * c + 16 * warp;
        const int r0 = wq0 + lane / 4;  // this thread's rows: r0 and r0 + 8
        int sq[2] = {0, 0};
        if (mk.has_seg) {
#pragma unroll
            for (int r = 0; r < 2; ++r)
                if (r0 + 8 * r < mk.Sq) sq[r] = a.seg_q[(long long)b * mk.Sq + r0 + 8 * r];
        }
        const int seg_w = __shfl_sync(0xffffffffu, sq[0], 0);
        const bool q_one_seg = __all_sync(0xffffffffu, sq[0] == seg_w && sq[1] == seg_w);
        const float scale = (float)a.scale, cap = (float)a.softcap;
        const float scale2 = scale * LOG2E;
        const float cap_in = cap > 0.f ? scale / cap : 0.f, cap_out = cap > 0.f ? cap * LOG2E : 0.f;

        float o[D / 2];
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
        float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
        float s[BN / 2];
        uint32_t p[BN / 4];
        if (j_lo < j_hi) mbar_wait(&q_full, 0);
        const uint8_t* qs = base + L::Q + c * 64 * 128;  // this consumer's 64 rows of each box
        for (int j = j_lo; j < j_hi; ++j) {
            const int it = j - j_lo, slot = it % SLOTS, k0 = j * BN;
            mbar_wait(&full[slot], (it / SLOTS) & 1);
            const uint8_t* ks = base + L::K + slot * L::KVT;
            const uint8_t* vs = base + L::V + slot * L::KVT;
            // S = Q K^T: D / 16 k steps of 32 bytes, four to a box
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk) {
                const int aq = (kk / 4) * Q_BOX + (kk % 4) * 32, ak = (kk / 4) * L::KV_BOX + (kk % 4) * 32;
                if constexpr (BN == 128) wgmma_ss_n128(s, smem_desc(qs + aq), smem_desc(ks + ak), kk > 0);
                else wgmma_ss_n64(s, smem_desc(qs + aq), smem_desc(ks + ak), kk > 0);
            }
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(s);
            // The warp's class for this tile: dead (every element masked: P = 0, nothing else changes), whole
            // (nothing masked) or masked element by element. Row r sees columns [lo[r], hi[r]] by geometry.
            int lo[2], hi[2];
            bool none = true;
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                const int row = r0 + 8 * r, gq = mk.q_offset + row;
                hi[r] = row < mk.Sq ? mk.Sk - 1 - k0 : -1;
                if (mk.causal) hi[r] = min(hi[r], gq - k0);
                lo[r] = mk.window > 0 ? gq - k0 - mk.window + 1 : 0;
                none = none && (hi[r] < 0 || hi[r] < lo[r] || lo[r] > BN - 1);
            }
            const bool k_one_seg = segk_one[slot][0] != 0;
            const bool dead = __all_sync(0xffffffffu, none) ||
                              (mk.has_seg && q_one_seg && k_one_seg && segk_one[slot][1] != seg_w);
            const bool whole = tile_full(mk, wq0, 16, k0, BN) &&
                               (!mk.has_seg || (q_one_seg && k_one_seg && segk_one[slot][1] == seg_w));
            const int* segk = segk_s[slot];
            if (dead) {
#pragma unroll
                for (int i = 0; i < BN / 4; ++i) p[i] = 0u;
            } else if (cap > 0.f) {
                if (whole)
                    softmax_tile<D, BN, false, true>(s, p, o, m, l, lo, hi, sq, segk, mk.has_seg, scale2, cap_in, cap_out, tq);
                else
                    softmax_tile<D, BN, true, true>(s, p, o, m, l, lo, hi, sq, segk, mk.has_seg, scale2, cap_in, cap_out, tq);
            } else if (whole && scale2 > 0.f) {
                softmax_tile<D, BN, false, false>(s, p, o, m, l, lo, hi, sq, segk, mk.has_seg, scale2, cap_in, cap_out, tq);
            } else {
                softmax_tile<D, BN, true, false>(s, p, o, m, l, lo, hi, sq, segk, mk.has_seg, scale2, cap_in, cap_out, tq);
            }
            // O += P V: BN / 16 k steps of 16 keys = 2048 bytes of each box; the next 64 columns one box on
            fence_regs(o);
            fence_regs(p);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < BN / 16; ++kk) {
                const uint32_t frag[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
                wgmma_rs_d<D>(o, frag, smem_desc_mn(vs + kk * 2048, L::KV_BOX));
            }
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(o);
            if (t == 0) mbar_arrive(&empty[slot]);
        }

        // epilogue: the quad's sums, out = O / l in out's layout, lse = m + log l
#pragma unroll
        for (int r = 0; r < 2; ++r) l[r] = quad_sum(l[r]);
        __nv_bfloat16* op = static_cast<__nv_bfloat16*>(a.out) + b * a.o_sb + h * a.o_sh;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int row = r0 + 8 * r;
            if (row >= mk.Sq) continue;
            const float inv = 1.0f / fmaxf(l[r], 1e-30f);
#pragma unroll
            for (int i = 0; i < D / 8; ++i)
                *reinterpret_cast<__nv_bfloat162*>(op + row * a.o_ss + 8 * i + 2 * tq) =
                    __floats2bfloat162_rn(o[4 * i + 2 * r] * inv, o[4 * i + 2 * r + 1] * inv);
            if (tq == 0)
                a.lse[((long long)b * H + h) * mk.Sq + row] = l[r] > 0.f ? m[r] * LN2 + logf(l[r]) : NEG_INF;
        }
    }
}

template <int D>
int launch(const Args& a, cudaStream_t stream) {
    CUtensorMap tq, tk, tv;
    const int q_box[4] = {64, BM, 1, 1}, kv_box[4] = {64, Layout<D>::BN, 1, 1};
    const long long q_dims[4] = {a.D, a.Sq, a.H, a.B}, kv_dims[4] = {a.D, a.Sk, a.Hk, a.B};
    const long long q_st[3] = {2 * a.q_ss, 2 * a.q_sh, 2 * a.q_sb}, k_st[3] = {2 * a.k_ss, 2 * a.k_sh, 2 * a.k_sb},
                    v_st[3] = {2 * a.v_ss, 2 * a.v_sh, 2 * a.v_sb};
    int err = make_map_nd(&tq, a.q, 2, 4, q_dims, q_st, q_box);
    if (!err) err = make_map_nd(&tk, a.k, 2, 4, kv_dims, k_st, kv_box);
    if (!err) err = make_map_nd(&tv, a.v, 2, 4, kv_dims, v_st, kv_box);
    if (err) return err;
    const cudaError_t e =
        cudaFuncSetAttribute(fa_fwd_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<D>::BYTES);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((unsigned)((a.Sq + BM - 1) / BM), (unsigned)a.H, (unsigned)a.B);
    fa_fwd_wgmma_kernel<D><<<grid, THREADS, Layout<D>::BYTES, stream>>>(tq, tk, tv, a);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// bf16 q, k, v, out at head dim 64, 128 or 256, every row 16-byte aligned. Returns 0, a CUDA error, or
// 900 / 1000 + CUresult when a tensor map cannot be encoded.
int dalm_fa_fwd_wgmma(const void* args, void* stream) {
    const Args& a = *static_cast<const Args*>(args);
    if (!a.is_bf16 || (a.D != 64 && a.D != 128 && a.D != 256) || a.B < 1 || a.H < 1 || a.Hk < 1 || a.H % a.Hk || a.Sq < 1 ||
        a.Sk < 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return a.D == 256 ? launch<256>(a, st) : a.D == 128 ? launch<128>(a, st) : launch<64>(a, st);
}
int dalm_fa_wgmma_args_bytes() { return (int)sizeof(Args); }

}  // extern "C"
