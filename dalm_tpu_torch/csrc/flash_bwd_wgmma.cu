// K4's backward rebuilt for Hopper (sm_90a): the dq and dk/dv kernels on wgmma,
// each fed by a warp-specialised TMA ring, and the dsum pre-pass. The route of
// bfloat16 inputs at head dim 64, 128 or 256 (kernels/flash_attention.py:fwd_route,
// the same rule as the forward's); float32 inputs and other head dims keep the
// mma.sync pair of csrc/flash_attention.cu. The dsum pre-pass serves both routes.
//
// Replaces dalm_tpu/kernels/flash_attention.py:_flash_bwd:
//   the pallas_call at :443 (body _bwd_dq_kernel :255-305)   -> fa_bwd_wgmma_kernel<D, false> (dalm_fa_bwd_dq_wgmma)
//   the pallas_call at :461 (body _bwd_dkv_kernel :306-365)  -> fa_bwd_wgmma_kernel<D, true>  (dalm_fa_bwd_dkv_wgmma)
//   the XLA einsum at :390, dsum = rowsum(do * out) in f32    -> dsum_kernel<T>                (dalm_fa_dsum)
// computing exactly the function of kernels/flash_attention.py:flash_bwd_ref:
// p = exp(s - lse) from the capped, scaled scores, SELECTED to 0 where masked
// (never multiplied by 0: a fully masked row has lse = -1e30 and exp overflows);
// ds = p (do v^T - dsum) [1 - (s / cap)^2] scale; dq = ds k, dk = ds^T q,
// dv = p^T do; p and ds cast to bf16 before their products, sums in f32; the
// masks (causal with q_offset, window, segments); GQA with dk / dv summed over
// the group's query heads inside one block (no atomics: the same result from
// run to run); any Sq, Sk; out, lse and do may cover more keys than k (a ring
// chunk); q, k, v, do, out, dq, dk, dv read and written through their own
// strides ((B, H, S, D) views of (B, S, H, D) storage are taken as they are).
//
// What bounds them on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s). At the SFT
// shape (B 2, H 32, S 2560, D 128, causal) the visible half of the scores costs
// 2 S^2 D / 2 operations a head and product: dq needs 3 products (s, dp, dq),
// 161 GFLOP, 0.163 ms; dk/dv 4 (s, dp, dv, dk), 215 GFLOP, 0.217 ms; their
// bytes (q, k, v, do, lse, dsum read once, the gradients written once) take
// about 0.02 ms. So operations, reachable only through wgmma with operands that
// arrive without the issuing warps spending instructions on them. dsum is bytes:
// 84 MB of do and out, 0.025 ms.
//
// Design. The two gradients are one template: a block owns BM = 128 "rows"
// and walks 64-wide tiles of "columns" (dq: rows are queries, columns keys;
// dk/dv: rows are keys, columns the queries of every head of the GQA group).
// X and Y are the block's own row tiles, U and W the column tiles of the ring:
//   dq     X = q, Y = do of query head h;   U = k, W = v of kv head h / G;
//   dk/dv  X = k, Y = v of kv head hk;      U = q, W = do of each query head of the group.
// Per column tile, per consumer (64 rows), on wgmma with f32 accumulators:
//   A1 = X U^T (SS, m64n64k16: both operands K-major as TMA wrote them)      dq: S     dk/dv: S^T
//   A2 = Y W^T (SS)                                                           dq: dP    dk/dv: dP^T
//   then P and dS in registers, packed to bf16 straight into A fragments;
//   dq:    acc1 += dS U          (RS, m64nDk16, U read MN-major through the transpose bit)   = dQ
//   dk/dv: acc2 += P^T W; acc1 += dS^T U   (RS, W and U MN-major)                            = dV, dK
// so no operand is ever copied transposed and nothing makes a shared-memory trip.
// The element-wise work and the RS products go in two halves of 32 columns:
// half 0's products are issued before half 1 is made, so they run under it.
// A block is three warpgroups: a producer trimmed to 24 registers (setmaxnreg)
// of which one warp works, and two consumers at 240 that own 64 rows each. The
// producer loads X and Y once, then the U and W tiles of each visible column tile
// into a 3-slot ring (TMA boxes of 64 values x 64 rows, 128-byte swizzle, 4-D
// (D, S, heads, B) tensor maps over the tensors' own strides, so an overhanging
// tile is zero-filled inside its (b, head)), each slot behind a full and an empty
// mbarrier. Beside each slot it stages the tile's column data in shared memory:
// the column segments and whether they are one segment, and for dk/dv the
// queries' lse (times log2 e) and dsum; those are read before the slot is free
// and stored after its copy is issued. dq keeps each row's lse and dsum in
// registers. A consumer frees the slot (one arrival a warp) after the tile's
// last product has completed.
// Masks keep csrc/flash_attention.cuh's tile classes. Column tiles wholly above
// the causal diagonal or outside the window band are never loaded: producer and
// consumers walk one range, computed once per block. A consumer whose own 64 rows
// see nothing of a loaded tile skips its products. Each warp classes the tile
// for its 16 rows: whole (nothing masked: no per-element test), dead (every
// element masked, by geometry or by two different segments: P = dS = 0) or
// masked element by element against per-row column bounds and the staged
// column segments. Fully masked rows give exact zeros.
// Registers: dk/dv at D 128 holds dK and dV (64 + 64 f32 a thread), S^T and
// dP^T (32 + 32) and the bf16 P^T / dS^T fragments (16 + 16); dq holds dQ (64),
// S, dP (32 + 32) and the dS fragment (16). Hence 64 columns a tile in both
// kernels, and the halves: with the whole tile's fragments made before its first
// product, ptxas spilled 248 bytes of dk/dv at D 128 (consumers at 240
// registers); the halves end half 0's scores before half 1's fragments exist.
// chip_smoke.py prints ptxas's counts from the build log.
// Epilogue: dQ, dK, dV converted to bf16 and stored in each output's own layout
// (the scale already sits in dS); rows past the end are not stored.
// dsum pre-pass: 16 threads a row of do and out, 16 bytes each a step, an f32
// sum reduced by shuffles; any D up to 256, bf16 or f32, both tensors' strides.
// Not done here: ping-pong of the consumers, a persistent scheduler, one fused
// kernel with dq by atomics (which gives up run-to-run equality), FP8, skipping
// tiles that segments alone mask.
//
// Head dim 256 (Gemma, Gemma2, Gemma3): the geometry of Geo<256, *> (SPLIT). At
// sft-gemma2's global layer (B 1, H 8, Hk 4, S 8192, causal, softcap 50) dq needs
// 412 GFLOP (0.417 ms of tensor time) and dk/dv 550 (0.556 ms) against about
// 0.04 ms of bytes: operations. The D-128 blocks do not fit: a consumer's 64 rows
// hold dQ in 128 registers a thread and dK + dV in 256, and 128-row X and Y
// tiles take 128 KB of the 227. So in both kernels a block owns 64 rows (dq:
// queries, the longest causal rows first; dk/dv: keys), and its two consumers
// walk them over the same 64-column tiles with the work split by product, not
// by rows: consumer 0 makes the scores (dq: S = Q K^T; dk/dv: S^T = K Q^T) on
// wgmma.m64n64k16 (16 k steps), turns them into g = P [1 - (S / cap)^2] scale
// (f32, 0 where masked) and, for dk/dv, the bf16 P^T fragment, writes g to a
// double-buffered exchange in shared memory and, for dk/dv, accumulates
// dV += P^T dO (wgmma.m64n256k16, 4 k steps: dV's 64 x 256 f32 in 128 registers
// a thread); consumer 1 makes dP (dO V^T; dk/dv: dP^T = V dO^T) on
// wgmma.m64n64k16, waits for the tile's g, makes dS = g (dP - dsum) in bf16 and
// accumulates dQ += dS K (dk/dv: dK += dS^T Q) on wgmma.m64n256k16. So each
// product is issued once a tile pair, where the mma.sync instance recomputes both
// score products in each of its two column blocks. The exchange runs one way:
// consumer 0 writes buffer it % 2 and arrives on a named barrier, consumer 1
// waits on it, reads, and arrives on the buffer's empty barrier, which consumer 0
// waits on two tiles later; so consumer 0 runs up to a tile ahead, and its
// exponentials (and tanh) overlap consumer 1's products. Thread t's 32 entries lie
// 128 words apart (both consumers' threads hold the same elements of the m64n64
// layout): no bank conflicts.
// Registers a consumer thread: 128 of output + the score or dP tile 32 + a bf16
// fragment 16 + the row state, under 240 (chip_smoke.py prints ptxas's counts and
// spills). Shared memory: X, Y (64 rows) 32 KB each, a 2-slot ring of 64-column
// U, W tiles (2 x 64 KB), the exchange 2 x 16 KB: 225 KB with the slack, 226.6 KB
// with the static column data, of the 227 (Geo's static_assert checks it).
// dq's consumer 0 issues one product a tile and consumer 1 two, so dq's tensor
// work is not split evenly; dk/dv's is (two products each). Measured (PERF.md
// §6, an H100 80GB HBM3 at 700 W): dq 0.97 ms, dk/dv 1.08 ms at sft-gemma2's
// global layer; 0.815 / 0.934 without its softcap, whose tanh adds two
// special-function operations a score.

#include <cuda_bf16.h>
#include <stdint.h>

#include "flash_attention.cuh"
#include "flash_wgmma.cuh"
#include "hopper.cuh"

namespace {

constexpr int THREADS = 384;          // warpgroup 0 produces, 1 and 2 consume

// The geometry of one instance. D 64 / 128: a block owns 128 rows, 64 to a consumer, and walks column tiles of 64
// through a 3-slot ring. D 256 (SPLIT): a block owns 64 rows, which both consumers walk, one making the scores and
// P, the other dP and dS; 64-column tiles through a 2-slot ring, and a double-buffered shared-memory exchange of
// 2 x 16 KB (32 f32 a consumer thread) from the first to the second.
template <int D, bool DKV>
struct Geo {
    static constexpr bool SPLIT = D == 256;
    static constexpr int BM = SPLIT ? 64 : 128;                // rows a block
    static constexpr int BC = 64;                              // columns a ring tile
    static constexpr int SLOTS = SPLIT ? 2 : 3;                // ring slots, each one U and one W tile
    static constexpr int BOXES = D / 64;                       // 64-column boxes a row
    static constexpr int ROW_BOX = BM * 128;                   // one TMA box of X or Y: BM rows x 64 bf16 (128 bytes)
    static constexpr int COL_BOX = BC * 128;                   // one TMA box of U or W: BC rows x 64 bf16
    static constexpr int XT = BOXES * ROW_BOX;                 // X or Y
    static constexpr int UT = BOXES * COL_BOX;                 // U or W
    static constexpr int X = 0, Y = XT, U = 2 * XT;            // slot s: U at U + 2 s UT, W one UT on
    static constexpr int XCHG = U + SLOTS * 2 * UT;            // SPLIT: [2][32][128] f32, g of even and odd tiles
    static constexpr int XCHG_BYTES = SPLIT ? 2 * 32 * 128 * 4 : 0;
    static constexpr int BYTES = XCHG + XCHG_BYTES + 1024;     // + slack to align the tiles to 1024 bytes
    // the static column data (segments, lse, dsum) and the barriers beside the dynamic bytes
    static constexpr int STATIC_BYTES = SLOTS * BC * 12 + SLOTS * 8 + (2 * SLOTS + 1) * 8;
    static_assert(BYTES + STATIC_BYTES <= 232448, "more shared memory than a block may have");
    static_assert(BYTES + 4096 < (1 << 18), "a descriptor's address field holds addresses below 2^18");
};

// The mask's tile tests in the kernel's orientation: rows [r0, r0 + rn) x columns [c0, c0 + cn).
template <bool DKV>
__device__ __forceinline__ bool visible(const Mask& m, int r0, int rn, int c0, int cn) {
    return DKV ? tile_visible(m, c0, cn, r0, rn) : tile_visible(m, r0, rn, c0, cn);
}
template <bool DKV>
__device__ __forceinline__ bool whole(const Mask& m, int r0, int rn, int c0, int cn) {
    return DKV ? tile_full(m, c0, cn, r0, rn) : tile_full(m, r0, rn, c0, cn);
}

// Half H of a column tile (columns [32 H, 32 H + 32)) for a thread's rows r0 and r0 + 8, in the wgmma m64n64
// layout (register 4 i + e of s and dp holds column 8 i + 2 tq + (e & 1), row r0 + 8 (e >> 1)). p = 2^(x log2 e - lse log2 e) with x = s scale
// or cap tanh(s scale / cap), selected to 0 where masked; ds = p (dp - dsum) [1 - (x / cap)^2] scale. Both
// leave as bf16 in the A fragments of the next products: register 4 kk + f holds columns 16 kk + 2 tq
// (+ 8 for f >= 2), row r0 (f even) or r0 + 8. dq takes lse and dsum of its rows (lse2r, dsumr), dk/dv
// those of its columns (lse2c, dsumc, staged by the producer). MASKED: row r sees columns [lo[r], hi[r]]
// and, with segments, the columns of its own segment rseg[r]; otherwise every element is attended to.
template <bool DKV, bool MASKED, bool CAP, int H>
__device__ __forceinline__ void bwd_tile(const float (&s)[32], const float (&dp)[32], uint32_t (&pf)[16],
                                         uint32_t (&df)[16], const int (&lo)[2], const int (&hi)[2],
                                         const int (&rseg)[2], const int* cseg, bool has_seg,
                                         const float (&lse2r)[2], const float (&dsumr)[2], const float* lse2c,
                                         const float* dsumc, float scale, float scale2, float cap_in, float cap2,
                                         int tq) {
#pragma unroll
    for (int i = 4 * H; i < 4 * H + 4; ++i) {
        const int c = 8 * i + 2 * tq;
        int2 seg = make_int2(0, 0);
        if (MASKED && has_seg) seg = *reinterpret_cast<const int2*>(cseg + c);
        float2 cl = make_float2(0.f, 0.f), cd = make_float2(0.f, 0.f);
        if (DKV) {
            cl = *reinterpret_cast<const float2*>(lse2c + c);
            cd = *reinterpret_cast<const float2*>(dsumc + c);
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            float pv[2], dv[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int at = 4 * i + 2 * r + e;
                const float l2 = DKV ? (e ? cl.y : cl.x) : lse2r[r];
                const float sum = DKV ? (e ? cd.y : cd.x) : dsumr[r];
                float th = 0.f, p;
                if (CAP) {
                    th = tanh_fast(s[at] * cap_in);
                    p = exp2_fast(th * cap2 - l2);
                } else {
                    p = exp2_fast(fmaf(s[at], scale2, -l2));
                }
                bool keep = true;
                if (MASKED) {
                    keep = c + e >= lo[r] && c + e <= hi[r] && (!has_seg || (e ? seg.y : seg.x) == rseg[r]);
                    p = keep ? p : 0.f;
                }
                float ds = p * (dp[at] - sum);
                if (CAP) ds *= 1.f - th * th;
                ds *= scale;
                pv[e] = p;
                dv[e] = keep ? ds : 0.f;
            }
            const int f = 4 * (i >> 1) + 2 * (i & 1) + r;
            df[f] = pack_bf16(dv[0], dv[1]);
            if (DKV) pf[f] = pack_bf16(pv[0], pv[1]);
        }
    }
}

// Half H of a tile by the warp's class: 0 dead (P = dS = 0), 1 whole, 2 masked element by element.
template <bool DKV, int H>
__device__ __forceinline__ void tile_half(int cls, bool capped, const float (&s)[32], const float (&dp)[32],
                                          uint32_t (&pf)[16], uint32_t (&df)[16], const int (&lo)[2],
                                          const int (&hi)[2], const int (&rseg)[2], const int* cseg, bool has_seg,
                                          const float (&lse2r)[2], const float (&dsumr)[2], const float* lse2c,
                                          const float* dsumc, float scale, float scale2, float cap_in, float cap2,
                                          int tq) {
    if (cls == 0) {
#pragma unroll
        for (int f = 8 * H; f < 8 * H + 8; ++f) pf[f] = df[f] = 0u;
    } else if (capped) {
        if (cls == 1)
            bwd_tile<DKV, false, true, H>(s, dp, pf, df, lo, hi, rseg, cseg, has_seg, lse2r, dsumr, lse2c, dsumc,
                                          scale, scale2, cap_in, cap2, tq);
        else
            bwd_tile<DKV, true, true, H>(s, dp, pf, df, lo, hi, rseg, cseg, has_seg, lse2r, dsumr, lse2c, dsumc,
                                         scale, scale2, cap_in, cap2, tq);
    } else if (cls == 1) {
        bwd_tile<DKV, false, false, H>(s, dp, pf, df, lo, hi, rseg, cseg, has_seg, lse2r, dsumr, lse2c, dsumc, scale,
                                       scale2, cap_in, cap2, tq);
    } else {
        bwd_tile<DKV, true, false, H>(s, dp, pf, df, lo, hi, rseg, cseg, has_seg, lse2r, dsumr, lse2c, dsumc, scale,
                                      scale2, cap_in, cap2, tq);
    }
}

// The products of half H: k steps 2 H and 2 H + 1 (16 columns = 2048 bytes of a U / W box each).
// dq: dQ += dS U; dk/dv: dV += P^T W, dK += dS^T U.
template <int D, bool DKV, int H>
__device__ __forceinline__ void rs_half(float (&acc1)[D / 2], float (&acc2)[DKV ? D / 2 : 1], const uint32_t (&pf)[16],
                                        const uint32_t (&df)[16], const uint8_t* us, const uint8_t* ws) {
    constexpr int COL_BOX = 64 * 128;
#pragma unroll
    for (int kk = 2 * H; kk < 2 * H + 2; ++kk) {
        if constexpr (DKV) {
            const uint32_t pa[4] = {pf[4 * kk], pf[4 * kk + 1], pf[4 * kk + 2], pf[4 * kk + 3]};
            wgmma_rs_d<D>(acc2, pa, smem_desc_mn(ws + kk * 2048, COL_BOX));
        }
        const uint32_t da[4] = {df[4 * kk], df[4 * kk + 1], df[4 * kk + 2], df[4 * kk + 3]};
        wgmma_rs_d<D>(acc1, da, smem_desc_mn(us + kk * 2048, COL_BOX));
    }
}

// Keep the compiler from moving the fragments of half H across the asynchronous products that read them.
template <int H>
__device__ __forceinline__ void fence_half(uint32_t (&d)[16]) {
#pragma unroll
    for (int i = 8 * H; i < 8 * H + 8; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// SPLIT's exchange buffer b is full (consumer 0 wrote g) at named barrier XCHG_FULL + b, empty (consumer 1 read it)
// at XCHG_EMPTY + b.
constexpr int XCHG_FULL = 1, XCHG_EMPTY = 3;

// SPLIT, consumer 0: a 64-column tile of scores (the m64n64 layout; dk/dv: S^T, rows keys, columns queries) to
// g = P [1 - (x / cap)^2] scale in place of s and, for dk/dv, P^T packed to bf16 in the A fragment of its dV
// product, both selected to 0 where masked; consumer 1 makes dS = g (dP - dsum) from g. dq takes lse of its rows
// (lse2r), dk/dv of its columns (lse2c). MASKED as in bwd_tile.
template <bool DKV, bool MASKED, bool CAP>
__device__ __forceinline__ void score_tile(float (&s)[32], uint32_t (&pf)[16], const int (&lo)[2], const int (&hi)[2],
                                           const int (&rseg)[2], const int* cseg, bool has_seg,
                                           const float (&lse2r)[2], const float* lse2c, float scale, float scale2,
                                           float cap_in, float cap2, int tq) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int c = 8 * i + 2 * tq;
        int2 seg = make_int2(0, 0);
        if (MASKED && has_seg) seg = *reinterpret_cast<const int2*>(cseg + c);
        float2 cl = make_float2(0.f, 0.f);
        if (DKV) cl = *reinterpret_cast<const float2*>(lse2c + c);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            float pv[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int at = 4 * i + 2 * r + e;
                const float l2 = DKV ? (e ? cl.y : cl.x) : lse2r[r];
                float p, g;
                if (CAP) {
                    const float th = tanh_fast(s[at] * cap_in);
                    p = exp2_fast(th * cap2 - l2);
                    g = p * (1.f - th * th) * scale;
                } else {
                    p = exp2_fast(fmaf(s[at], scale2, -l2));
                    g = p * scale;
                }
                if (MASKED) {
                    const bool keep = c + e >= lo[r] && c + e <= hi[r] && (!has_seg || (e ? seg.y : seg.x) == rseg[r]);
                    p = keep ? p : 0.f;
                    g = keep ? g : 0.f;
                }
                pv[e] = p;
                s[at] = g;
            }
            if (DKV) pf[4 * (i >> 1) + 2 * (i & 1) + r] = pack_bf16(pv[0], pv[1]);
        }
    }
}

// Grid: dq (q tiles, H, B), the longest causal rows first; dk/dv (k tiles, Hk, B). Tensor maps (D, S, heads, B):
// tm_x, tm_y boxes of 64 x BM rows, tm_u, tm_w boxes of 64 x BC rows.
template <int D, bool DKV>
__global__ void __launch_bounds__(THREADS, 1)
fa_bwd_wgmma_kernel(__grid_constant__ const CUtensorMap tm_x, __grid_constant__ const CUtensorMap tm_y,
                    __grid_constant__ const CUtensorMap tm_u, __grid_constant__ const CUtensorMap tm_w,
                    const Args a) {
    using L = Geo<D, DKV>;
    constexpr int BM = L::BM, BC = L::BC, SLOTS = L::SLOTS, ROW_BOX = L::ROW_BOX, COL_BOX = L::COL_BOX;
    extern __shared__ uint8_t smem_raw[];
    __shared__ __align__(8) uint64_t x_full;
    __shared__ __align__(8) uint64_t full[SLOTS];
    __shared__ __align__(8) uint64_t empty[SLOTS];
    __shared__ __align__(16) int col_seg[SLOTS][BC];      // the tile's column segments
    __shared__ __align__(16) float col_lse2[SLOTS][BC];   // dk/dv: the tile's queries' lse log2 e
    __shared__ __align__(16) float col_dsum[SLOTS][BC];   // dk/dv: and their dsum
    __shared__ int col_one[SLOTS][2];                     // {every column in one segment, that segment}
    uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);

    const Mask mk = make_mask(a);
    const int H = (int)a.H, G = H / (int)a.Hk, b = blockIdx.z;
    const int n_rows = DKV ? mk.Sk : mk.Sq, n_cols = DKV ? mk.Sq : mk.Sk;
    const int row0 = (DKV ? (int)blockIdx.x : (int)gridDim.x - 1 - (int)blockIdx.x) * BM;
    const int hx = blockIdx.y;                       // the head of X and Y: dq a query head, dk/dv a kv head
    const int h_first = DKV ? hx * G : hx / G;       // the first (dq: only) head of U and W
    // The visible column tiles are one range: the window band cuts one end, causality the other.
    int c_lo = 0, c_hi = (n_cols + BC - 1) / BC;
    while (c_lo < c_hi && !visible<DKV>(mk, row0, BM, c_lo * BC, BC)) ++c_lo;
    while (c_hi > c_lo && !visible<DKV>(mk, row0, BM, (c_hi - 1) * BC, BC)) --c_hi;
    const int n_tiles = c_hi - c_lo, n_it = (DKV ? G : 1) * n_tiles;

    const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
    if (threadIdx.x == 0) {
        mbar_init(&x_full, 1);
        for (int s = 0; s < SLOTS; ++s) {
            mbar_init(&full[s], 32);  // the producer warp's lanes, after their stores; and the copy's bytes
            mbar_init(&empty[s], 8);  // the consumers' 8 warps
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (wg == 0) {
        // producer: one warp keeps the ring filled
        asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
        if (t < 32) {
            const int lane = t;
            if (n_it > 0 && lane == 0) {
                tma_prefetch_map(&tm_x);
                tma_prefetch_map(&tm_y);
                tma_prefetch_map(&tm_u);
                tma_prefetch_map(&tm_w);
                mbar_expect_tx(&x_full, 2 * L::XT);
                for (int x = 0; x < L::BOXES; ++x) {
                    tma_load_4d(base + L::X + x * ROW_BOX, &tm_x, &x_full, 64 * x, row0, hx, b);
                    tma_load_4d(base + L::Y + x * ROW_BOX, &tm_y, &x_full, 64 * x, row0, hx, b);
                }
            }
            const int* segc = (DKV ? a.seg_q : a.seg_k) + (long long)b * n_cols;
            for (int it = 0; it < n_it; ++it) {
                const int s = it % SLOTS, h = h_first + it / n_tiles, c0 = (c_lo + it % n_tiles) * BC;
                // the tile's column data, read before the slot is free, stored after its copy is issued
                int seg[2] = {0, 0}, first = 0;
                float lse2[2] = {0.f, 0.f}, dsum[2] = {0.f, 0.f};
                if (mk.has_seg) first = segc[c0];
#pragma unroll
                for (int i = 0; i < 2; ++i) {
                    const int col = c0 + lane + 32 * i;
                    const bool in = col < n_cols;
                    if (mk.has_seg) seg[i] = in ? segc[col] : first;  // columns past the end are masked anyway
                    if (DKV && in) {
                        const long long at = ((long long)b * H + h) * mk.Sq + col;
                        lse2[i] = a.lse[at] * LOG2E;
                        dsum[i] = a.dsum[at];
                    }
                }
                if (it >= SLOTS) mbar_wait(&empty[s], (it / SLOTS - 1) & 1);
                if (lane == 0) {
                    mbar_expect_tx_only(&full[s], 2 * L::UT);
                    uint8_t* ud = base + L::U + 2 * s * L::UT;
                    for (int x = 0; x < L::BOXES; ++x) {
                        tma_load_4d(ud + x * COL_BOX, &tm_u, &full[s], 64 * x, c0, h, b);
                        tma_load_4d(ud + L::UT + x * COL_BOX, &tm_w, &full[s], 64 * x, c0, h, b);
                    }
                }
                bool same = true;
#pragma unroll
                for (int i = 0; i < 2; ++i) {
                    col_seg[s][lane + 32 * i] = seg[i];
                    same = same && seg[i] == first;
                    if (DKV) {
                        col_lse2[s][lane + 32 * i] = lse2[i];
                        col_dsum[s][lane + 32 * i] = dsum[i];
                    }
                }
                same = __all_sync(0xffffffffu, same);
                if (lane == 0) {
                    col_one[s][0] = same;
                    col_one[s][1] = first;
                }
                mbar_arrive(&full[s]);  // every lane, after its stores
            }
        }
    } else if constexpr (L::SPLIT) {
        // D 256: both consumers walk the block's 64 rows (warp w rows [+16 w, +16)) over the same column tiles.
        // Consumer 0 makes the scores A1 = X U^T (dq: S; dk/dv: S^T) and from them g = P [1 - (x / cap)^2] scale
        // (f32, 0 where masked), which it hands to consumer 1 through a double-buffered exchange; for dk/dv it
        // also packs P^T and accumulates dV += P^T dO. Consumer 1 makes A2 = Y W^T (dP; dk/dv: dP^T), dS =
        // g (dP - dsum) in bf16, and accumulates dQ += dS K (dk/dv: dK += dS^T Q). Each product is issued once a
        // tile, and consumer 0 runs up to a tile ahead, so its exponentials overlap consumer 1's products.
        asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
        const int c = wg - 1, warp = t / 32, lane = t % 32, tq = lane % 4;
        const int wr0 = row0 + 16 * warp, r0 = wr0 + lane / 4;  // this thread's rows: r0 and r0 + 8
        // [2][32][128] f32: g of the even and the odd tiles; thread t's entries lie 128 words apart, so a warp's
        // accesses fall in 32 different banks (both consumers' threads hold the same elements of the m64n64 layout)
        float* xg = reinterpret_cast<float*>(base + L::XCHG);
        int rseg[2] = {0, 0};
        float lse2r[2] = {0.f, 0.f}, dsumr[2] = {0.f, 0.f};  // dq: its rows' lse log2 e and dsum
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int row = r0 + 8 * r;
            if (row >= n_rows) continue;
            if (mk.has_seg) rseg[r] = (DKV ? a.seg_k : a.seg_q)[(long long)b * n_rows + row];
            if (!DKV) {
                const long long at = ((long long)b * H + hx) * mk.Sq + row;
                lse2r[r] = a.lse[at] * LOG2E;
                dsumr[r] = a.dsum[at];
            }
        }
        const int seg_w = __shfl_sync(0xffffffffu, rseg[0], 0);
        const bool row_one_seg = __all_sync(0xffffffffu, rseg[0] == seg_w && rseg[1] == seg_w);
        const float scale = (float)a.scale, cap = (float)a.softcap;
        const float scale2 = scale * LOG2E;
        const bool capped = cap > 0.f;
        const float cap_in = capped ? scale / cap : 0.f, cap2 = capped ? cap * LOG2E : 0.f;

        float acc[128];  // consumer 0: dV (dk/dv); consumer 1: dQ or dK
#pragma unroll
        for (int i = 0; i < 128; ++i) acc[i] = 0.f;
        float sc[32];     // consumer 0: the scores, then g; consumer 1: dP
        uint32_t fr[16];  // consumer 0: the bf16 P^T fragment (dk/dv); consumer 1: dS
        if (n_it > 0) mbar_wait(&x_full, 0);
        uint64_t dx = smem_desc(base + (c == 0 ? L::X : L::Y));
        asm volatile("" : "+l"(dx));
        // The visible column tiles are one range (causality and the window band are monotone in the column), so
        // every tile of it is worked on, by both consumers.
        for (int it = 0; it < n_it; ++it) {
            const int slot = it % SLOTS, c0 = (c_lo + it % n_tiles) * BC, xb = it & 1;
            float* g = xg + xb * 32 * 128;
            mbar_wait(&full[slot], (it / SLOTS) & 1);
            const uint8_t* us = base + L::U + 2 * slot * L::UT;
            const uint8_t* ws = us + L::UT;
            const uint64_t du = smem_desc(c == 0 ? us : ws);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk) {
                const int ax = (kk / 4) * ROW_BOX + (kk % 4) * 32, au = (kk / 4) * COL_BOX + (kk % 4) * 32;
                wgmma_ss_n64(sc, dx + (ax >> 4), du + (au >> 4), kk > 0);
            }
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(sc);
            if (c == 0) {
                // the warp's class: dead (P = dS = 0), whole (no per-element test) or masked element by element
                int lo[2], hi[2];
                bool none = true;
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                    const int row = r0 + 8 * r;
                    if (DKV) {  // row = key, columns = queries
                        hi[r] = row < n_rows ? mk.Sq - 1 - c0 : -1;
                        lo[r] = mk.causal ? row - mk.q_offset - c0 : 0;
                        if (mk.window > 0) hi[r] = min(hi[r], row - mk.q_offset + mk.window - 1 - c0);
                    } else {    // row = query, columns = keys
                        const int gq = mk.q_offset + row;
                        hi[r] = row < n_rows ? mk.Sk - 1 - c0 : -1;
                        if (mk.causal) hi[r] = min(hi[r], gq - c0);
                        lo[r] = mk.window > 0 ? gq - c0 - mk.window + 1 : 0;
                    }
                    none = none && (hi[r] < 0 || hi[r] < lo[r] || lo[r] > BC - 1);
                }
                const bool col_one_seg = col_one[slot][0] != 0;
                const bool one_seg = row_one_seg && col_one_seg && col_one[slot][1] == seg_w;
                const bool dead = __all_sync(0xffffffffu, none) ||
                                  (mk.has_seg && row_one_seg && col_one_seg && col_one[slot][1] != seg_w);
                const bool full_tile = whole<DKV>(mk, wr0, 16, c0, BC) && (!mk.has_seg || one_seg);
                const int* cseg = col_seg[slot];
                const float* lse2c = col_lse2[slot];
                if (dead) {
#pragma unroll
                    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
#pragma unroll
                    for (int i = 0; i < 16; ++i) fr[i] = 0u;
                } else if (capped) {
                    if (full_tile)
                        score_tile<DKV, false, true>(sc, fr, lo, hi, rseg, cseg, mk.has_seg, lse2r, lse2c, scale,
                                                     scale2, cap_in, cap2, tq);
                    else
                        score_tile<DKV, true, true>(sc, fr, lo, hi, rseg, cseg, mk.has_seg, lse2r, lse2c, scale,
                                                    scale2, cap_in, cap2, tq);
                } else if (full_tile) {
                    score_tile<DKV, false, false>(sc, fr, lo, hi, rseg, cseg, mk.has_seg, lse2r, lse2c, scale,
                                                  scale2, cap_in, cap2, tq);
                } else {
                    score_tile<DKV, true, false>(sc, fr, lo, hi, rseg, cseg, mk.has_seg, lse2r, lse2c, scale,
                                                 scale2, cap_in, cap2, tq);
                }
                if (it >= 2) consumers_sync(XCHG_EMPTY + xb);  // consumer 1 has read this buffer's tile it - 2
#pragma unroll
                for (int i = 0; i < 32; ++i) g[i * 128 + t] = sc[i];
                consumers_arrive(XCHG_FULL + xb);
                if constexpr (DKV) {  // dV += P^T dO: 4 k steps of 16 queries, n = 256 (the tile's four boxes)
                    fence_regs(acc);
                    fence_regs(fr);
                    wgmma_fence();
#pragma unroll
                    for (int kk = 0; kk < 4; ++kk) {
                        const uint32_t pa[4] = {fr[4 * kk], fr[4 * kk + 1], fr[4 * kk + 2], fr[4 * kk + 3]};
                        wgmma_rs_n256(acc, pa, smem_desc_mn(ws + kk * 2048, COL_BOX));
                    }
                    wgmma_commit();
                    wgmma_wait<0>();
                    fence_regs(acc);
                    fence_regs(fr);
                }
            } else {
                consumers_sync(XCHG_FULL + xb);  // g of this tile is in
                const float* dsumc = col_dsum[slot];
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                    float2 cd = make_float2(0.f, 0.f);
                    if (DKV) cd = *reinterpret_cast<const float2*>(dsumc + 8 * i + 2 * tq);
#pragma unroll
                    for (int r = 0; r < 2; ++r) {
                        const int at = 4 * i + 2 * r;
                        const float d0 = g[at * 128 + t] * (sc[at] - (DKV ? cd.x : dsumr[r]));
                        const float d1 = g[(at + 1) * 128 + t] * (sc[at + 1] - (DKV ? cd.y : dsumr[r]));
                        fr[4 * (i >> 1) + 2 * (i & 1) + r] = pack_bf16(d0, d1);
                    }
                }
                if (it + 2 < n_it) consumers_arrive(XCHG_EMPTY + xb);  // consumer 0 waits on it for tile it + 2
                // dQ += dS K (dk/dv: dK += dS^T Q): 4 k steps of 16 columns, n = 256 (the tile's four boxes)
                fence_regs(acc);
                fence_regs(fr);
                wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < 4; ++kk) {
                    const uint32_t da[4] = {fr[4 * kk], fr[4 * kk + 1], fr[4 * kk + 2], fr[4 * kk + 3]};
                    wgmma_rs_n256(acc, da, smem_desc_mn(us + kk * 2048, COL_BOX));
                }
                wgmma_commit();
                wgmma_wait<0>();
                fence_regs(acc);
                fence_regs(fr);
            }
            if (lane == 0) mbar_arrive(&empty[slot]);  // each warp, after its last read of the slot
        }

        // epilogue: bf16 in the output's own layout; consumer 0 writes dV (dk/dv), consumer 1 dQ or dK
        if (DKV || c == 1) {
            int eb, eh;
            asm volatile("mov.u32 %0, %%ctaid.z;" : "=r"(eb));
            asm volatile("mov.u32 %0, %%ctaid.y;" : "=r"(eh));
            __nv_bfloat16* o = !DKV ? static_cast<__nv_bfloat16*>(a.dq) + eb * a.dq_sb + eh * a.dq_sh
                               : c == 1 ? static_cast<__nv_bfloat16*>(a.dk) + eb * a.dk_sb + eh * a.dk_sh
                                        : static_cast<__nv_bfloat16*>(a.dv) + eb * a.dv_sb + eh * a.dv_sh;
            const long long ss = !DKV ? a.dq_ss : c == 1 ? a.dk_ss : a.dv_ss;
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                const int row = r0 + 8 * r;
                if (row >= n_rows) continue;
#pragma unroll
                for (int i = 0; i < 32; ++i)
                    *reinterpret_cast<__nv_bfloat162*>(o + row * ss + 8 * i + 2 * tq) =
                        __floats2bfloat162_rn(acc[4 * i + 2 * r], acc[4 * i + 2 * r + 1]);
            }
        }
    } else {
        // consumer warpgroup c: rows [row0 + 64 c, +64); warp w of it rows [+16 w, +16)
        asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
        const int c = wg - 1, warp = t / 32, lane = t % 32, tq = lane % 4;
        const int crow0 = row0 + 64 * c, wr0 = crow0 + 16 * warp;
        const int r0 = wr0 + lane / 4;  // this thread's rows: r0 and r0 + 8
        int rseg[2] = {0, 0};
        float lse2r[2] = {0.f, 0.f}, dsumr[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int row = r0 + 8 * r;
            if (row >= n_rows) continue;
            if (mk.has_seg) rseg[r] = (DKV ? a.seg_k : a.seg_q)[(long long)b * n_rows + row];
            if (!DKV) {
                const long long at = ((long long)b * H + hx) * mk.Sq + row;
                lse2r[r] = a.lse[at] * LOG2E;
                dsumr[r] = a.dsum[at];
            }
        }
        const int seg_w = __shfl_sync(0xffffffffu, rseg[0], 0);
        const bool row_one_seg = __all_sync(0xffffffffu, rseg[0] == seg_w && rseg[1] == seg_w);
        const float scale = (float)a.scale, cap = (float)a.softcap;
        const float scale2 = scale * LOG2E;
        const bool capped = cap > 0.f;
        const float cap_in = capped ? scale / cap : 0.f, cap2 = capped ? cap * LOG2E : 0.f;

        float acc1[D / 2], acc2[DKV ? D / 2 : 1];
#pragma unroll
        for (int i = 0; i < D / 2; ++i) acc1[i] = 0.f;
#pragma unroll
        for (int i = 0; i < (DKV ? D / 2 : 1); ++i) acc2[i] = 0.f;
        float s[32], dp[32];
        uint32_t pf[16], df[16];
        if (n_it > 0) mbar_wait(&x_full, 0);
        const uint8_t* xs = base + L::X + c * 64 * 128;  // this consumer's 64 rows of each box
        const uint8_t* ys = base + L::Y + c * 64 * 128;
        for (int it = 0; it < n_it; ++it) {
            const int slot = it % SLOTS, c0 = (c_lo + it % n_tiles) * BC;
            mbar_wait(&full[slot], (it / SLOTS) & 1);
            if (visible<DKV>(mk, crow0, 64, c0, BC)) {  // the same for the whole warpgroup
                const uint8_t* us = base + L::U + 2 * slot * L::UT;
                const uint8_t* ws = us + L::UT;
                // A1 = X U^T, A2 = Y W^T: D / 16 k steps of 32 bytes, four to a box. A step's descriptor is the
                // tile's plus its offset / 16 (the address field; every address stays below 2^18), X's and Y's
                // made anew each tile behind an empty asm. Measured against smem_desc at every step (one H100,
                // turns A, B, B, A): dq 0.375-0.378 ms against 0.391-0.394, dk/dv 0.481-0.489 against 0.494-0.495.
                uint64_t dx = smem_desc(xs), dy = smem_desc(ys);
                asm volatile("" : "+l"(dx), "+l"(dy));
                const uint64_t du = smem_desc(us), dw = smem_desc(ws);
                wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < D / 16; ++kk) {
                    const int ax = (kk / 4) * ROW_BOX + (kk % 4) * 32, au = (kk / 4) * COL_BOX + (kk % 4) * 32;
                    wgmma_ss_n64(s, dx + (ax >> 4), du + (au >> 4), kk > 0);
                }
#pragma unroll
                for (int kk = 0; kk < D / 16; ++kk) {
                    const int ax = (kk / 4) * ROW_BOX + (kk % 4) * 32, au = (kk / 4) * COL_BOX + (kk % 4) * 32;
                    wgmma_ss_n64(dp, dy + (ax >> 4), dw + (au >> 4), kk > 0);
                }
                wgmma_commit();
                wgmma_wait<0>();
                fence_regs(s);
                fence_regs(dp);
                // The warp's class: dead (P = dS = 0), whole (no per-element test) or masked element by
                // element. Row r sees columns [lo[r], hi[r]] of the tile by geometry.
                int lo[2], hi[2];
                bool none = true;
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                    const int row = r0 + 8 * r;
                    if (DKV) {  // row = key, columns = queries: q_offset + qi >= key, q_offset + qi - key < window
                        hi[r] = row < n_rows ? mk.Sq - 1 - c0 : -1;
                        lo[r] = mk.causal ? row - mk.q_offset - c0 : 0;
                        if (mk.window > 0) hi[r] = min(hi[r], row - mk.q_offset + mk.window - 1 - c0);
                    } else {    // row = query, columns = keys
                        const int gq = mk.q_offset + row;
                        hi[r] = row < n_rows ? mk.Sk - 1 - c0 : -1;
                        if (mk.causal) hi[r] = min(hi[r], gq - c0);
                        lo[r] = mk.window > 0 ? gq - c0 - mk.window + 1 : 0;
                    }
                    none = none && (hi[r] < 0 || hi[r] < lo[r] || lo[r] > BC - 1);
                }
                const bool col_one_seg = col_one[slot][0] != 0;
                const bool one_seg = row_one_seg && col_one_seg && col_one[slot][1] == seg_w;
                const bool dead = __all_sync(0xffffffffu, none) ||
                                  (mk.has_seg && row_one_seg && col_one_seg && col_one[slot][1] != seg_w);
                const bool full_tile = whole<DKV>(mk, wr0, 16, c0, BC) && (!mk.has_seg || one_seg);
                const int* cseg = col_seg[slot];
                const float* lse2c = col_lse2[slot];
                const float* dsumc = col_dsum[slot];
                const int cls = dead ? 0 : full_tile ? 1 : 2;
                // Two halves of 32 columns: half 0's products run while half 1 is made, and half 0's scores
                // are dead before half 1's fragments are made.
                tile_half<DKV, 0>(cls, capped, s, dp, pf, df, lo, hi, rseg, cseg, mk.has_seg, lse2r, dsumr, lse2c,
                                  dsumc, scale, scale2, cap_in, cap2, tq);
                fence_regs(acc1);
                if (DKV) fence_regs(acc2);
                if (DKV) fence_half<0>(pf);
                fence_half<0>(df);
                wgmma_fence();
                rs_half<D, DKV, 0>(acc1, acc2, pf, df, us, ws);
                wgmma_commit();
                tile_half<DKV, 1>(cls, capped, s, dp, pf, df, lo, hi, rseg, cseg, mk.has_seg, lse2r, dsumr, lse2c,
                                  dsumc, scale, scale2, cap_in, cap2, tq);
                if (DKV) fence_half<1>(pf);
                fence_half<1>(df);
                wgmma_fence();
                rs_half<D, DKV, 1>(acc1, acc2, pf, df, us, ws);
                wgmma_commit();
                wgmma_wait<0>();
                fence_regs(acc1);
                if (DKV) fence_regs(acc2);
                if (DKV) fence_regs(pf);  // every fragment stays put until the products that read it are done
                fence_regs(df);
            }
            if (lane == 0) mbar_arrive(&empty[slot]);  // each warp, after its last read of the slot
        }

        // epilogue: bf16 in each output's own layout. The block's indices are read again here, so that they
        // hold no register through the loop (dk/dv at D 128 has none to spare).
        int eb, eh;
        asm volatile("mov.u32 %0, %%ctaid.z;" : "=r"(eb));
        asm volatile("mov.u32 %0, %%ctaid.y;" : "=r"(eh));
        __nv_bfloat16* o1 = DKV ? static_cast<__nv_bfloat16*>(a.dk) + eb * a.dk_sb + eh * a.dk_sh
                                : static_cast<__nv_bfloat16*>(a.dq) + eb * a.dq_sb + eh * a.dq_sh;
        const long long ss1 = DKV ? a.dk_ss : a.dq_ss;
        __nv_bfloat16* o2 = static_cast<__nv_bfloat16*>(a.dv) + eb * a.dv_sb + eh * a.dv_sh;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int row = r0 + 8 * r;
            if (row >= n_rows) continue;
#pragma unroll
            for (int i = 0; i < D / 8; ++i) {
                *reinterpret_cast<__nv_bfloat162*>(o1 + row * ss1 + 8 * i + 2 * tq) =
                    __floats2bfloat162_rn(acc1[4 * i + 2 * r], acc1[4 * i + 2 * r + 1]);
                if constexpr (DKV)
                    *reinterpret_cast<__nv_bfloat162*>(o2 + row * a.dv_ss + 8 * i + 2 * tq) =
                        __floats2bfloat162_rn(acc2[4 * i + 2 * r], acc2[4 * i + 2 * r + 1]);
            }
        }
    }
}

// The four tensor maps of one kernel: X and Y in boxes of BM rows, U and W in boxes of BC.
template <int D, bool DKV>
int make_maps(const Args& a, CUtensorMap (&m)[4]) {
    const int row_box[4] = {64, Geo<D, DKV>::BM, 1, 1}, col_box[4] = {64, Geo<D, DKV>::BC, 1, 1};
    const long long q_dims[4] = {a.D, a.Sq, a.H, a.B}, kv_dims[4] = {a.D, a.Sk, a.Hk, a.B};
    const long long q_st[3] = {2 * a.q_ss, 2 * a.q_sh, 2 * a.q_sb}, do_st[3] = {2 * a.do_ss, 2 * a.do_sh, 2 * a.do_sb},
                    k_st[3] = {2 * a.k_ss, 2 * a.k_sh, 2 * a.k_sb}, v_st[3] = {2 * a.v_ss, 2 * a.v_sh, 2 * a.v_sb};
    int err;
    if (DKV) {
        err = make_map_nd(&m[0], a.k, 2, 4, kv_dims, k_st, row_box);
        if (!err) err = make_map_nd(&m[1], a.v, 2, 4, kv_dims, v_st, row_box);
        if (!err) err = make_map_nd(&m[2], a.q, 2, 4, q_dims, q_st, col_box);
        if (!err) err = make_map_nd(&m[3], a.dout, 2, 4, q_dims, do_st, col_box);
    } else {
        err = make_map_nd(&m[0], a.q, 2, 4, q_dims, q_st, row_box);
        if (!err) err = make_map_nd(&m[1], a.dout, 2, 4, q_dims, do_st, row_box);
        if (!err) err = make_map_nd(&m[2], a.k, 2, 4, kv_dims, k_st, col_box);
        if (!err) err = make_map_nd(&m[3], a.v, 2, 4, kv_dims, v_st, col_box);
    }
    return err;
}

template <int D, bool DKV>
int launch(const Args& a, cudaStream_t stream) {
    using L = Geo<D, DKV>;
    CUtensorMap m[4];
    const int err = make_maps<D, DKV>(a, m);
    if (err) return err;
    const cudaError_t e =
        cudaFuncSetAttribute(fa_bwd_wgmma_kernel<D, DKV>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    if (e != cudaSuccess) return (int)e;
    const long long rows = DKV ? a.Sk : a.Sq;
    const dim3 grid((unsigned)((rows + L::BM - 1) / L::BM), (unsigned)(DKV ? a.Hk : a.H), (unsigned)a.B);
    fa_bwd_wgmma_kernel<D, DKV><<<grid, THREADS, L::BYTES, stream>>>(m[0], m[1], m[2], m[3], a);
    return (int)cudaGetLastError();
}

bool takes(const Args& a) {
    return a.is_bf16 && (a.D == 64 || a.D == 128 || a.D == 256) && a.B >= 1 && a.H >= 1 && a.Hk >= 1 && a.H % a.Hk == 0 &&
           a.Sq >= 1 && a.Sk >= 1;
}

// ---------------------------------------------------------------------------
// dsum pre-pass: dsum[b, h, i] = sum_d do[b, h, i, d] out[b, h, i, d] in f32
// ---------------------------------------------------------------------------
constexpr int DSUM_THREADS = 256;
constexpr int DSUM_LANES = 16;  // threads a row, 16 bytes each a step
constexpr int DSUM_ROWS = DSUM_THREADS / DSUM_LANES;

__device__ __forceinline__ float dot16(const uint4& x, const uint4& y, const __nv_bfloat16*) {
    const __nv_bfloat162* xv = reinterpret_cast<const __nv_bfloat162*>(&x);
    const __nv_bfloat162* yv = reinterpret_cast<const __nv_bfloat162*>(&y);
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 u = __bfloat1622float2(xv[i]), w = __bfloat1622float2(yv[i]);
        acc = fmaf(u.x, w.x, acc);
        acc = fmaf(u.y, w.y, acc);
    }
    return acc;
}
__device__ __forceinline__ float dot16(const uint4& x, const uint4& y, const float*) {
    const float4 u = *reinterpret_cast<const float4*>(&x), w = *reinterpret_cast<const float4*>(&y);
    return fmaf(u.x, w.x, fmaf(u.y, w.y, fmaf(u.z, w.z, u.w * w.w)));
}

template <typename T>
__global__ void __launch_bounds__(DSUM_THREADS) dsum_kernel(const Args a) {
    constexpr int VEC = 16 / (int)sizeof(T);
    const long long n = a.B * a.H * a.Sq;
    const long long row = (long long)blockIdx.x * DSUM_ROWS + threadIdx.x / DSUM_LANES;
    const int l = threadIdx.x % DSUM_LANES, D = (int)a.D;
    float acc = 0.f;
    if (row < n) {
        const long long i = row % a.Sq, bh = row / a.Sq, h = bh % a.H, b = bh / a.H;
        const T* dp = static_cast<const T*>(a.dout) + b * a.do_sb + h * a.do_sh + i * a.do_ss;
        const T* op = static_cast<const T*>(a.out) + b * a.o_sb + h * a.o_sh + i * a.o_ss;
        for (int d = l * VEC; d < D; d += DSUM_LANES * VEC)
            acc += dot16(*reinterpret_cast<const uint4*>(dp + d), *reinterpret_cast<const uint4*>(op + d), dp);
    }
#pragma unroll
    for (int off = DSUM_LANES / 2; off; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (l == 0 && row < n) const_cast<float*>(a.dsum)[row] = acc;
}

}  // namespace

extern "C" {

// bf16 q, k, v, do at head dim 64, 128 or 256, every row 16-byte aligned; dsum and lse (B, H, Sq) f32. Each returns
// 0, a CUDA error, or 900 / 1000 + CUresult when a tensor map cannot be encoded.
int dalm_fa_bwd_dq_wgmma(const void* args, void* stream) {
    const Args& a = *static_cast<const Args*>(args);
    if (!takes(a)) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return a.D == 256 ? launch<256, false>(a, st) : a.D == 128 ? launch<128, false>(a, st) : launch<64, false>(a, st);
}
int dalm_fa_bwd_dkv_wgmma(const void* args, void* stream) {
    const Args& a = *static_cast<const Args*>(args);
    if (!takes(a)) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return a.D == 256 ? launch<256, true>(a, st) : a.D == 128 ? launch<128, true>(a, st) : launch<64, true>(a, st);
}
// What the two launches above would return before they launch: encodes both kernels' tensor maps and launches
// nothing, so a caller can refuse the whole backward before its first kernel runs.
int dalm_fa_bwd_wgmma_maps(const void* args) {
    const Args& a = *static_cast<const Args*>(args);
    if (!takes(a)) return (int)cudaErrorInvalidValue;
    CUtensorMap m[4];
    if (a.D == 256) {
        const int err = make_maps<256, false>(a, m);
        return err ? err : make_maps<256, true>(a, m);
    }
    const int err = make_maps<128, false>(a, m);  // the boxes of D 64 and 128 are one geometry
    return err ? err : make_maps<128, true>(a, m);
}
// dsum = rowsum(do * out) into a.dsum, (B, H, Sq) f32 contiguous; bf16 or f32, D a multiple of 16 up to 256,
// rows 16-byte aligned.
int dalm_fa_dsum(const void* args, void* stream) {
    const Args& a = *static_cast<const Args*>(args);
    if (a.D < 16 || a.D > 256 || a.D % 16 || a.B < 1 || a.H < 1 || a.Sq < 1) return (int)cudaErrorInvalidValue;
    const long long n = a.B * a.H * a.Sq;
    const dim3 grid((unsigned)((n + DSUM_ROWS - 1) / DSUM_ROWS));
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (a.is_bf16) dsum_kernel<__nv_bfloat16><<<grid, DSUM_THREADS, 0, st>>>(a);
    else dsum_kernel<float><<<grid, DSUM_THREADS, 0, st>>>(a);
    return (int)cudaGetLastError();
}
int dalm_fa_bwd_wgmma_args_bytes() { return (int)sizeof(Args); }

}  // extern "C"
