// K3: exact fused dot-product + top-k scan over an embedding index, for Hopper (sm_90a).
//
// Replaces dalm_tpu/kernels/topk.py:fused_dot_topk (the Pallas bodies _topk_kernel,
// _topk_kernel_q8, _topk_kernel_q4 and their shared running top-k _fold_and_finalize).
// Semantics kept exactly:
//   - scores are f32 sums of query x row products; bf16, int8 and int4 rows are products of bf16
//     values (the reference's e.astype(bfloat16): exact for int8 and for a nibble - 8) with f32
//     sums, and the per-row scale multiplies the sum afterwards;
//   - rows >= num_valid never win (they are not read);
//   - ties go to the smaller row id;
//   - slots never filled return score -inf and id 0.
//
// What bounds it on an H100 SXM (3.35 TB/s). The scan reads N*D row values once: at the serving
// shapes (Q ~ 32 queries, D = 1024) that is 4, 2, 1 or 0.5 bytes a value, and 2*Q = 64 operations a
// value, 16-128 operations a byte: far under the tensor cores' ~295 a byte, so every mode is bound by
// the rows' bytes once its products run on tensor cores. On CUDA cores f32 FMAs alone (67 TFLOP/s)
// would take longer than reading f32 rows, and int8 / int4 rows could never approach their bounds.
//
// The design:
//   - Swapped product on tensor cores. The rows are the 16-row A operand of mma.sync, converted in
//     registers from their storage (bf16 as it is; int8 through an exact f32 magic-number step;
//     a nibble - 8 as K5's decode does it), the queries the n of the product, 8 at a time: a block
//     holds 32 queries (4 n8 tiles) and 8 consumer warps of 16 rows each (4 warps of 32 rows left one
//     warp a scheduler, which then waited on its own products: the main path's scan took longer).
//     A thread owns 16 or 32 contiguous bytes of each of its rows and feeds them to the product's k
//     slots in its own order; the query fragment follows the same order, so every load is one
//     16-byte shared load and nothing is transposed. f32 rows run 3xTF32 (m16n8k8): each operand is
//     split into hi, its top 11 significant bits, and lo = x - hi (of which the tensor core reads
//     the top 11), and lo.hi' + hi.lo' + hi.hi' are summed, each k-step's three products in a fresh
//     sum added to the accumulator with round-to-nearest (the tensor cores' own sums round toward
//     zero, which over 1024 depths biased the scores by up to 1.5e-6). Values of at most 11
//     significant bits have lo = 0, so those sums are exact.
//   - A ring of STAGES stages fed by one producer warp with TMA, released by the consumers through
//     full / empty mbarriers. A stage is 128 rows x 128 bytes (f32, bf16; 128-byte swizzle) or x 64
//     bytes (int8, int4; 64-byte swizzle) and the query slice of the same depths (one or, for int4's
//     low and high halves, two boxes of 32 queries x 128 bytes, L2-resident). Rows past num_valid or
//     N are zero-filled by the TMA and never offered.
//   - Persistent blocks, two an SM: the row tiles of a query tile are cut into nb contiguous
//     ranges (kernels/topk.py:_geometry), one a block. After a tile's last stage each consumer
//     writes its 16 x 32 scores (times the row scales) to shared memory, and warp w folds queries
//     4w .. 4w + 3 into running lists held one entry per lane, (score desc, id asc). A candidate
//     that beats its list's k-th entry goes to a buffer of 32 in shared memory (a ballot and a
//     prefix count); a full buffer, and every buffer when the block is done, is sorted by a bitonic
//     network across the lanes and merged into the list with a bitonic merge. The block's first 32
//     rows are sorted into the empty lists directly. Each block then writes its lists out.
//   - Then a second launch merges, one warp a query, the nb lists: tau, the best of the lists' k-th
//     entries, bounds the answer's k-th entry from below, so only the entries of lists whose best
//     entry reaches tau, and only those not worse than tau, are offered to the list, through the
//     same buffer. (The last block to finish, found by a ticket counter, merging all 32 queries of
//     its tile in the same launch was slower at the main path's N = 16,384 on an H100: a block's
//     warps serialise what the second launch spreads over 32 warps.) The comparison is a total
//     order, so the result does not depend on the order of the blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int QT = 32;             // queries per block: 4 n8 tiles of the swapped product
constexpr int RT = 128;            // rows per tile: 8 consumer warps x 16 rows (one m16 tile)
constexpr int CONSUMERS = 8;       // consumer warps; warp 8 is the producer
constexpr int MT = RT / 16 / CONSUMERS;  // m16 tiles a consumer warp
constexpr int QW = QT / CONSUMERS;       // queries a consumer warp folds
constexpr int THREADS = 32 * (CONSUMERS + 1);
constexpr int STAGES = 4;
constexpr int BLOCKS_PER_SM = 2;
constexpr int DEPTH_MULTIPLE = 64;
constexpr int MAX_K = 32;
constexpr int QROW = 128;          // bytes of one query in a query box
constexpr int NO_ID = 0x7fffffff;
constexpr unsigned FULL = 0xffffffffu;

enum Mode { F32 = 0, BF16 = 1, INT8 = 2, INT4 = 3 };

template <int MODE>
struct Cfg {
    static constexpr int RB = MODE <= BF16 ? 128 : 64;   // bytes of a row in a stage
    static constexpr int COLS = MODE == F32 ? 32 : 64;   // row storage columns in a stage
    static constexpr int QBOXES = MODE == INT4 ? 2 : 1;  // query boxes a stage: int4 reads two halves
    static constexpr int ROWS = RT * RB;
    static constexpr int STAGE = ROWS + QBOXES * QT * QROW;
    static constexpr int SC = QT * RT * 4 + QT * 32 * 8;  // the score tile, the fold's candidate buffers
    static constexpr int SMEM = STAGES * STAGE + SC + 1024;  // + slack to align the ring to 1024 bytes
};

struct Args {
    CUtensorMap rows, queries;
    const float* scales;  // (N) f32, int8 / int4 rows
    float* cand_s;        // (Q, nb, k)
    int* cand_i;
    float* out_s;         // (Q, k)
    int* out_i;
    int Q, D, n_scan, k, nb, tiles, nst;
};

__device__ __forceinline__ bool better(float as, int ai, float bs, int bi) {
    return as > bs || (as == bs && ai < bi);
}

// Sort 32 (score, id) pairs, one a lane, best first: a bitonic network of 15 compare-exchange steps.
__device__ __forceinline__ void sort32(float& s, int& i, int lane) {
#pragma unroll
    for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
        for (int d = size >> 1; d; d >>= 1) {
            const float ps = __shfl_xor_sync(FULL, s, d);
            const int pi = __shfl_xor_sync(FULL, i, d);
            const bool first = ((lane & d) == 0) == ((lane & size) == 0);  // keeps the better of the pair
            if (first ? better(ps, pi, s, i) : better(s, i, ps, pi)) {
                s = ps;
                i = pi;
            }
        }
}

// Merge a second sorted list (ms, mi) into (ls, li), keeping the best 32: reversed, the second list runs
// worst-first, so the better of each lane's pair holds the best 32 of both as a bitonic sequence, which
// five compare-exchange steps sort best-first.
__device__ __forceinline__ void bitonic_merge(float& ls, int& li, float ms, int mi, int lane) {
    const float rs = __shfl_sync(FULL, ms, 31 - lane);
    const int ri = __shfl_sync(FULL, mi, 31 - lane);
    if (better(rs, ri, ls, li)) {
        ls = rs;
        li = ri;
    }
#pragma unroll
    for (int d = 16; d; d >>= 1) {
        const float ps = __shfl_xor_sync(FULL, ls, d);
        const int pi = __shfl_xor_sync(FULL, li, d);
        if ((lane & d) == 0 ? better(ps, pi, ls, li) : better(ls, li, ps, pi)) {
            ls = ps;
            li = pi;
        }
    }
}

struct Entry {
    float s;
    int i;
};

// A list (entry `lane`) with a buffer's first cnt candidates sorted into it. Called where a buffer is full or a
// list is finished, so it is compiled once and called, not inlined at every fold.
__device__ __noinline__ Entry merged(float ls, int li, int cnt, const float* bs, const int* bi, int lane) {
    __syncwarp();
    float v = lane < cnt ? bs[lane] : -INFINITY;
    int vi = lane < cnt ? bi[lane] : NO_ID;
    __syncwarp();
    sort32(v, vi, lane);
    bitonic_merge(ls, li, v, vi, lane);
    return {ls, li};
}

__device__ __forceinline__ void flush(float& ls, int& li, int cnt, const float* bs, const int* bi, int lane) {
    if (cnt == 0) return;  // warp-uniform
    const Entry e = merged(ls, li, cnt, bs, bi, lane);
    ls = e.s;
    li = e.i;
}

// Offer one candidate a lane to a list (entry `lane` in ls / li) through its buffer of cnt candidates: those that
// beat the list's k-th entry and the floor (fs, fi) are appended (a ballot and a prefix count); a full buffer is
// sorted into the list, and what did not fit is offered again against the new k-th entry.
__device__ __forceinline__ void offer(float& ls, int& li, int& cnt, float* bs, int* bi, float v, int id, bool valid,
                                      float fs, int fi, int k, int lane) {
    float ts = __shfl_sync(FULL, ls, k - 1);
    int ti = __shfl_sync(FULL, li, k - 1);
    if (better(fs, fi, ts, ti)) {
        ts = fs;
        ti = fi;
    }
    const bool in = valid && better(v, id, ts, ti);
    const unsigned m = __ballot_sync(FULL, in);
    if (!m) return;
    const unsigned below = (1u << lane) - 1;
    const int pos = cnt + __popc(m & below);
    if (in && pos < 32) {
        bs[pos] = v;
        bi[pos] = id;
    }
    cnt += __popc(m);
    if (cnt < 32) return;
    flush(ls, li, 32, bs, bi, lane);
    ts = __shfl_sync(FULL, ls, k - 1);  // every lane shuffles: none may skip it
    ti = __shfl_sync(FULL, li, k - 1);
    const bool again = in && pos >= 32 && better(v, id, ts, ti);
    const unsigned m2 = __ballot_sync(FULL, again);
    if (again) {
        bs[__popc(m2 & below)] = v;
        bi[__popc(m2 & below)] = id;
    }
    cnt = __popc(m2);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo exactly: hi keeps x's sign, exponent and top 10 mantissa bits (a TF32 value), lo the rest (exact in
// f32; the tensor core reads its top 10 mantissa bits).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
    hi = __float_as_uint(x) & 0xFFFFE000u;
    lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

// Four int8 values as two exact bf16x2: byte u of w ^ 0x80 is b + 128, and the f32 2^23 + (b + 128) less
// 2^23 + 128 is b.
__device__ __forceinline__ void s8x4(uint32_t w, uint32_t& p01, uint32_t& p23) {
    const uint32_t u = w ^ 0x80808080u;
    float f[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) f[j] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + j)) - 8388736.f;
    p01 = pack2(f[0], f[1]);
    p23 = pack2(f[2], f[3]);
}

// bf16x2 (128 + u) -> u - 8, exact.
__device__ __forceinline__ uint32_t minus136(uint32_t v) {
    const uint32_t k = 0x43084308u;  // bf16x2 (136, 136)
    __nv_bfloat162 r = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&v), *reinterpret_cast<const __nv_bfloat162*>(&k));
    return *reinterpret_cast<uint32_t*>(&r);
}

// The nibbles of bytes 0, 1 (x01) and 2, 3 (x23) of w as bf16x2 nib - 8: low nibbles in lo, high in hi.
__device__ __forceinline__ void nib4(uint32_t w, uint32_t (&lo)[2], uint32_t (&hi)[2]) {
    const uint32_t x[2] = {__byte_perm(w, 0u, 0x4140), __byte_perm(w, 0u, 0x4342)};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
        lo[j] = minus136((x[j] & 0x000F000Fu) | 0x43004300u);
        hi[j] = minus136(((x[j] >> 4) & 0x000F000Fu) | 0x43004300u);
    }
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
    return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ uint4 lds(const char* p) { return *reinterpret_cast<const uint4*>(p); }

// Byte offsets of 16-byte chunk c of row r in a swizzled tile: rows of 128 bytes (chunk c at c ^ (r % 8)) or
// of 64 bytes (chunk c at c ^ (r / 2 % 4)), as the TMA wrote them.
template <int RB>
__device__ __forceinline__ int chunk_at(int r, int c) {
    return RB == 128 ? r * 128 + ((c ^ (r & 7)) << 4) : r * 64 + ((c ^ ((r >> 1) & 3)) << 4);
}

// One stage of a consumer warp: its 32 rows (two m16 tiles, rows 32 warp + 16 mt + g and + 8) against the 32
// queries (four n8 tiles). Thread (g, t) owns row bytes [RB t / 4, RB (t + 1) / 4): chunks 2t, 2t + 1 of a
// 128-byte row, chunk t of a 64-byte one; the query chunks 2t + h hold the same depths. Within a k-step it feeds
// its depths d0 .. d3 to the k slots 2t, 2t + 1, 2t + 8, 2t + 9 (m16n8k16) or d0, d1 to t, t + 4 (m16n8k8), and
// so do the query fragments: the sum over the slots is the sum over the depths.
template <int MODE>
__device__ __forceinline__ void stage(float (&acc)[MT][4][4], const char* st, int warp, int g, int t, bool masked) {
    using C = Cfg<MODE>;
    const char* qs = st + C::ROWS;
    if constexpr (MODE == F32 || MODE == BF16) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            uint4 a[MT][2], b[4];
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int rr = 0; rr < 2; ++rr)
                    a[mt][rr] = lds(st + chunk_at<128>(16 * (MT * warp + mt) + g + 8 * rr, 2 * t + h));
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) b[nt] = lds(qs + chunk_at<128>(8 * nt + g, 2 * t + h));
            if constexpr (MODE == BF16) {
#pragma unroll
                for (int kk = 0; kk < 2; ++kk)
#pragma unroll
                    for (int mt = 0; mt < MT; ++mt) {
                        const uint32_t af[4] = {word(a[mt][0], 2 * kk), word(a[mt][1], 2 * kk),
                                                word(a[mt][0], 2 * kk + 1), word(a[mt][1], 2 * kk + 1)};
#pragma unroll
                        for (int nt = 0; nt < 4; ++nt)
                            mma_bf16(acc[mt][nt], af, word(b[nt], 2 * kk), word(b[nt], 2 * kk + 1));
                    }
            } else {
#pragma unroll
                for (int kk = 0; kk < 2; ++kk) {  // k-step kk: the chunk's depths (d0, d1) = words 2 kk, 2 kk + 1
                    uint32_t bh[4][2], bl[4][2];
#pragma unroll
                    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
                        for (int e = 0; e < 2; ++e)
                            split(__uint_as_float(word(b[nt], 2 * kk + e)), bh[nt][e], bl[nt][e]);
#pragma unroll
                    for (int mt = 0; mt < MT; ++mt) {
                        uint32_t ah[4], al[4];
#pragma unroll
                        for (int e = 0; e < 4; ++e)  // a0 (g, d0), a1 (g + 8, d0), a2 (g, d1), a3 (g + 8, d1)
                            split(__uint_as_float(word(a[mt][e & 1], 2 * kk + (e >> 1))), ah[e], al[e]);
#pragma unroll
                        for (int nt = 0; nt < 4; ++nt) {
                            // the tensor cores round their sums toward zero: a k-step's three products go to a
                            // fresh sum, which joins the accumulator with a round-to-nearest add
                            float p[4] = {0.f, 0.f, 0.f, 0.f};
                            mma_tf32(p, al, bh[nt][0], bh[nt][1]);
                            mma_tf32(p, ah, bl[nt][0], bl[nt][1]);
                            mma_tf32(p, ah, bh[nt][0], bh[nt][1]);
#pragma unroll
                            for (int e = 0; e < 4; ++e) acc[mt][nt][e] = __fadd_rn(acc[mt][nt][e], p[e]);
                        }
                    }
                }
            }
        }
    } else {
        uint4 a[MT][2];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
                a[mt][rr] = lds(st + chunk_at<64>(16 * (MT * warp + mt) + g + 8 * rr, t));
                if (MODE == INT4 && masked) a[mt][rr] = make_uint4(0x88888888u, 0x88888888u, 0x88888888u, 0x88888888u);
            }
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // row bytes 8h .. 8h + 7 of the chunk: depths of query chunk 2t + h
            uint4 b[4], bh[4];
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
                b[nt] = lds(qs + chunk_at<128>(8 * nt + g, 2 * t + h));
                if constexpr (MODE == INT4) bh[nt] = lds(qs + QT * QROW + chunk_at<128>(8 * nt + g, 2 * t + h));
            }
#pragma unroll
            for (int kk = 0; kk < 2; ++kk) {
                const int wi = 2 * h + kk;
#pragma unroll
                for (int mt = 0; mt < MT; ++mt) {
                    if constexpr (MODE == INT8) {
                        uint32_t r0[2], r1[2];
                        s8x4(word(a[mt][0], wi), r0[0], r0[1]);
                        s8x4(word(a[mt][1], wi), r1[0], r1[1]);
                        const uint32_t af[4] = {r0[0], r1[0], r0[1], r1[1]};
#pragma unroll
                        for (int nt = 0; nt < 4; ++nt)
                            mma_bf16(acc[mt][nt], af, word(b[nt], 2 * kk), word(b[nt], 2 * kk + 1));
                    } else {
                        uint32_t lo0[2], hi0[2], lo1[2], hi1[2];
                        nib4(word(a[mt][0], wi), lo0, hi0);
                        nib4(word(a[mt][1], wi), lo1, hi1);
                        const uint32_t al[4] = {lo0[0], lo1[0], lo0[1], lo1[1]};
                        const uint32_t ah[4] = {hi0[0], hi1[0], hi0[1], hi1[1]};
#pragma unroll
                        for (int nt = 0; nt < 4; ++nt) {
                            mma_bf16(acc[mt][nt], al, word(b[nt], 2 * kk), word(b[nt], 2 * kk + 1));
                            mma_bf16(acc[mt][nt], ah, word(bh[nt], 2 * kk), word(bh[nt], 2 * kk + 1));
                        }
                    }
                }
            }
        }
    }
}

// The consumers of one block share the score tile: named barrier 1 over their 128 threads.
__device__ __forceinline__ void consumers_sync() { asm volatile("bar.sync 1, %0;\n" ::"n"(32 * CONSUMERS) : "memory"); }

// The score of tile row r for query q lives at sc[q * RT + (r ^ 8 ((q / 2) % 4))]: conflict-free both when the
// accumulators are stored (a warp's lanes hold 8 rows x 4 query pairs) and when a warp reads a query's 32 rows.
__device__ __forceinline__ int sc_at(int q, int r) { return q * RT + (r ^ (((q >> 1) & 3) << 3)); }

// One query's final top-k from the nb lists of its row blocks (one warp). tau, the best of the lists' k-th
// entries, bounds the answer's k-th entry from below, so only the entries of lists whose best entry reaches tau
// can place, and only those not worse than tau: they are offered to the list through a buffer (as in the scan's
// fold), with tau as the floor. Loads are issued 8 a lane before any is used.
__device__ void merge_query(const float* __restrict__ cs, const int* __restrict__ ci, int nb, int k,
                            float* __restrict__ out_s, int* __restrict__ out_i, int* plist, float* bs, int* bi,
                            int lane) {
    float ts = -INFINITY;
    int ti = NO_ID;
    for (int base = 0; base < nb; base += 256) {
        float s[8];
        int id[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
            const int b = base + 32 * u + lane;
            s[u] = b < nb ? __ldcg(cs + (size_t)b * k + k - 1) : -INFINITY;
            id[u] = b < nb ? __ldcg(ci + (size_t)b * k + k - 1) : NO_ID;
        }
#pragma unroll
        for (int u = 0; u < 8; ++u)
            if (better(s[u], id[u], ts, ti)) {
                ts = s[u];
                ti = id[u];
            }
    }
#pragma unroll
    for (int d = 16; d; d >>= 1) {
        const float s = __shfl_xor_sync(FULL, ts, d);
        const int i = __shfl_xor_sync(FULL, ti, d);
        if (better(s, i, ts, ti)) {
            ts = s;
            ti = i;
        }
    }
    int np = 0;  // the lists that reach tau, in order
    for (int base = 0; base < nb; base += 256) {
        float hs[8];
        int hi[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
            const int b = base + 32 * u + lane;
            hs[u] = b < nb ? __ldcg(cs + (size_t)b * k) : -INFINITY;
            hi[u] = b < nb ? __ldcg(ci + (size_t)b * k) : NO_ID;
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
            const bool reach = base + 32 * u + lane < nb && !better(ts, ti, hs[u], hi[u]);
            const unsigned m = __ballot_sync(FULL, reach);
            if (reach) plist[np + __popc(m & ((1u << lane) - 1))] = base + 32 * u + lane;
            np += __popc(m);
        }
    }
    __syncwarp();
    // the floor admits tau itself: (ts, ti + 1) is beaten by (ts, ti); padding (-inf, NO_ID) never passes
    const int fi = ti == NO_ID ? NO_ID : ti + 1;
    float ls = -INFINITY;
    int li = NO_ID, cnt = 0;
    const int total = np * k;
    for (int base = 0; base < total; base += 256) {
        float v[8];
        int id[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
            const int e = base + 32 * u + lane;
            const size_t o = e < total ? (size_t)plist[e / k] * k + e % k : 0;
            v[u] = e < total ? __ldcg(cs + o) : -INFINITY;
            id[u] = e < total ? __ldcg(ci + o) : NO_ID;
        }
#pragma unroll
        for (int u = 0; u < 8; ++u)
            if (base + 32 * u < total) offer(ls, li, cnt, bs, bi, v[u], id[u], true, ts, fi, k, lane);
    }
    flush(ls, li, cnt, bs, bi, lane);
    if (lane < k) {
        out_s[lane] = ls;
        out_i[lane] = ls == -INFINITY ? 0 : li;
    }
}

// The merge, one warp a query: shared memory holds each warp's list of lists (nb ints) and its buffer.
__global__ void __launch_bounds__(128) topk_merge_kernel(const float* __restrict__ cs, const int* __restrict__ ci,
                                                        int Q, int nb, int k, float* __restrict__ out_s,
                                                        int* __restrict__ out_i) {
    extern __shared__ int merge_smem[];
    const int w = threadIdx.x >> 5, q = blockIdx.x * 4 + w;
    if (q >= Q) return;  // warp-uniform
    int* plist = merge_smem + w * (nb + 64);
    merge_query(cs + (size_t)q * nb * k, ci + (size_t)q * nb * k, nb, k, out_s + (size_t)q * k, out_i + (size_t)q * k,
                plist, reinterpret_cast<float*>(plist + nb), plist + nb + 32, threadIdx.x & 31);
}

// Block (b, y) scans row tiles [b tiles / nb, (b + 1) tiles / nb) against queries [32 y, 32 y + 32).
template <int MODE>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM) topk_kernel(const __grid_constant__ Args g) {
    using C = Cfg<MODE>;
    extern __shared__ char smem_raw[];
    __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
    char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    float* sc = reinterpret_cast<float*>(ring + STAGES * C::STAGE);
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int b = blockIdx.x, q0 = blockIdx.y * QT;
    const int t_begin = (int)((long long)b * g.tiles / g.nb), t_end = (int)((long long)(b + 1) * g.tiles / g.nb);
    const int total = (t_end - t_begin) * g.nst;
    if (tid == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], CONSUMERS);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (warp == CONSUMERS) {
        if (lane == 0) {
            tma_prefetch_map(&g.rows);
            tma_prefetch_map(&g.queries);
            for (int i = 0; i < total; ++i) {
                const int slot = i % STAGES;
                if (i >= STAGES) mbar_wait(&empty[slot], ((i / STAGES) - 1) & 1);
                char* st = ring + slot * C::STAGE;
                const int tile = t_begin + i / g.nst, s = i % g.nst;
                uint64_t* bar = &full[slot];
                mbar_expect_tx(bar, C::STAGE);
                tma_load_2d(st, &g.rows, bar, s * C::COLS, tile * RT);
                tma_load_2d(st + C::ROWS, &g.queries, bar, s * (MODE == F32 ? 32 : 64), q0);
                if (MODE == INT4) tma_load_2d(st + C::ROWS + QT * QROW, &g.queries, bar, g.D / 2 + s * 64, q0);
            }
        }
    } else {
        const int gq = lane >> 2, t = lane & 3;
        // Per query: the running list (entry `lane`) and a buffer of cnt candidates that beat its k-th entry when
        // they came, sorted into the list when it holds 32 and when the block is done.
        float ls[QW];
        int li[QW], cnt[QW];
        float (*bs)[32] = reinterpret_cast<float (*)[32]>(sc + QT * RT) + 2 * QW * warp;
        int (*bi)[32] = reinterpret_cast<int (*)[32]>(sc + QT * RT) + 2 * QW * warp + QW;
#pragma unroll
        for (int j = 0; j < QW; ++j) {
            ls[j] = -INFINITY;
            li[j] = NO_ID;
            cnt[j] = 0;
        }
        int i = 0;
        for (int tile = t_begin; tile < t_end; ++tile) {
            float acc[MT][4][4] = {};
            for (int s = 0; s < g.nst; ++s, ++i) {
                const int slot = i % STAGES;
                mbar_wait(&full[slot], (i / STAGES) & 1);
                // int4: a stage past D/2 packed bytes (D % 128 == 64) holds zeros there; they must count 0, not -8
                const bool masked = MODE == INT4 && 16 * t >= g.D / 2 - s * 64;
                stage<MODE>(acc, ring + slot * C::STAGE, warp, gq, t, masked);
                __syncwarp();
                if (lane == 0) mbar_arrive(&empty[slot]);
            }
            const int row0 = tile * RT;
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int rr = 0; rr < 2; ++rr) {
                    const int r = 16 * (MT * warp + mt) + gq + 8 * rr;
                    float sf = 1.f;
                    if (MODE >= INT8 && row0 + r < g.n_scan) sf = __ldg(g.scales + row0 + r);
#pragma unroll
                    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
                        for (int e = 0; e < 2; ++e) {
                            const float v = acc[mt][nt][2 * rr + e];
                            sc[sc_at(8 * nt + 2 * t + e, r)] = MODE >= INT8 ? __fmul_rn(v, sf) : v;
                        }
                }
            consumers_sync();
            // Fold: warp w owns the QW queries from QW w on; the tile's 128 rows come in four chunks of 32, one a lane.
#pragma unroll
            for (int c = 0; c < RT / 32; ++c) {
                const int r = 32 * c + lane, row = row0 + r;
                if (tile == t_begin && c == 0) {  // the lists are empty: sort the chunk into them, all at once
#pragma unroll
                    for (int j = 0; j < QW; ++j) {
                        ls[j] = row < g.n_scan ? sc[sc_at(QW * warp + j, r)] : -INFINITY;
                        li[j] = row < g.n_scan ? row : NO_ID;
                        sort32(ls[j], li[j], lane);
                    }
                    continue;
                }
#pragma unroll
                for (int j = 0; j < QW; ++j)
                    offer(ls[j], li[j], cnt[j], bs[j], bi[j], sc[sc_at(QW * warp + j, r)], row, row < g.n_scan,
                          -INFINITY, NO_ID, g.k, lane);
            }
            consumers_sync();  // the next tile overwrites the scores
        }
#pragma unroll
        for (int j = 0; j < QW; ++j) flush(ls[j], li[j], cnt[j], bs[j], bi[j], lane);
#pragma unroll
        for (int j = 0; j < QW; ++j) {
            const int q = q0 + QW * warp + j;
            if (q < g.Q && lane < g.k) {
                const size_t o = ((size_t)q * g.nb + b) * g.k + lane;
                g.cand_s[o] = ls[j];
                g.cand_i[o] = li[j];
            }
        }
    }

}

// A 2-D tensor map over a (rows, cols) row-major tensor with boxes of box_cols x box_rows and the given swizzle
// (box_cols x the value's bytes equal to its span); zeros beyond the edges.
int map2d(CUtensorMap* map, const void* base, CUtensorMapDataType type, int elem, long long rows, long long cols,
          int box_cols, int box_rows, CUtensorMapSwizzle swizzle) {
    const EncodeTiled fn = encode_tiled();
    if (!fn) return ERR_NO_ENCODER;
    const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows}, strides[1] = {(cuuint64_t)(cols * elem)};
    const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows}, step[2] = {1, 1};
    const CUresult r = fn(map, type, 2, const_cast<void*>(base), dims, strides, box, step,
                          CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : ERR_ENCODE + (int)r;
}

template <int MODE>
int launch(Args& a, const void* queries, const void* rows, int n_rows, int q_tiles, cudaStream_t stream) {
    using C = Cfg<MODE>;
    const CUtensorMapSwizzle rsw = C::RB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
    int err;
    if (MODE == F32) {
        err = map2d(&a.rows, rows, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, n_rows, a.D, 32, RT, rsw);
        if (!err) err = map2d(&a.queries, queries, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, a.Q, a.D, 32, QT,
                              CU_TENSOR_MAP_SWIZZLE_128B);
    } else {
        if (MODE == BF16) err = map2d(&a.rows, rows, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, n_rows, a.D, 64, RT, rsw);
        else
            err = map2d(&a.rows, rows, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, n_rows, MODE == INT4 ? a.D / 2 : a.D, 64, RT,
                        rsw);
        if (!err) err = map2d(&a.queries, queries, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a.Q, a.D, 64, QT,
                              CU_TENSOR_MAP_SWIZZLE_128B);
    }
    if (err) return err;
    static bool configured = false;
    if (!configured) {
        const cudaError_t e =
            cudaFuncSetAttribute(topk_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
        if (e != cudaSuccess) return (int)e;
        configured = true;
    }
    topk_kernel<MODE><<<dim3(a.nb, q_tiles), THREADS, C::SMEM, stream>>>(a);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    topk_merge_kernel<<<(a.Q + 3) / 4, 128, 4 * (a.nb + 64) * sizeof(int), stream>>>(a.cand_s, a.cand_i, a.Q, a.nb, a.k,
                                                                                    a.out_s, a.out_i);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int dalm_topk_max_k() { return MAX_K; }
int dalm_topk_rows_per_tile() { return RT; }
int dalm_topk_queries_per_tile() { return QT; }
int dalm_topk_blocks_per_sm() { return BLOCKS_PER_SM; }
int dalm_topk_depth_multiple() { return DEPTH_MULTIPLE; }

// mode: 0 f32 rows + f32 queries; 1 bf16 rows; 2 int8 rows; 3 int4 half-split rows (N, D/2)
// (modes 1-3 take bf16 queries; 2-3 take f32 per-row scales). Rows [0, n_scan) are scanned, in nb
// contiguous ranges of whole 128-row tiles per 32-query tile (1 <= nb <= max(1, tiles)). D a multiple of
// 64, 1 <= k <= 32, every pointer 16-byte aligned. scratch holds 2 * Q * nb * k int32 values (the
// blocks' lists). Two launches, the scan and the merge; returns the CUDA error (0 = ok), or 900 / 1000 +
// CUresult when a tensor map cannot be encoded.
int dalm_topk_launch(int mode, const void* queries, const void* rows, const void* scales, int Q, int N, int D,
                     int n_scan, int k, int nb, void* scratch, void* out_s, void* out_i, void* stream_ptr) {
    const cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
    const int tiles = (n_scan + RT - 1) / RT;
    if (k < 1 || k > MAX_K || D < DEPTH_MULTIPLE || D % DEPTH_MULTIPLE || Q < 1 || N < 1 || n_scan < 0 || n_scan > N ||
        nb < 1 || nb > (tiles > 1 ? tiles : 1) || mode < F32 || mode > INT4)
        return (int)cudaErrorInvalidValue;
    const size_t cands = (size_t)Q * nb * k;
    Args a{};
    a.scales = static_cast<const float*>(scales);
    a.cand_s = static_cast<float*>(scratch);
    a.cand_i = static_cast<int*>(scratch) + cands;
    a.out_s = static_cast<float*>(out_s);
    a.out_i = static_cast<int*>(out_i);
    a.Q = Q;
    a.D = D;
    a.n_scan = n_scan;
    a.k = k;
    a.nb = nb;
    a.tiles = tiles;
    const int q_tiles = (Q + QT - 1) / QT;
    const int n_rows = n_scan > 0 ? n_scan : 1;  // rows past n_scan read as zeros
    switch (mode) {
        case F32: a.nst = D / 32; return launch<F32>(a, queries, rows, n_rows, q_tiles, stream);
        case BF16: a.nst = D / 64; return launch<BF16>(a, queries, rows, n_rows, q_tiles, stream);
        case INT8: a.nst = D / 64; return launch<INT8>(a, queries, rows, n_rows, q_tiles, stream);
        default: a.nst = (D / 2 + 63) / 64; return launch<INT4>(a, queries, rows, n_rows, q_tiles, stream);
    }
}

}  // extern "C"
