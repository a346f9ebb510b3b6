// K3: exact fused dot-product + top-k scan over an embedding index, for Hopper (sm_90a).
//
// Replaces dalm_tpu/kernels/topk.py:fused_dot_topk (the Pallas bodies _topk_kernel,
// _topk_kernel_q8, _topk_kernel_q4 and their shared running top-k _fold_and_finalize).
// Semantics kept exactly:
//   - scores are f32 sums of query x row products; int8/int4 rows are dotted as integers
//     with bf16 queries and the per-row scale multiplies the sum afterwards;
//   - rows >= num_valid never win (they score -inf);
//   - ties go to the smaller row id;
//   - slots never filled return score -inf and id 0.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 on CUDA cores): the scan reads N*D*bytes
// once. At the serving shapes (Q ~ 32 queries, D = 1024) f32 rows need 2*Q*N*D operations,
// which at 67 TFLOP/s takes about as long as reading the rows, so the f32 mode sits near both
// the bandwidth and the FMA roof; int8 and int4 rows cut the bytes 4x and 8x.
//
// Design. The TPU kernel walks row blocks in order and carries the running top-k in scratch.
// Hopper blocks run in parallel and in no order, so this is two passes:
//   1. topk_scan: each block owns one chunk of rows and a tile of up to 32 queries. It streams
//      its rows through shared memory 128 at a time (64 columns per stage, converted to f32),
//      scores them with a 4x4 register tile per thread, and folds each 32x128 score tile into
//      a per-query sorted top-k list held one entry per lane of a warp (so k <= 32). Only
//      candidates that beat the list's k-th entry are inserted; the warp inserts them one at
//      a time with a ballot and a shuffle. The chunk's k best go to (Q, n_chunks, k).
//   2. topk_merge: one warp per query folds its n_chunks*k candidates with the same insertion.
// The comparison is (score desc, id asc) everywhere, which gives the smaller-id tie rule no
// matter in which order the candidates arrive. A simple kernel: no tensor cores, TMA or
// wgmma yet.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int QT = 32;        // queries per block
constexpr int RT = 128;       // rows per tile
constexpr int DS = 64;        // depth (columns) per shared-memory stage
constexpr int THREADS = 256;  // 8 warps
constexpr int RS_PITCH = RT + 4;
constexpr int QS_PITCH = QT + 4;  // keeps float4 alignment, spreads the transposed writes
constexpr int MAX_K = 32;
constexpr int NO_ID = 0x7fffffff;

enum Mode { F32 = 0, BF16 = 1, INT8 = 2, INT4 = 3 };

__device__ __forceinline__ bool better(float as, int ai, float bs, int bi) {
  return as > bs || (as == bs && ai < bi);
}

// Insert (cs, ci) into a warp's sorted list (entry `lane` in ls/li, lanes < k valid) if it
// beats the k-th entry. All 32 lanes call this with the same (cs, ci).
__device__ __forceinline__ void warp_insert(float& ls, int& li, float cs, int ci, int k, int lane) {
  const unsigned full = 0xffffffffu;
  float ts = __shfl_sync(full, ls, k - 1);
  int ti = __shfl_sync(full, li, k - 1);
  if (!better(cs, ci, ts, ti)) return;
  bool keep = lane < k && better(ls, li, cs, ci);
  int pos = __popc(__ballot_sync(full, keep));
  float up_s = __shfl_up_sync(full, ls, 1);
  int up_i = __shfl_up_sync(full, li, 1);
  if (lane == pos) {
    ls = cs;
    li = ci;
  } else if (lane > pos) {
    ls = up_s;
    li = up_i;
  }
}

// Offer 32 candidates (one per lane) to the list; those that beat the k-th entry go in, in
// lane order.
__device__ __forceinline__ void warp_offer(float& ls, int& li, float s, int i, bool valid, int k, int lane) {
  const unsigned full = 0xffffffffu;
  float ts = __shfl_sync(full, ls, k - 1);
  int ti = __shfl_sync(full, li, k - 1);
  unsigned mask = __ballot_sync(full, valid && better(s, i, ts, ti));
  while (mask) {
    int j = __ffs(mask) - 1;
    mask &= mask - 1;
    float cs = __shfl_sync(full, s, j);
    int ci = __shfl_sync(full, i, j);
    warp_insert(ls, li, cs, ci, k, lane);
  }
}

template <int MODE>
struct Traits;
template <> struct Traits<F32>  { typedef float T; static constexpr int STAGE_BYTES = DS * 4; };
template <> struct Traits<BF16> { typedef __nv_bfloat16 T; static constexpr int STAGE_BYTES = DS * 2; };
template <> struct Traits<INT8> { typedef __nv_bfloat16 T; static constexpr int STAGE_BYTES = DS; };
template <> struct Traits<INT4> { typedef __nv_bfloat16 T; static constexpr int STAGE_BYTES = DS / 2; };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// Unpack one 16-byte vector of a row's stage into depth slots of rs[:, r].
template <int MODE>
__device__ __forceinline__ void unpack_store(float (*rs)[RS_PITCH], int r, int v, uint4 raw) {
  if (MODE == F32) {
    const float* f = reinterpret_cast<const float*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) rs[v * 4 + e][r] = f[e];
  } else if (MODE == BF16) {
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int e = 0; e < 8; ++e) rs[v * 8 + e][r] = __bfloat162float(h[e]);
  } else if (MODE == INT8) {
    const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int e = 0; e < 16; ++e) rs[v * 16 + e][r] = (float)b[e];
  } else {
    // Half-split nibbles: byte b of the row holds column b (low) and column D/2 + b (high).
    // A stage covers DS/2 bytes: its low nibbles go to depth slots [0, DS/2), its high
    // nibbles to [DS/2, DS).
    const uint8_t* b = reinterpret_cast<const uint8_t*>(&raw);
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      rs[v * 16 + e][r] = (float)((int)(b[e] & 0xF) - 8);
      rs[DS / 2 + v * 16 + e][r] = (float)((int)(b[e] >> 4) - 8);
    }
  }
}

template <int MODE>
__global__ void __launch_bounds__(THREADS) topk_scan(
    const typename Traits<MODE>::T* __restrict__ queries, const uint8_t* __restrict__ rows,
    const float* __restrict__ scales, int Q, int N, int D, int num_valid, int k, int chunk_rows,
    float* __restrict__ cand_s, int* __restrict__ cand_i) {
  __shared__ __align__(16) float qs[DS][QS_PITCH];
  __shared__ __align__(16) float rs[DS][RS_PITCH];  // row tile; reused as the score tile
  float (*sc)[RS_PITCH] = rs;                        // sc[q][r], q < QT

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tr = tid & 31;   // rows tr*4 .. tr*4+3 of the tile
  const int tq = tid >> 5;   // queries tq*4 .. tq*4+3 of the tile
  const int chunk = blockIdx.x;
  const int n_chunks = gridDim.x;
  const int q0 = blockIdx.y * QT;
  const int row_begin = chunk * chunk_rows;
  const int row_end = min(row_begin + chunk_rows, N);
  const size_t row_bytes = (MODE == INT4) ? (size_t)D / 2 : (size_t)D * (MODE == F32 ? 4 : (MODE == BF16 ? 2 : 1));
  constexpr int STAGE_BYTES = Traits<MODE>::STAGE_BYTES;
  constexpr int VECS = STAGE_BYTES / 16;  // 16-byte loads per row per stage
  const int n_stages = D / DS;

  // Running top-k of this warp's 4 queries: entry `lane` of each list.
  float ls[4];
  int li[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    ls[j] = -INFINITY;
    li[j] = NO_ID;
  }

  for (int tile0 = row_begin; tile0 < row_end; tile0 += RT) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int s = 0; s < n_stages; ++s) {
      // Query tile: qs[j][q] = query q0+q at the column of depth slot j.
      for (int idx = tid; idx < QT * DS; idx += THREADS) {
        int q = idx / DS, j = idx % DS;
        int col = (MODE == INT4) ? (j < DS / 2 ? s * (DS / 2) + j : D / 2 + s * (DS / 2) + (j - DS / 2))
                                 : s * DS + j;
        float x = 0.f;
        if (q0 + q < Q) x = to_f32(queries[(size_t)(q0 + q) * D + col]);
        qs[j][q] = x;
      }
      // Row tile, converted to f32 and transposed: rs[j][r].
      for (int idx = tid; idx < RT * VECS; idx += THREADS) {
        int r = idx / VECS, v = idx % VECS;
        int row = tile0 + r;
        uint4 raw = make_uint4(0, 0, 0, 0);
        if (row < row_end)
          raw = *reinterpret_cast<const uint4*>(rows + (size_t)row * row_bytes + (size_t)s * STAGE_BYTES + v * 16);
        unpack_store<MODE>(rs, r, v, raw);
      }
      __syncthreads();
#pragma unroll 8
      for (int j = 0; j < DS; ++j) {
        float4 a = *reinterpret_cast<const float4*>(&qs[j][tq * 4]);
        float4 b = *reinterpret_cast<const float4*>(&rs[j][tr * 4]);
        float av[4] = {a.x, a.y, a.z, a.w};
        float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) acc[i][jj] = fmaf(av[i], bv[jj], acc[i][jj]);
      }
      __syncthreads();
    }

    // Score tile into shared memory (per-row scale after the dot, as the reference does).
    float rscale[4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      int row = tile0 + tr * 4 + jj;
      rscale[jj] = (scales != nullptr && row < row_end) ? scales[row] : 1.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float4 o;
      if (scales != nullptr) {
        o = make_float4(acc[i][0] * rscale[0], acc[i][1] * rscale[1], acc[i][2] * rscale[2], acc[i][3] * rscale[3]);
      } else {
        o = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      }
      *reinterpret_cast<float4*>(&sc[tq * 4 + i][tr * 4]) = o;
    }
    __syncthreads();

    // Fold: warp w owns queries 4w .. 4w+3 of the tile.
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int q = warp * 4 + j;
      if (q0 + q >= Q) continue;  // warp-uniform
#pragma unroll
      for (int c = 0; c < RT / 32; ++c) {
        int r = c * 32 + lane;
        int row = tile0 + r;
        warp_offer(ls[j], li[j], sc[q][r], row, row < row_end && row < num_valid, k, lane);
      }
    }
    __syncthreads();  // the next tile overwrites rs/sc
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    int q = q0 + warp * 4 + j;
    if (q < Q && lane < k) {
      size_t o = ((size_t)q * n_chunks + chunk) * k + lane;
      cand_s[o] = ls[j];
      cand_i[o] = li[j];
    }
  }
}

// One warp per query: fold its n_chunks*k candidates into the final top-k.
__global__ void topk_merge(const float* __restrict__ cand_s, const int* __restrict__ cand_i, int Q,
                           int n_cand, int k, float* __restrict__ out_s, int* __restrict__ out_i) {
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * (blockDim.x / 32) + (threadIdx.x >> 5);
  if (q >= Q) return;  // warp-uniform
  float ls = -INFINITY;
  int li = NO_ID;
  const float* cs = cand_s + (size_t)q * n_cand;
  const int* ci = cand_i + (size_t)q * n_cand;
  for (int base = 0; base < n_cand; base += 32) {
    int c = base + lane;
    bool valid = c < n_cand;
    float s = valid ? cs[c] : -INFINITY;
    int i = valid ? ci[c] : NO_ID;
    warp_offer(ls, li, s, i, valid && i != NO_ID, k, lane);
  }
  if (lane < k) {
    out_s[(size_t)q * k + lane] = ls;
    out_i[(size_t)q * k + lane] = (li == NO_ID) ? 0 : li;
  }
}

template <int MODE>
void launch_scan(const void* queries, const void* rows, const void* scales, int Q, int N, int D,
                 int num_valid, int k, int chunk_rows, int n_chunks, float* cand_s, int* cand_i,
                 cudaStream_t stream) {
  dim3 grid(n_chunks, (Q + QT - 1) / QT);
  topk_scan<MODE><<<grid, THREADS, 0, stream>>>(
      reinterpret_cast<const typename Traits<MODE>::T*>(queries), reinterpret_cast<const uint8_t*>(rows),
      reinterpret_cast<const float*>(scales), Q, N, D, num_valid, k, chunk_rows, cand_s, cand_i);
}

}  // namespace

extern "C" {

int dalm_topk_max_k() { return MAX_K; }
int dalm_topk_rows_per_tile() { return RT; }
int dalm_topk_depth_multiple() { return DS; }

// mode: 0 f32 rows + f32 queries; 1 bf16 rows; 2 int8 rows; 3 int4 half-split rows
// (modes 1-3 take bf16 queries; 2-3 take f32 per-row scales). chunk_rows must be a multiple
// of the tile's 128 rows, D a multiple of 64, 1 <= k <= 32. Candidate buffers hold
// Q * ceil(N / chunk_rows) * k entries. Returns the CUDA error of the launches (0 = ok).
int dalm_topk_launch(int mode, const void* queries, const void* rows, const void* scales, int Q, int N,
                     int D, int num_valid, int k, int chunk_rows, void* cand_s, void* cand_i,
                     void* out_s, void* out_i, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  if (k < 1 || k > MAX_K || D % DS != 0 || chunk_rows % RT != 0 || Q < 1 || N < 1)
    return (int)cudaErrorInvalidValue;
  int n_chunks = (N + chunk_rows - 1) / chunk_rows;
  float* cs = reinterpret_cast<float*>(cand_s);
  int* ci = reinterpret_cast<int*>(cand_i);
  switch (mode) {
    case F32:  launch_scan<F32>(queries, rows, nullptr, Q, N, D, num_valid, k, chunk_rows, n_chunks, cs, ci, stream); break;
    case BF16: launch_scan<BF16>(queries, rows, nullptr, Q, N, D, num_valid, k, chunk_rows, n_chunks, cs, ci, stream); break;
    case INT8: launch_scan<INT8>(queries, rows, scales, Q, N, D, num_valid, k, chunk_rows, n_chunks, cs, ci, stream); break;
    case INT4: launch_scan<INT4>(queries, rows, scales, Q, N, D, num_valid, k, chunk_rows, n_chunks, cs, ci, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int warps = 4;
  topk_merge<<<(Q + warps - 1) / warps, warps * 32, 0, stream>>>(
      cs, ci, Q, n_chunks * k, k, reinterpret_cast<float*>(out_s), reinterpret_cast<int*>(out_i));
  return (int)cudaGetLastError();
}

}  // extern "C"
