// What K4's kernels share: the argument block (mirrored by a ctypes.Structure in
// kernels/flash_attention.py), the mask and its tile classes, and the 4-lane
// row reductions of the accumulator layouts (mma.sync m16n8 and wgmma m64nN
// both give a row to the 4 lanes of a quad). Included by csrc/flash_attention.cu
// (the mma.sync forward and backward), csrc/flash_fwd_wgmma.cu (the forward on
// wgmma) and csrc/flash_bwd_wgmma.cu (the backward on wgmma, the dsum pre-pass).
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -1e30f;
// Every field is 8 bytes wide so that the ctypes mirror has no padding to get wrong.
struct Args {
    const void* q; const void* k; const void* v; void* out;
    const void* dout; void* dq; void* dk; void* dv;
    float* lse; const float* dsum; const int* seg_q; const int* seg_k;
    // strides in elements: batch, head, sequence (the last axis has stride 1)
    long long q_sb, q_sh, q_ss;
    long long k_sb, k_sh, k_ss;
    long long v_sb, v_sh, v_ss;
    long long o_sb, o_sh, o_ss;
    long long do_sb, do_sh, do_ss;
    long long dq_sb, dq_sh, dq_ss;
    long long dk_sb, dk_sh, dk_ss;
    long long dv_sb, dv_sh, dv_ss;
    long long B, H, Hk, Sq, Sk, D;
    long long q_offset, window, causal, is_bf16;  // window <= 0: none
    double scale, softcap;                        // softcap <= 0: none
};

// What the kernels read at every element, narrowed once.
struct Mask {
    int Sq, Sk, q_offset, window;
    bool causal, has_seg;
};

__device__ __forceinline__ Mask make_mask(const Args& a) {
    Mask m;
    m.Sq = (int)a.Sq; m.Sk = (int)a.Sk; m.q_offset = (int)a.q_offset; m.window = (int)a.window;
    m.causal = a.causal != 0; m.has_seg = a.seg_q != nullptr;
    return m;
}

// Element (query qi, key kj) is attended to. Rows and keys past the end never are.
__device__ __forceinline__ bool keep_at(const Mask& m, int qi, int kj, int sq, int sk) {
    bool keep = (qi < m.Sq) && (kj < m.Sk);
    const int gq = m.q_offset + qi;
    if (m.causal) keep = keep && (gq >= kj);
    if (m.window > 0) keep = keep && (gq - kj < m.window);
    if (m.has_seg) keep = keep && (sq == sk);
    return keep;
}

// False when every element of queries [q0, q0 + qn) x keys [k0, k0 + kn) is masked
// by causality or the window band (segments are not looked at).
__device__ __forceinline__ bool tile_visible(const Mask& m, int q0, int qn, int k0, int kn) {
    const int first_q = m.q_offset + q0, last_q = first_q + qn - 1;
    if (m.causal && last_q < k0) return false;
    if (m.window > 0 && first_q - (k0 + kn - 1) >= m.window) return false;
    return true;
}

// True when NO element of queries [q0, q0 + qn) x keys [k0, k0 + kn) is masked by the
// ragged edge, causality or the window band: such a tile needs no per-element test
// (segments are the caller's to check).
__device__ __forceinline__ bool tile_full(const Mask& m, int q0, int qn, int k0, int kn) {
    if (q0 + qn > m.Sq || k0 + kn > m.Sk) return false;
    const int first_q = m.q_offset + q0, last_q = first_q + qn - 1;
    if (m.causal && first_q < k0 + kn - 1) return false;
    if (m.window > 0 && last_q - k0 >= m.window) return false;
    return true;
}

__device__ __forceinline__ float quad_max(float v) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

}  // namespace
