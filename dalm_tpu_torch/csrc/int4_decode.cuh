// The 4-bit decode that csrc/int4_matmul.cu and csrc/int4_prefill.cu share.
#pragma once

#include <stdint.h>

// The same f32 values as models/quant.py NF4_CODEBOOK.
__device__ const float kNF4[16] = {
    -1.0f, -0.6961928009986877f, -0.5250730514526367f, -0.39491748809814453f,
    -0.28444138169288635f, -0.18477343022823334f, -0.09105003625154495f, 0.0f,
    0.07958029955625534f, 0.16093020141124725f, 0.24611230194568634f,
    0.33791524171829224f, 0.44070982933044434f, 0.5626170039176941f,
    0.7229568362236023f, 1.0f,
};

// The two values of one packed byte of q4 before their scales. The half-split
// layout of models/quant.py: packed row r holds K-row r in the low nibble and
// K-row K/2 + r in the high one. int4 decodes a nibble as nib - 8, nf4 through
// the codebook cb (kNF4 copied to shared memory; unread for int4).
template <bool NF4>
__device__ __forceinline__ void decode_pair(uint32_t byte, const float* cb, float& lo, float& hi) {
    const uint32_t l = byte & 0xF, h = (byte >> 4) & 0xF;
    lo = NF4 ? cb[l] : (float)((int)l - 8);
    hi = NF4 ? cb[h] : (float)((int)h - 8);
}
