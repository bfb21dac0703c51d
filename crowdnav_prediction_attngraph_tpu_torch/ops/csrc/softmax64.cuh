// Device helpers shared by the port's kernels K1 and K2.
#pragma once

#include <cuda_bf16.h>
#include <math.h>

namespace {

// v rounded to bf16 and back when bf16 != 0, else v.
__device__ __forceinline__ float round_to(float v, int bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16(v)) : v;
}

// Masked softmax of one query's logits row[0..A), A <= 64, in place, by one
// warp: lane owns keys lane and lane + 32. A key whose valid byte is 0 gets
// weight 0; a row with no valid key (any_valid == 0) gets 0 everywhere. The
// weights are rounded to bf16 when bf16 != 0.
__device__ __forceinline__ void warp_masked_softmax64(float* row,
                                                      const unsigned char* valid,
                                                      int A, int any_valid,
                                                      int bf16) {
  const int lane = threadIdx.x & 31;
  float s[2], e[2];
  float m = -INFINITY;
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int j = lane + 32 * t;
    s[t] = (j < A && valid[j]) ? row[j] : -INFINITY;
    m = fmaxf(m, s[t]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  float sum = 0.f;
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int j = lane + 32 * t;
    e[t] = (j < A && valid[j]) ? expf(s[t] - m) : 0.f;
    sum += e[t];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int j = lane + 32 * t;
    if (j < A) row[j] = any_valid ? round_to(e[t] / sum, bf16) : 0.f;
  }
}

}  // namespace
