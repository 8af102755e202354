// Helpers shared by the port's attention kernels: element conversions,
// warp reductions and the online-softmax row update.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace qaig {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int offset = 16; offset > 0; offset >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, offset));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int offset = 16; offset > 0; offset >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, offset);
  return x;
}

// Online-softmax update of `rows` score rows held in shared memory
// (row r at scores + r * pitch, columns [0, ncols) live, masked entries
// -inf).  One warp per row: the running max m[r] and denominator l[r]
// advance, alpha[r] receives the factor the caller rescales its
// accumulator by, and each score is replaced by its probability
// exp(s - m).  With `prob_scale` (int8 V scales), the stored probability
// is additionally multiplied by prob_scale[c]; the denominator sums the
// unscaled probabilities.  The caller synchronises before and after.
__device__ __forceinline__ void softmax_update(float* scores, int pitch,
                                               int ncols, int rows,
                                               float* m, float* l,
                                               float* alpha,
                                               const float* prob_scale) {
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int r = threadIdx.x >> 5; r < rows; r += nwarps) {
    float* row = scores + r * pitch;
    float mx = -INFINITY;
    for (int c = lane; c < ncols; c += 32) mx = fmaxf(mx, row[c]);
    mx = warp_max(mx);
    const float m_old = m[r];
    const float m_new = fmaxf(m_old, mx);
    // a row with no live key so far keeps p = 0 instead of exp(-inf + inf)
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    float sum = 0.f;
    for (int c = lane; c < ncols; c += 32) {
      const float p = expf(row[c] - m_use);
      sum += p;
      row[c] = prob_scale ? p * prob_scale[c] : p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      const float a = expf(m_old - m_use);
      alpha[r] = a;
      l[r] = l[r] * a + sum;
      m[r] = m_new;
    }
  }
}

}  // namespace qaig
