// Device copies of the shift-3 Stirling-series lgamma / digamma used by the
// NB likelihood kernels (the same series as ops/special.py, which is the
// plain PyTorch version the kernels are held against).  CUDA's lgammaf is
// not used: the kernels must compute the same function as the plain path.
#pragma once

#include <cuda_runtime.h>

namespace scvae {

constexpr float kHalfLog2Pi = 0.91893853320467274178f;  // 0.5 * log(2*pi)
constexpr int kShift = 3;

__device__ __forceinline__ float series_lgamma(float x) {
  float shift_log = 0.0f;
#pragma unroll
  for (int k = 0; k < kShift; ++k) shift_log += logf(x + (float)k);
  const float z = x + (float)kShift;
  const float inv = 1.0f / z;
  const float inv2 = inv * inv;
  const float series =
      inv * (1.0f / 12.0f + inv2 * (-1.0f / 360.0f + inv2 * (1.0f / 1260.0f)));
  const float stirling = (z - 0.5f) * logf(z) - z + kHalfLog2Pi + series;
  return stirling - shift_log;
}

__device__ __forceinline__ float series_digamma(float x) {
  float shift_sum = 0.0f;
#pragma unroll
  for (int k = 0; k < kShift; ++k) shift_sum += 1.0f / (x + (float)k);
  const float z = x + (float)kShift;
  const float inv = 1.0f / z;
  const float inv2 = inv * inv;
  const float series =
      inv2 * (-1.0f / 12.0f + inv2 * (1.0f / 120.0f + inv2 * (-1.0f / 252.0f)));
  return logf(z) - 0.5f * inv + series - shift_sum;
}

}  // namespace scvae
