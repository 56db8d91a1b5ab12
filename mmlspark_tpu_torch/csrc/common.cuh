// Shared helpers for the port's hand-written Hopper kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mmlspark {

// The masked-score sentinel of the JAX package (ops/attention.py NEG_INF):
// masked entries carry exactly this value and get exactly zero weight.
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(int8_t x) { return static_cast<float>(x); }

// exp(x - safe_max) with the fully-masked guards of the JAX kernels' fold:
// a NEG_INF entry contributes exactly 0.
__device__ __forceinline__ float masked_exp(float x, float safe_max) {
  return x == NEG_INF ? 0.f : expf(x - safe_max);
}

__device__ __forceinline__ float safe_max(float m) { return m == NEG_INF ? 0.f : m; }

}  // namespace mmlspark
