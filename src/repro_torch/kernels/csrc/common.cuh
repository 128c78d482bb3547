// Shared helpers for the port's attention kernels (sm_90a, built with nvcc
// into plain-C shared libraries and bound with ctypes; see kernels/build.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

// Masked-score sentinel, the same finite value the JAX kernels use.
constexpr float NEG_INF = -1e30f;

// dtype codes shared with kernels/build.py:DTYPE_CODES
enum DType : int { F32 = 0, BF16 = 1, F16 = 2, I8 = 3, FP8_E4M3 = 4 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_f(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half(x);
}

// Keys per shared-memory tile in the thread-per-query-row kernels.
constexpr int TK = 32;

// One thread owns one query row (q and acc in registers) and folds one key
// (k, v: HD floats in shared memory, 16-byte aligned) into its online
// softmax state. acc and l are rescaled only when the running max grows.
// Callers skip masked keys entirely: their K/V are never read, so stale or
// non-finite pool contents cannot leak into the result.
template <int HD>
__device__ __forceinline__ void fold_key(const float (&q)[HD],
                                         const float* __restrict__ k,
                                         const float* __restrict__ v,
                                         float scale, float& m, float& l,
                                         float (&acc)[HD]) {
  const float4* k4 = reinterpret_cast<const float4*>(k);
  float dot = 0.f;
#pragma unroll
  for (int c = 0; c < HD / 4; ++c) {
    const float4 x = k4[c];
    dot += q[4 * c] * x.x + q[4 * c + 1] * x.y + q[4 * c + 2] * x.z +
           q[4 * c + 3] * x.w;
  }
  const float s = dot * scale;
  if (s > m) {
    const float alpha = expf(m - s);
    l *= alpha;
#pragma unroll
    for (int d = 0; d < HD; ++d) acc[d] *= alpha;
    m = s;
  }
  const float p = expf(s - m);
  l += p;
  const float4* v4 = reinterpret_cast<const float4*>(v);
#pragma unroll
  for (int c = 0; c < HD / 4; ++c) {
    const float4 x = v4[c];
    acc[4 * c] += p * x.x;
    acc[4 * c + 1] += p * x.y;
    acc[4 * c + 2] += p * x.z;
    acc[4 * c + 3] += p * x.w;
  }
}

}  // namespace rt
