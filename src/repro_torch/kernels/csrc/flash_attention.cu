// Blocked GQA flash attention (forward) for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py:flash_attention (the
// Pallas TPU kernel, def :71 / pl.pallas_call :88). Same function: q
// (B, H, Sq, hd) attends to k/v (B, KV, Sk, hd) of KV head h // (H / KV),
// causal (key index <= query index) or not, with an online softmax; the
// (Sq, Sk) score matrix never reaches device memory.
//
// What bounds it on the H100: operations. Attention over S tokens does
// ~4 * S^2 * hd flops (halved by the causal skip) on 2 * S * hd * (1 + 2 /
// group) elements, so for S in the hundreds it sits at or above the bf16
// ridge. This first version does its dot products on the CUDA cores in
// float32 (67 TFLOP/s), well below the 989 TFLOP/s tensor-core peak the
// bound is stated against; wgmma tiles are a later change.
//
// Design: one block per (b, h, q-tile of BQ rows), one thread per query row
// (q and acc in float32 registers). K/V tiles of TK keys are staged in
// shared memory as float32 and read by every row of the tile; a loop over
// key tiles replaces the TPU kernel's sequential key axis, and under
// `causal` tiles strictly above the q-tile's diagonal are skipped.

#include "common.cuh"

namespace {

// Query rows per block, one thread each.
constexpr int BQ = 64;

template <typename T, int HD>
__global__ void flash_attention_kernel(const T* __restrict__ q,
                                       const T* __restrict__ k,
                                       const T* __restrict__ v,
                                       T* __restrict__ out, int H, int KV,
                                       int Sq, int Sk, int causal,
                                       float scale) {
  using rt::TK;
  __shared__ __align__(16) float Ks[TK * HD];
  __shared__ __align__(16) float Vs[TK * HD];
  const int b = blockIdx.x, h = blockIdx.y;
  const int i = blockIdx.z * BQ + threadIdx.x;  // query index
  const bool active = i < Sq;
  const int kvh = h / (H / KV);

  float qr[HD], acc[HD];
  float m = rt::NEG_INF, l = 0.f;
  const T* qrow = q + (((size_t)b * H + h) * Sq + i) * HD;
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    acc[d] = 0.f;
    qr[d] = active ? rt::to_f(qrow[d]) : 0.f;
  }

  const size_t kv_base = ((size_t)b * KV + kvh) * Sk * HD;
  const int k_end = causal ? min(Sk, (int)blockIdx.z * BQ + BQ) : Sk;
  for (int u0 = 0; u0 < k_end; u0 += TK) {
    for (int e = threadIdx.x; e < TK * HD; e += BQ) {
      const int u = u0 + e / HD;
      const bool in = u < k_end;
      Ks[e] = in ? rt::to_f(k[kv_base + (size_t)u0 * HD + e]) : 0.f;
      Vs[e] = in ? rt::to_f(v[kv_base + (size_t)u0 * HD + e]) : 0.f;
    }
    __syncthreads();
    if (active) {
      auto valid = [&](int j) {
        const int u = u0 + j;
        return u < k_end && (!causal || u <= i);
      };
#pragma unroll 1
      for (int j = 0; j < TK; ++j)
        if (valid(j))
          rt::fold_key<HD>(qr, Ks + j * HD, Vs + j * HD, scale, m, l, acc);
    }
    __syncthreads();
  }

  if (active) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    T* o = out + (((size_t)b * H + h) * Sq + i) * HD;
#pragma unroll
    for (int d = 0; d < HD; ++d) o[d] = rt::from_f<T>(acc[d] * inv);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int H, int KV, int Sq, int Sk, int causal,
                   float scale, cudaStream_t stream) {
  dim3 grid(B, H, (Sq + BQ - 1) / BQ);
  flash_attention_kernel<T, HD><<<grid, BQ, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), H, KV, Sq, Sk, causal,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_hd(int hd, const void* q, const void* k, const void* v,
                  void* out, int B, int H, int KV, int Sq, int Sk, int causal,
                  float scale, cudaStream_t stream) {
  if (hd == 64)
    return launch<T, 64>(q, k, v, out, B, H, KV, Sq, Sk, causal, scale,
                         stream);
  if (hd == 128)
    return launch<T, 128>(q, k, v, out, B, H, KV, Sq, Sk, causal, scale,
                          stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success). Shapes: q/out
// (B, H, Sq, hd); k/v (B, KV, Sk, hd), all one dtype and contiguous,
// checked by the Python wrapper.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int dtype, int B, int H, int KV,
                               int Sq, int Sk, int hd, int causal,
                               float scale, void* stream) {
  if (H % KV != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case rt::F32:
      return by_hd<float>(hd, q, k, v, out, B, H, KV, Sq, Sk, causal, scale,
                          st);
    case rt::BF16:
      return by_hd<__nv_bfloat16>(hd, q, k, v, out, B, H, KV, Sq, Sk, causal,
                                  scale, st);
    case rt::F16:
      return by_hd<__half>(hd, q, k, v, out, B, H, KV, Sq, Sk, causal, scale,
                           st);
  }
  return cudaErrorInvalidValue;
}
