// Blocked GQA flash attention (forward) for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py:flash_attention (the
// Pallas TPU kernel, def :71 / pl.pallas_call :88). Same function: q
// (B, H, Sq, hd) attends to k/v (B, KV, Sk, hd) of KV head h // (H / KV),
// causal (key index <= query index) or not, with an online softmax; the
// (Sq, Sk) score matrix never reaches device memory. It also takes the JAX
// model's local-attention `window` (models/attention.py:
// chunked_causal_attention): with window > 0, key u is visible to query i
// only when u > i - window. The TPU kernel has no window; recurrentgemma's
// attn_local layers need it.
//
// What bounds it on the H100: operations. Attention over S tokens does
// ~4 * S^2 * hd flops (halved by the causal skip; S * window under a
// window) on 2 * S * hd * (1 + 2 / group) elements, so for S in the
// hundreds it sits at or above the bf16 ridge. This first version does its
// dot products on the CUDA cores in float32 (67 TFLOP/s), well below the
// 989 TFLOP/s tensor-core peak the bound is stated against; wgmma tiles are
// a later change.
//
// Design: one block per (b, h, q-tile of BQ rows). Each query row belongs
// to SPLIT neighbouring threads of one warp, each holding DPT = hd / SPLIT
// of its dims (q and acc in float32 registers, interleaved in float4 steps
// so the group's shared-memory reads are conflict-free): SPLIT = 1 up to
// hd 64, 2 at hd 80 (40 dims a thread) and hd 128, 4 at hd 256. A key's
// score is the group's partial dots summed with warp shuffles. K/V tiles
// of TK keys are staged in shared memory as float32 and read by every row
// of the tile: TK = 32 up to hd 128 and 16 at hd 256, so the two tiles stay
// at 32 KiB,
// inside the 48 KiB of static shared memory. A loop over key tiles replaces
// the TPU kernel's sequential key axis; under `causal` tiles strictly above
// the q-tile's diagonal are skipped, and under a window so are tiles wholly
// left of the q-tile's first window.

#include "common.cuh"

namespace {

// Query rows per block.
constexpr int BQ = 64;

// Threads per query row: each holds HD / split<HD>() dims, a multiple of 4
// and at most 64.
template <int HD>
__host__ __device__ constexpr int split() {
  return HD <= 64 ? 1 : HD <= 128 ? 2 : HD / 64;
}

template <typename T, int HD>
__global__ void __launch_bounds__(BQ * split<HD>())
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           int H, int KV, int Sq, int Sk, int causal,
                           int window, float scale) {
  constexpr int SPLIT = split<HD>();      // threads per query row
  constexpr int DPT = HD / SPLIT;         // head dims each thread holds
  static_assert(DPT % 4 == 0 && DPT <= 64 && DPT * SPLIT == HD, "head dim");
  constexpr int NT = BQ * SPLIT;          // threads per block
  constexpr int TK = HD >= 256 ? 16 : rt::TK;
  constexpr int C4 = DPT / 4;             // float4 steps per thread
  __shared__ __align__(16) float Ks[TK * HD];
  __shared__ __align__(16) float Vs[TK * HD];
  const int b = blockIdx.x, h = blockIdx.y;
  const int part = threadIdx.x % SPLIT;
  const int q0 = blockIdx.z * BQ;
  const int i = q0 + threadIdx.x / SPLIT;  // query index
  const bool active = i < Sq;
  const int kvh = h / (H / KV);
  // lanes of this row's group, for the shuffles
  const int lane = threadIdx.x & 31;
  const unsigned gmask = SPLIT == 1
      ? 1u << lane
      : ((1u << SPLIT) - 1u) << (lane & ~(SPLIT - 1));

  // this thread's dims: float4 step c covers dims 4 * (c * SPLIT + part) ..
  float qr[DPT], acc[DPT];
  float m = rt::NEG_INF, l = 0.f;
  const T* qrow = q + (((size_t)b * H + h) * Sq + i) * HD;
#pragma unroll
  for (int c = 0; c < C4; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 4 * (c * SPLIT + part) + e;
      acc[4 * c + e] = 0.f;
      qr[4 * c + e] = active ? rt::to_f(qrow[d]) : 0.f;
    }
  }

  const size_t kv_base = ((size_t)b * KV + kvh) * Sk * HD;
  const int k_end = causal ? min(Sk, q0 + BQ) : Sk;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int u0 = k_lo / TK * TK; u0 < k_end; u0 += TK) {
    for (int e = threadIdx.x; e < TK * HD; e += NT) {
      const bool in = u0 + e / HD < k_end;
      Ks[e] = in ? rt::to_f(k[kv_base + (size_t)u0 * HD + e]) : 0.f;
      Vs[e] = in ? rt::to_f(v[kv_base + (size_t)u0 * HD + e]) : 0.f;
    }
    __syncthreads();
#pragma unroll 1
    for (int j = 0; j < TK; ++j) {
      const int u = u0 + j;
      const float4* k4 = reinterpret_cast<const float4*>(Ks + j * HD);
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < C4; ++c) {
        const float4 x = k4[c * SPLIT + part];
        dot += qr[4 * c] * x.x + qr[4 * c + 1] * x.y + qr[4 * c + 2] * x.z +
               qr[4 * c + 3] * x.w;
      }
#pragma unroll
      for (int o = 1; o < SPLIT; o <<= 1)
        dot += __shfl_xor_sync(gmask, dot, o);
      const bool valid = active && u < k_end && (!causal || u <= i) &&
                         (window <= 0 || u > i - window);
      if (!valid) continue;
      const float s = dot * scale;
      if (s > m) {
        const float alpha = expf(m - s);
        l *= alpha;
#pragma unroll
        for (int d = 0; d < DPT; ++d) acc[d] *= alpha;
        m = s;
      }
      const float p = expf(s - m);
      l += p;
      const float4* v4 = reinterpret_cast<const float4*>(Vs + j * HD);
#pragma unroll
      for (int c = 0; c < C4; ++c) {
        const float4 x = v4[c * SPLIT + part];
        acc[4 * c] += p * x.x;
        acc[4 * c + 1] += p * x.y;
        acc[4 * c + 2] += p * x.z;
        acc[4 * c + 3] += p * x.w;
      }
    }
    __syncthreads();
  }

  if (active) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    T* o = out + (((size_t)b * H + h) * Sq + i) * HD;
#pragma unroll
    for (int c = 0; c < C4; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[4 * (c * SPLIT + part) + e] = rt::from_f<T>(acc[4 * c + e] * inv);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int H, int KV, int Sq, int Sk, int causal,
                   int window, float scale, cudaStream_t stream) {
  dim3 grid(B, H, (Sq + BQ - 1) / BQ);
  flash_attention_kernel<T, HD><<<grid, BQ * split<HD>(), 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), H, KV, Sq, Sk, causal,
      window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_hd(int hd, const void* q, const void* k, const void* v,
                  void* out, int B, int H, int KV, int Sq, int Sk, int causal,
                  int window, float scale, cudaStream_t stream) {
  if (hd == 16)
    return launch<T, 16>(q, k, v, out, B, H, KV, Sq, Sk, causal, window,
                         scale, stream);
  if (hd == 64)
    return launch<T, 64>(q, k, v, out, B, H, KV, Sq, Sk, causal, window,
                         scale, stream);
  if (hd == 80)
    return launch<T, 80>(q, k, v, out, B, H, KV, Sq, Sk, causal, window,
                         scale, stream);
  if (hd == 128)
    return launch<T, 128>(q, k, v, out, B, H, KV, Sq, Sk, causal, window,
                          scale, stream);
  if (hd == 256)
    return launch<T, 256>(q, k, v, out, B, H, KV, Sq, Sk, causal, window,
                          scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success). Shapes: q/out
// (B, H, Sq, hd); k/v (B, KV, Sk, hd), all one dtype and contiguous,
// checked by the Python wrapper. window <= 0: no window.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int dtype, int B, int H, int KV,
                               int Sq, int Sk, int hd, int causal, int window,
                               float scale, void* stream) {
  if (H % KV != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case rt::F32:
      return by_hd<float>(hd, q, k, v, out, B, H, KV, Sq, Sk, causal, window,
                          scale, st);
    case rt::BF16:
      return by_hd<__nv_bfloat16>(hd, q, k, v, out, B, H, KV, Sq, Sk, causal,
                                  window, scale, st);
    case rt::F16:
      return by_hd<__half>(hd, q, k, v, out, B, H, KV, Sq, Sk, causal,
                           window, scale, st);
  }
  return cudaErrorInvalidValue;
}
