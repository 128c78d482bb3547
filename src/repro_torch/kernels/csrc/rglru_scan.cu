// RG-LRU gated linear recurrence for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/rglru_scan.py:rglru_scan (the Pallas TPU
// kernel, def :44 / pl.pallas_call :57). Same function, independent per
// channel, with a float32 state:
//
//     h_t = a_t * h_{t-1} + x_t,   h_{-1} = h0 (zeros when null)
//
// over a, x (B, T, C); it writes every h_t to h_seq (B, T, C) in x's dtype
// and the last state to h_T (B, C) in float32. It is the scan of every
// RG-LRU layer of recurrentgemma (models/recurrent.py:rglru_block_seq): T
// = the prompt in lm.forward / lm.prefill, T = 1 in each decode step.
//
// What bounds it on the H100: bytes. Two reads and one write per element
// against 2 flops, far below any ridge point: at (2, 512, 2560) float32
// the bound is 31.5 MB / 3.35 TB/s = 9.4 us. The time axis is sequential,
// so only B * C threads exist (5120 at that shape); each thread keeps many
// loads in flight instead of relying on occupancy.
//
// Design: one thread per (b, c), walking T in order with the state in a
// register (the TPU kernel's (Tc, Cb) VMEM tiles and scratch state have no
// counterpart: nothing carries between blocks). Neighbouring threads own
// neighbouring channels, so every load and store of a time step is
// coalesced along C. The walk loads CHUNK steps of a and x before it uses
// them, so a thread has 2 * CHUNK loads in flight. Each step is a float32
// multiply and a float32 add rounded on their own (__fmul_rn / __fadd_rn:
// no fused multiply-add), which is what kernels/ref.py:rglru_scan_ref
// computes, so kernel and twin give the same bits.

#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int CHUNK = 8;  // time steps loaded ahead of their use

template <typename T>
__global__ void __launch_bounds__(THREADS)
    rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ x,
                      const float* __restrict__ h0, T* __restrict__ h_seq,
                      float* __restrict__ h_T, int B, int Tn, int C) {
  const long long id = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (id >= (long long)B * C) return;
  const long long b = id / C, c = id % C;
  const size_t base = (size_t)b * Tn * C + c;
  float h = h0 != nullptr ? h0[id] : 0.f;
  int t = 0;
  for (; t + CHUNK <= Tn; t += CHUNK) {
    float av[CHUNK], xv[CHUNK];
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      const size_t i = base + (size_t)(t + j) * C;
      av[j] = rt::to_f(a[i]);
      xv[j] = rt::to_f(x[i]);
    }
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      h = __fadd_rn(__fmul_rn(av[j], h), xv[j]);
      h_seq[base + (size_t)(t + j) * C] = rt::from_f<T>(h);
    }
  }
  for (; t < Tn; ++t) {
    const size_t i = base + (size_t)t * C;
    h = __fadd_rn(__fmul_rn(rt::to_f(a[i]), h), rt::to_f(x[i]));
    h_seq[i] = rt::from_f<T>(h);
  }
  h_T[id] = h;
}

template <typename T>
cudaError_t launch(const void* a, const void* x, const float* h0,
                   void* h_seq, float* h_T, int B, int Tn, int C,
                   cudaStream_t stream) {
  const long long n = (long long)B * C;
  const int blocks = (int)((n + THREADS - 1) / THREADS);
  rglru_scan_kernel<T><<<blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(x), h0,
      static_cast<T*>(h_seq), h_T, B, Tn, C);
  return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success). a, x, h_seq:
// (B, T, C) of one dtype; h0 (B, C) float32 or null; h_T (B, C) float32.
// All contiguous, checked by the Python wrapper; B * C > 0.
extern "C" int rglru_scan(const void* a, const void* x, const void* h0,
                          void* h_seq, void* h_T, int dtype, int B, int T,
                          int C, void* stream) {
  if (B <= 0 || C <= 0 || T < 0) return cudaErrorInvalidValue;
  const float* h0f = static_cast<const float*>(h0);
  float* hT = static_cast<float*>(h_T);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case rt::F32:
      return launch<float>(a, x, h0f, h_seq, hT, B, T, C, st);
    case rt::BF16:
      return launch<__nv_bfloat16>(a, x, h0f, h_seq, hT, B, T, C, st);
    case rt::F16:
      return launch<__half>(a, x, h0f, h_seq, hT, B, T, C, st);
  }
  return cudaErrorInvalidValue;
}
