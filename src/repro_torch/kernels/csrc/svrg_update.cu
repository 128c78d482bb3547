// Fused variance-reduced prox step for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/svrg_update.py:svrg_update (the Pallas TPU
// kernel, def :35 / pl.pallas_call :50). Same function, elementwise over
// five vectors of length n:
//
//     out = x - eta * (g_x - g_z + mu + gamma * (x - w))
//
// It is the update of every step of MP-DSVRG's without-replacement pass
// (Algorithm 1 step 2), on parameter-sized vectors.
//
// What bounds it on the H100: bytes. Five reads and one write per element
// (24 bytes in float32) against 7 flops, far below any ridge point: at
// n = 2^20 float32 the bound is 25.2 MB / 3.35 TB/s = 7.5 us.
//
// Design: one pass, no padding copy (the TPU kernel pads to 256 lanes and
// streams (512, 256) tiles; here blocks stride over the vectors instead).
// Where all six pointers are 16-byte aligned, each thread moves 16 bytes
// per operand per load and store (4 float32 or 8 bf16 / f16 elements); the
// tail past the last whole vector, and every element of a view that is not
// aligned, take a scalar path. The arithmetic is float32 with one rounding
// to the output dtype at the store. Each product and sum is rounded on its
// own (__fmul_rn / __fadd_rn / __fsub_rn: no fused multiply-add) in the
// order kernels/ref.py:svrg_update_ref evaluates them, so the kernel gives
// its twin's bits.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
// Enough blocks to fill 132 SMs several times; a grid-stride loop covers
// the rest.
constexpr int MAX_BLOCKS = 132 * 8;

template <typename T>
struct alignas(16) Vec16 {
  T v[16 / sizeof(T)];
};

__device__ __forceinline__ float step(float x, float gx, float gz, float mu,
                                      float w, float eta, float gamma) {
  float g = __fsub_rn(gx, gz);
  g = __fadd_rn(g, mu);
  g = __fadd_rn(g, __fmul_rn(gamma, __fsub_rn(x, w)));
  return __fsub_rn(x, __fmul_rn(eta, g));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    svrg_update_kernel(const T* __restrict__ x, const T* __restrict__ gx,
                       const T* __restrict__ gz, const T* __restrict__ mu,
                       const T* __restrict__ w, T* __restrict__ out,
                       long long n, int aligned, float eta, float gamma) {
  using V = Vec16<T>;
  constexpr int E = sizeof(V) / sizeof(T);
  const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long stride = (long long)gridDim.x * THREADS;
  const long long n_vec = aligned ? n / E : 0;
  for (long long i = tid; i < n_vec; i += stride) {
    const V a = reinterpret_cast<const V*>(x)[i];
    const V b = reinterpret_cast<const V*>(gx)[i];
    const V c = reinterpret_cast<const V*>(gz)[i];
    const V d = reinterpret_cast<const V*>(mu)[i];
    const V e = reinterpret_cast<const V*>(w)[i];
    V o;
#pragma unroll
    for (int j = 0; j < E; ++j)
      o.v[j] = rt::from_f<T>(step(rt::to_f(a.v[j]), rt::to_f(b.v[j]),
                                  rt::to_f(c.v[j]), rt::to_f(d.v[j]),
                                  rt::to_f(e.v[j]), eta, gamma));
    reinterpret_cast<V*>(out)[i] = o;
  }
  for (long long i = n_vec * E + tid; i < n; i += stride)
    out[i] = rt::from_f<T>(step(rt::to_f(x[i]), rt::to_f(gx[i]),
                                rt::to_f(gz[i]), rt::to_f(mu[i]),
                                rt::to_f(w[i]), eta, gamma));
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
cudaError_t launch(const void* x, const void* gx, const void* gz,
                   const void* mu, const void* w, void* out, long long n,
                   float eta, float gamma, cudaStream_t stream) {
  const int aligned = aligned16(x) && aligned16(gx) && aligned16(gz) &&
                      aligned16(mu) && aligned16(w) && aligned16(out);
  constexpr long long E = 16 / sizeof(T);
  const long long items = aligned ? (n + E - 1) / E : n;
  const long long want = (items + THREADS - 1) / THREADS;
  const int blocks = (int)(want < MAX_BLOCKS ? want : MAX_BLOCKS);
  svrg_update_kernel<T><<<blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(gx),
      static_cast<const T*>(gz), static_cast<const T*>(mu),
      static_cast<const T*>(w), static_cast<T*>(out), n, aligned, eta,
      gamma);
  return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success). x, g_x, g_z, mu, w
// and out: n elements each of one dtype, contiguous, checked by the Python
// wrapper; n > 0.
extern "C" int svrg_update(const void* x, const void* g_x, const void* g_z,
                           const void* mu, const void* w, void* out,
                           int dtype, long long n, float eta, float gamma,
                           void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case rt::F32:
      return launch<float>(x, g_x, g_z, mu, w, out, n, eta, gamma, st);
    case rt::BF16:
      return launch<__nv_bfloat16>(x, g_x, g_z, mu, w, out, n, eta, gamma,
                                   st);
    case rt::F16:
      return launch<__half>(x, g_x, g_z, mu, w, out, n, eta, gamma, st);
  }
  return cudaErrorInvalidValue;
}
