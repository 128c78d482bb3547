// The gradient of the RG-LRU scan for Hopper (sm_90a).
//
// Replaces no TPU kernel: src/repro/kernels/rglru_scan.py (the Pallas
// kernel, def :44 / pl.pallas_call :57) is forward only, and the JAX model
// differentiates its lax.scan (src/repro/models/recurrent.py:283). This
// kernel is the backward of csrc/rglru_scan.cu, launched by the autograd
// Function of kernels/rglru_scan.py when recurrentgemma-2b trains. The
// forward h_t = a_t h_{t-1} + x_t (h_{-1} = h0) gives, with g_t = dL/dh_t
// in total,
//
//     g_t  = dh_seq_t + c_t,   c_{T-1} = dh_T,   c_{t-1} = a_t g_t
//     dx_t = g_t,   da_t = g_t h_{t-1},   dh0 = c_{-1}
//
// over a, h_seq (the forward's output), dh_seq (B, T, C) of one dtype and
// h0, dh_T (B, C) float32 or null (zeros); it writes da and dx (B, T, C)
// in that dtype and dh0 (B, C) float32. Each step is a float32 add and
// two float32 multiplies, each rounded on its own (no fused multiply-add),
// as kernels/ref.py:rglru_scan_bwd_ref computes them, so the two agree bit
// for bit.
//
// What bounds it on the H100: bytes (a, h and dh read once, da and dx
// written once: 20 bytes a float32 element); the walk over t is
// sequential, so a long prompt at small B * C has few threads, and the
// latency of its loads sets the pace unless they are issued well ahead.
//
// Design: the first design of csrc/rglru_scan.cu run backward in time. A
// thread owns one (b, c) channel (consecutive threads, consecutive
// channels: every load and store of a warp is one 128-byte run in float32)
// and walks t = T - 1 .. 0. Its inputs come a chunk of CHUNK steps at a
// time into registers, the next chunk's loads issued before the current
// chunk's walk, so a chunk's load latency hides behind the walk of the one
// before. Blocks of one warp spread a 2560-channel row over 80 SMs.

#include "common.cuh"

namespace {

constexpr int THREADS = 32;
constexpr int CHUNK = 16;  // steps a thread holds in registers, per set

struct Chunk {
  float a[CHUNK], hp[CHUNK], dh[CHUNK];  // a_t, h_{t-1}, dh_seq_t
};

// steps t0 - CHUNK + 1 .. t0 (index j = t0 - t) of the channel at base;
// h_{-1} is h0v
template <typename T>
__device__ __forceinline__ void load_chunk(Chunk& c, const T* a,
                                           const T* h, const T* dh,
                                           size_t base, int C, int t0,
                                           float h0v) {
#pragma unroll
  for (int j = 0; j < CHUNK; ++j) {
    const int t = t0 - j;
    if (t >= 0) {
      const size_t i = base + (size_t)t * C;
      c.a[j] = rt::to_f(a[i]);
      c.dh[j] = rt::to_f(dh[i]);
      c.hp[j] = t > 0 ? rt::to_f(h[i - C]) : h0v;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    rglru_bwd_kernel(const T* __restrict__ a, const T* __restrict__ h_seq,
                     const float* __restrict__ h0,
                     const T* __restrict__ dh_seq,
                     const float* __restrict__ dh_T, T* __restrict__ da,
                     T* __restrict__ dx, float* __restrict__ dh0, int B,
                     int Tn, int C) {
  const long long id = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (id >= (long long)B * C) return;
  const long long b = id / C, c = id % C;
  const size_t base = (size_t)b * Tn * C + c;
  const float h0v = h0 != nullptr ? h0[id] : 0.f;
  float carry = dh_T != nullptr ? dh_T[id] : 0.f;
  Chunk cur, nxt;
  if (Tn > 0) load_chunk(nxt, a, h_seq, dh_seq, base, C, Tn - 1, h0v);
#pragma unroll 1
  for (int t0 = Tn - 1; t0 >= 0; t0 -= CHUNK) {
    cur = nxt;
    if (t0 - CHUNK >= 0)
      load_chunk(nxt, a, h_seq, dh_seq, base, C, t0 - CHUNK, h0v);
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      const int t = t0 - j;
      if (t >= 0) {
        const float g = __fadd_rn(cur.dh[j], carry);
        const size_t i = base + (size_t)t * C;
        dx[i] = rt::from_f<T>(g);
        da[i] = rt::from_f<T>(__fmul_rn(g, cur.hp[j]));
        carry = __fmul_rn(cur.a[j], g);
      }
    }
  }
  dh0[id] = carry;
}

template <typename T>
cudaError_t launch(const void* a, const void* h, const float* h0,
                   const void* dh, const float* dh_T, void* da, void* dx,
                   float* dh0, int B, int Tn, int C, cudaStream_t stream) {
  const long long n = (long long)B * C;
  const int blocks = (int)((n + THREADS - 1) / THREADS);
  rglru_bwd_kernel<T><<<blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(h), h0,
      static_cast<const T*>(dh), dh_T, static_cast<T*>(da),
      static_cast<T*>(dx), dh0, B, Tn, C);
  return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success). a, h_seq, dh_seq,
// da, dx: (B, T, C) of one dtype; h0, dh_T (B, C) float32 or null; dh0
// (B, C) float32. All contiguous, checked by the Python wrapper; B * C > 0.
extern "C" int rglru_scan_bwd(const void* a, const void* h_seq,
                              const void* h0, const void* dh_seq,
                              const void* dh_T, void* da, void* dx,
                              void* dh0, int dtype, int B, int T, int C,
                              void* stream) {
  if (B <= 0 || C <= 0 || T < 0) return cudaErrorInvalidValue;
  const float* h0f = static_cast<const float*>(h0);
  const float* dhT = static_cast<const float*>(dh_T);
  float* d0 = static_cast<float*>(dh0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case rt::F32:
      return launch<float>(a, h_seq, h0f, dh_seq, dhT, da, dx, d0, B, T, C,
                           st);
    case rt::BF16:
      return launch<__nv_bfloat16>(a, h_seq, h0f, dh_seq, dhT, da, dx, d0, B,
                                   T, C, st);
    case rt::F16:
      return launch<__half>(a, h_seq, h0f, dh_seq, dhT, da, dx, d0, B, T, C,
                            st);
  }
  return cudaErrorInvalidValue;
}
