// RWKV6 (Finch) recurrence for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/rwkv6_scan.py:rwkv6_scan (the Pallas TPU
// kernel, def :55 / pl.pallas_call :65). Per (batch, head), with an
// (N, N) float32 state S (row i: key channel, column j: value channel):
//
//     y_t   = r_t (S_{t-1} + diag(u) k_t^T v_t)
//     S_t   = diag(w_t) S_{t-1} + k_t^T v_t,     S_{-1} = s0 (zeros if null)
//
// over r, k, v (B, H, T, N) in one float dtype, w (B, H, T, N) float32
// decays and u (H, N) float32 bonus; it writes y (B, H, T, N) in r's dtype
// and S_T (B, H, N, N) in float32. It is the time mix of every RWKV6 layer
// (models/recurrent.py:rwkv_seq): T = the prompt in lm.forward /
// lm.prefill, T = 1 in each decode step. The TPU kernel starts from zeros;
// this one takes the carried state s0, which decode and resumed prefill
// need. Padded steps need no length argument: the caller zeroes k and sets
// w = 1 there, which leaves S unchanged.
//
// What bounds it on the H100: at a decode step, bytes (S read and written
// once, 16 KiB each per head); over a long prompt, operations (7 float32
// operations per state element per step, on a time axis that is
// sequential).
//
// Design: one block per (b, h) and one thread per value channel j. Thread
// j owns column j of S in shared memory (S[i * N + j]: neighbouring threads
// touch neighbouring words, so no bank conflicts), so the state needs no
// synchronisation. Each step, the threads stage r_t, k_t and w_t in shared
// memory (double-buffered, one barrier a step) and every thread walks i =
// 0..N-1 for its column; the next step's inputs are loaded into registers
// before the current step is computed. Every product and sum is a float32
// operation rounded on its own (__fmul_rn / __fadd_rn: no fused
// multiply-add), in the order of kernels/ref.py:rwkv6_scan_ref, so S_T
// equals the twin's bit for bit and y differs only by the order of the
// sum over i.

#include "common.cuh"

namespace {

constexpr int MAX_N = 64;

template <typename T>
__global__ void __launch_bounds__(MAX_N)
    rwkv6_scan_kernel(const T* __restrict__ r, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ w,
                      const float* __restrict__ u,
                      const float* __restrict__ s0, T* __restrict__ y,
                      float* __restrict__ s_out, int H, int Tn, int N) {
  __shared__ float S[MAX_N * MAX_N];
  __shared__ float sr[2][MAX_N], sk[2][MAX_N], sw[2][MAX_N];
  __shared__ float su[MAX_N];
  const int bh = blockIdx.x;  // b * H + h
  const int j = threadIdx.x;
  const size_t base = (size_t)bh * Tn * N + j;
  const size_t sbase = (size_t)bh * N * N + j;
  for (int i = 0; i < N; ++i)
    S[i * N + j] = s0 != nullptr ? s0[sbase + (size_t)i * N] : 0.f;
  su[j] = u[(bh % H) * N + j];
  float nr = 0.f, nk = 0.f, nv = 0.f, nw = 0.f;
  if (Tn > 0) {
    nr = rt::to_f(r[base]);
    nk = rt::to_f(k[base]);
    nv = rt::to_f(v[base]);
    nw = w[base];
  }
  for (int t = 0; t < Tn; ++t) {
    const int buf = t & 1;
    sr[buf][j] = nr;
    sk[buf][j] = nk;
    sw[buf][j] = nw;
    const float vj = nv;
    if (t + 1 < Tn) {
      const size_t o = base + (size_t)(t + 1) * N;
      nr = rt::to_f(r[o]);
      nk = rt::to_f(k[o]);
      nv = rt::to_f(v[o]);
      nw = w[o];
    }
    __syncthreads();
    float acc = 0.f;
    for (int i = 0; i < N; ++i) {
      const float kv = __fmul_rn(sk[buf][i], vj);
      const float s = S[i * N + j];
      acc = __fadd_rn(acc, __fmul_rn(sr[buf][i],
                                     __fadd_rn(s, __fmul_rn(su[i], kv))));
      S[i * N + j] = __fadd_rn(__fmul_rn(sw[buf][i], s), kv);
    }
    y[base + (size_t)t * N] = rt::from_f<T>(acc);
  }
  for (int i = 0; i < N; ++i) s_out[sbase + (size_t)i * N] = S[i * N + j];
}

template <typename T>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const float* w, const float* u, const float* s0, void* y,
                   float* s_out, int B, int H, int Tn, int N,
                   cudaStream_t stream) {
  rwkv6_scan_kernel<T><<<B * H, N, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), w, u, s0, static_cast<T*>(y), s_out, H, Tn,
      N);
  return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success). r, k, v, y:
// (B, H, T, N) of one dtype; w (B, H, T, N), u (H, N), s0 (B, H, N, N) or
// null and s_out (B, H, N, N) float32. All contiguous, checked by the
// Python wrapper; B * H > 0 and 0 < N <= 64.
extern "C" int rwkv6_scan(const void* r, const void* k, const void* v,
                          const void* w, const void* u, const void* s0,
                          void* y, void* s_out, int dtype, int B, int H,
                          int T, int N, void* stream) {
  if (B <= 0 || H <= 0 || T < 0 || N <= 0 || N > MAX_N)
    return cudaErrorInvalidValue;
  const float* wf = static_cast<const float*>(w);
  const float* uf = static_cast<const float*>(u);
  const float* s0f = static_cast<const float*>(s0);
  float* so = static_cast<float*>(s_out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case rt::F32:
      return launch<float>(r, k, v, wf, uf, s0f, y, so, B, H, T, N, st);
    case rt::BF16:
      return launch<__nv_bfloat16>(r, k, v, wf, uf, s0f, y, so, B, H, T, N,
                                   st);
    case rt::F16:
      return launch<__half>(r, k, v, wf, uf, s0f, y, so, B, H, T, N, st);
  }
  return cudaErrorInvalidValue;
}
