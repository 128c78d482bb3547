// Paged suffix-prefill attention for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/paged_prefill.py:paged_prefill_attention (the
// Pallas TPU kernel, def :99 / pl.pallas_call :147). Same function: row n's
// queries (the prompt suffix at absolute positions starts[n] + i) attend to
// the cached prefix in the paged pool (positions < starts[n], gathered
// through the block table) plus causally to the fresh suffix K/V (suffix
// index < lengths[n] - starts[n]), optionally within a sliding `window`;
// int8 / fp8-e4m3 pools are dequantized in-register (the suffix stays full
// precision). Rows with no valid key (lengths == 0 batch padding) give
// zeros rather than the TPU kernel's unspecified values.
//
// What bounds it on the H100: at serving shapes (a few rows of <= 256
// suffix tokens over <= 512 cached tokens) the attention is small; each
// key row is read once per (row, KV head, q-tile) block, and the flop count
// (4 * H * hd per query-key pair) sits near the bf16 ridge only for long
// suffixes. This first version does its dot products on the CUDA cores in
// float32, so it is bound by operations on those cores, far from either
// tensor-core or memory roofline; wgmma tiles are a later change.
//
// Design: one block per (row, KV head, q-tile of BQ positions) holding all
// group * BQ query rows of that tile (one thread per query row, q and acc
// in registers), so every K/V tile staged in shared memory serves the whole
// GQA group. Inside the block a loop replaces the TPU kernel's sequential
// "arbitrary" key axis of M + Ls/bs steps: first the pool tokens below
// starts (each token's block id read from the table), then the suffix
// tiles, skipping tiles above the causal diagonal. Shared memory holds two
// TK x hd float tiles (TK = 32 keys up to hd 128, 16 at hd 256: 32 KiB), so
// peak memory does not grow with the prompt. At hd 256 a thread's q and acc
// (512 floats) no longer fit in registers and spill to local memory; a
// split of the row over threads, as flash_attention.cu does, is a later
// change.
// Masked keys are selected out (never multiplied by zero), so stale or
// non-finite pool contents cannot leak into the result.

#include "common.cuh"

namespace {

// Query positions per block (group * bq<HD>() threads): 16 at hd 256,
// where a thread holds 255 registers and 32 positions of a group of 10
// would ask for more than an SM's 65,536.
template <int HD>
__host__ __device__ constexpr int bq() { return HD >= 256 ? 16 : 32; }

template <typename TQ, typename TKV, int HD, bool QUANT>
__global__ void paged_prefill_kernel(
    const TQ* __restrict__ q, const TQ* __restrict__ k_suf,
    const TQ* __restrict__ v_suf, const TKV* __restrict__ k_pool,
    const TKV* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int32_t* __restrict__ tables,
    const int32_t* __restrict__ starts, const int32_t* __restrict__ lengths,
    TQ* __restrict__ out, int Ls, int H, int KV, int bs, int M, int window,
    float scale) {
  constexpr int TK = HD >= 256 ? 16 : rt::TK;
  constexpr int BQ = bq<HD>();
  __shared__ __align__(16) float Ks[TK * HD];
  __shared__ __align__(16) float Vs[TK * HD];
  const int n = blockIdx.x, kvh = blockIdx.y, qt = blockIdx.z;
  const int group = H / KV;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int g = tid / BQ;
  const int i = qt * BQ + tid % BQ;  // suffix index of this thread's query
  const bool active = i < Ls;
  const int h = kvh * group + g;
  const int st = starts[n];
  const int ln_s = lengths[n] - st;  // valid suffix tokens
  const int pool_end = min(st, M * bs);

  float qr[HD], acc[HD];
  float m = rt::NEG_INF, l = 0.f;
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    acc[d] = 0.f;
    qr[d] = active ? rt::to_f(q[(((size_t)n * Ls + i) * H + h) * HD + d]) : 0.f;
  }

  // cached prefix: pool tokens [0, starts)
  for (int t0 = 0; t0 < pool_end; t0 += TK) {
    for (int e = tid; e < TK * HD; e += nthr) {
      const int j = e / HD, d = e % HD, t = t0 + j;
      float kv = 0.f, vv = 0.f;
      if (t < pool_end) {
        const size_t row = (size_t)tables[(size_t)n * M + t / bs] * bs + t % bs;
        const size_t off = (row * KV + kvh) * HD + d;
        kv = rt::to_f(k_pool[off]);
        vv = rt::to_f(v_pool[off]);
        if (QUANT) {
          kv *= k_scale[row * KV + kvh];
          vv *= v_scale[row * KV + kvh];
        }
      }
      Ks[e] = kv;
      Vs[e] = vv;
    }
    __syncthreads();
    if (active) {
      auto valid = [&](int j) {
        const int t = t0 + j;
        return t < pool_end && (window <= 0 || t > st + i - window);
      };
#pragma unroll 1
      for (int j = 0; j < TK; ++j)
        if (valid(j))
          rt::fold_key<HD>(qr, Ks + j * HD, Vs + j * HD, scale, m, l, acc);
    }
    __syncthreads();
  }

  // fresh suffix, causal; tiles strictly above this q-tile's diagonal skip
  const int u_end = min(min(ln_s, Ls), qt * BQ + BQ);
  for (int u0 = 0; u0 < u_end; u0 += TK) {
    for (int e = tid; e < TK * HD; e += nthr) {
      const int j = e / HD, d = e % HD, u = u0 + j;
      float kv = 0.f, vv = 0.f;
      if (u < u_end) {
        const size_t off = (((size_t)n * Ls + u) * KV + kvh) * HD + d;
        kv = rt::to_f(k_suf[off]);
        vv = rt::to_f(v_suf[off]);
      }
      Ks[e] = kv;
      Vs[e] = vv;
    }
    __syncthreads();
    if (active) {
      auto valid = [&](int j) {
        const int u = u0 + j;
        return u <= i && u < ln_s && (window <= 0 || u > i - window);
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
    TQ* o = out + (((size_t)n * Ls + i) * H + h) * HD;
#pragma unroll
    for (int d = 0; d < HD; ++d) o[d] = rt::from_f<TQ>(acc[d] * inv);
  }
}

struct Args {
  const void *q, *ks_, *vs_, *kp, *vp;
  const float *ksc, *vsc;
  const int32_t *tables, *starts, *lengths;
  void* out;
  int N, Ls, H, KV, bs, M, window;
  float scale;
  cudaStream_t stream;
};

template <typename TQ, typename TKV, int HD, bool QUANT>
cudaError_t launch(const Args& a) {
  constexpr int BQ = bq<HD>();
  dim3 grid(a.N, a.KV, (a.Ls + BQ - 1) / BQ);
  const int threads = (a.H / a.KV) * BQ;
  paged_prefill_kernel<TQ, TKV, HD, QUANT><<<grid, threads, 0, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TQ*>(a.ks_),
      static_cast<const TQ*>(a.vs_), static_cast<const TKV*>(a.kp),
      static_cast<const TKV*>(a.vp), a.ksc, a.vsc, a.tables, a.starts,
      a.lengths, static_cast<TQ*>(a.out), a.Ls, a.H, a.KV, a.bs, a.M,
      a.window, a.scale);
  return cudaGetLastError();
}

template <typename TQ, int HD>
cudaError_t by_pool(int q_dtype, int kv_dtype, const Args& a) {
  if (kv_dtype == q_dtype) return launch<TQ, TQ, HD, false>(a);
  if (kv_dtype == rt::I8) return launch<TQ, int8_t, HD, true>(a);
  if (kv_dtype == rt::FP8_E4M3) return launch<TQ, __nv_fp8_e4m3, HD, true>(a);
  return cudaErrorInvalidValue;
}

template <typename TQ>
cudaError_t by_hd(int hd, int q_dtype, int kv_dtype, const Args& a) {
  if (hd == 16) return by_pool<TQ, 16>(q_dtype, kv_dtype, a);
  if (hd == 64) return by_pool<TQ, 64>(q_dtype, kv_dtype, a);
  if (hd == 80) return by_pool<TQ, 80>(q_dtype, kv_dtype, a);
  if (hd == 128) return by_pool<TQ, 128>(q_dtype, kv_dtype, a);
  if (hd == 256) return by_pool<TQ, 256>(q_dtype, kv_dtype, a);
  return cudaErrorInvalidValue;
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success). Shapes: q/out
// (N, Ls, H, hd); k_suf/v_suf (N, Ls, KV, hd) in q's dtype; pools
// (P, bs, KV, hd); scales (P, bs, KV) or null; tables (N, M); starts /
// lengths (N,). All contiguous, checked by the Python wrapper.
extern "C" int paged_prefill(const void* q, const void* k_suf,
                             const void* v_suf, const void* k_pool,
                             const void* v_pool, const void* k_scale,
                             const void* v_scale, const void* tables,
                             const void* starts, const void* lengths,
                             void* out, int q_dtype, int kv_dtype, int N,
                             int Ls, int H, int KV, int hd, int bs, int M,
                             int window, float scale, void* stream) {
  if (H % KV != 0) return cudaErrorInvalidValue;
  Args a{q,       k_suf,   v_suf,  k_pool,
         v_pool,  static_cast<const float*>(k_scale),
         static_cast<const float*>(v_scale),
         static_cast<const int32_t*>(tables),
         static_cast<const int32_t*>(starts),
         static_cast<const int32_t*>(lengths),
         out,     N,       Ls,     H,
         KV,      bs,      M,      window,
         scale,   static_cast<cudaStream_t>(stream)};
  switch (q_dtype) {
    case rt::F32: return by_hd<float>(hd, q_dtype, kv_dtype, a);
    case rt::BF16: return by_hd<__nv_bfloat16>(hd, q_dtype, kv_dtype, a);
    case rt::F16: return by_hd<__half>(hd, q_dtype, kv_dtype, a);
  }
  return cudaErrorInvalidValue;
}
