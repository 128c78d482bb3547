// Blocked GQA flash attention, backward, for Hopper (sm_90a).
//
// Replaces: no TPU kernel. The Pallas flash kernel
// (src/repro/kernels/flash_attention.py:flash_attention, def :71 /
// pl.pallas_call :88) is forward-only, and the JAX package trains through
// jnp attention (models/attention.py:chunked_causal_attention), which XLA
// differentiates. The port trains through its flash forward, so the
// gradient is a kernel too: a plain-torch backward would put the (Sq, Sk)
// scores the forward keeps out of device memory back into it. Same masks
// as the forward (csrc/flash_attention.cu): key u is visible to query i
// when u <= i (causal) and, with window > 0, u > i - window; GQA maps
// query head h to KV head h / (H / KV). Plain twin:
// kernels/ref.py:flash_attention_bwd_ref.
//
// With P = softmax(Q K^T * scale) recomputed from each row's log-sum-exp
// and D_i = rowsum(dO_i * O_i):
//   dV = P^T dO,  dS = P * (dO V^T - D),  dQ = dS K * scale,
//   dK = dS^T Q * scale,
// dK and dV summed over the query heads of a KV head's group.
//
// What bounds it on the H100: the five products (Q K^T recomputed in each
// pass, dO V^T, P^T dO, dS K, dS^T Q) do ~10 * hd flops per visible (query,
// key) pair against ~4 * hd * 2 bytes per row read or written, so the two
// bounds meet near smollm's 512 causal tokens in bf16 and operations bound
// it beyond. This first design runs on the CUDA cores in float32, far
// from either bound (PERF.md §6; wgmma and TMA are later work), and is
// simple:
//
// Pass 1 (bwd_dq_kernel), a block per (b, h, 64 query rows): each query
// row belongs to SPLIT neighbouring threads of one warp, each holding DPT
// of its dims (q, dO and the dq accumulator in float32 registers,
// interleaved in float4 steps as in the forward's CUDA-core kernel, so the
// group's shared-memory reads are conflict-free); dot products are the
// group's partial sums combined with warp shuffles. A first sweep over the
// visible K tiles forms the row's max and sum (its log-sum-exp), a second
// over K and V tiles forms dq. It writes the row's lse and D to float32
// scratch (the wrapper allocates it).
//
// Pass 2 (bwd_dkdv_kernel), a block per (b, KV head, 64 key rows): each key
// row's k, v and its dk, dv accumulators sit in registers the same way;
// the block walks the group's query heads and, for each, the query tiles
// that can see its keys, staging Q, dO, lse and D in shared memory.
//
// Each output element is written once by one thread, and every sum runs in
// a fixed order: no atomics, so two launches give the same bits. At head
// dim 256 a block takes 32 rows (256 threads, so a thread may keep its 128
// floats in registers).

#include "common.cuh"

namespace {

// threads per row: each holds HD / SPLIT dims, a multiple of 4, at most 32
template <int HD>
__host__ __device__ constexpr int bsplit() {
  return HD == 80 ? 4 : (HD <= 32 ? 1 : HD / 32);
}
// rows of q (pass 1) or of k (pass 2) per block
template <int HD>
__host__ __device__ constexpr int rows() {
  return HD >= 256 ? 32 : 64;
}
// rows of the other side staged per shared-memory tile
template <int HD>
__host__ __device__ constexpr int tile() {
  return HD >= 256 ? 16 : 32;
}

// This thread's DPT dims of a row: float4 step c covers dims
// 4 * (c * SPLIT + part) .. + 3.
template <typename T, int HD, int SPLIT>
__device__ __forceinline__ void load_row(const T* __restrict__ row,
                                         bool active, int part,
                                         float (&r)[HD / SPLIT]) {
#pragma unroll
  for (int c = 0; c < HD / SPLIT / 4; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      r[4 * c + e] = active ? rt::to_f(row[4 * (c * SPLIT + part) + e]) : 0.f;
}

// The row group's dot of this thread's dims `r` with the shared-memory row
// `s` (HD floats, 16-byte aligned), summed over the group by shuffles.
template <int HD, int SPLIT>
__device__ __forceinline__ float dot_row(const float (&r)[HD / SPLIT],
                                         const float* __restrict__ s,
                                         int part, unsigned gmask) {
  const float4* s4 = reinterpret_cast<const float4*>(s);
  float dot = 0.f;
#pragma unroll
  for (int c = 0; c < HD / SPLIT / 4; ++c) {
    const float4 x = s4[c * SPLIT + part];
    dot += r[4 * c] * x.x + r[4 * c + 1] * x.y + r[4 * c + 2] * x.z +
           r[4 * c + 3] * x.w;
  }
#pragma unroll
  for (int o = 1; o < SPLIT; o <<= 1) dot += __shfl_xor_sync(gmask, dot, o);
  return dot;
}

// acc += a * (the shared-memory row s), over this thread's dims.
template <int HD, int SPLIT>
__device__ __forceinline__ void axpy_row(float (&acc)[HD / SPLIT], float a,
                                         const float* __restrict__ s,
                                         int part) {
  const float4* s4 = reinterpret_cast<const float4*>(s);
#pragma unroll
  for (int c = 0; c < HD / SPLIT / 4; ++c) {
    const float4 x = s4[c * SPLIT + part];
    acc[4 * c] += a * x.x;
    acc[4 * c + 1] += a * x.y;
    acc[4 * c + 2] += a * x.z;
    acc[4 * c + 3] += a * x.w;
  }
}

template <typename T, int HD, int SPLIT>
__device__ __forceinline__ void store_row(T* __restrict__ row, int part,
                                          const float (&r)[HD / SPLIT],
                                          float mul) {
#pragma unroll
  for (int c = 0; c < HD / SPLIT / 4; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      row[4 * (c * SPLIT + part) + e] = rt::from_f<T>(r[4 * c + e] * mul);
}

__device__ __forceinline__ unsigned group_mask(int split) {
  const int lane = threadIdx.x & 31;
  return split == 1 ? 1u << lane
                    : ((1u << split) - 1u) << (lane & ~(split - 1));
}

__device__ __forceinline__ bool visible(int i, int u, int causal,
                                        int window) {
  return (!causal || u <= i) && (window <= 0 || u > i - window);
}

// Pass 1: dq, and each row's lse and D.
template <typename T, int HD>
__global__ void __launch_bounds__(rows<HD>() * bsplit<HD>())
    bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ o,
                  const T* __restrict__ dout, T* __restrict__ dq,
                  float* __restrict__ lse_out, float* __restrict__ d_out,
                  int H, int KV, int Sq, int Sk, int causal, int window,
                  float scale) {
  constexpr int SPLIT = bsplit<HD>(), DPT = HD / SPLIT, R = rows<HD>();
  constexpr int NT = R * SPLIT, TK = tile<HD>();
  static_assert(DPT % 4 == 0 && DPT <= 32 && DPT * SPLIT == HD, "head dim");
  __shared__ __align__(16) float Ks[TK * HD];
  __shared__ __align__(16) float Vs[TK * HD];
  const int b = blockIdx.x, h = blockIdx.y, q0 = blockIdx.z * R;
  const int part = threadIdx.x % SPLIT;
  const int i = q0 + threadIdx.x / SPLIT;
  const bool active = i < Sq;
  const unsigned gmask = group_mask(SPLIT);

  const size_t row = ((size_t)b * H + h) * Sq + i;
  float qr[DPT], dor[DPT], acc[DPT];
  load_row<T, HD, SPLIT>(q + row * HD, active, part, qr);
  load_row<T, HD, SPLIT>(dout + row * HD, active, part, dor);
  // D_i = rowsum(dO_i * O_i), over the group
  float d = 0.f;
  {
    float orow[DPT];
    load_row<T, HD, SPLIT>(o + row * HD, active, part, orow);
#pragma unroll
    for (int e = 0; e < DPT; ++e) {
      d += dor[e] * orow[e];
      acc[e] = 0.f;
    }
#pragma unroll
    for (int s = 1; s < SPLIT; s <<= 1) d += __shfl_xor_sync(gmask, d, s);
  }

  const size_t kv_base = ((size_t)b * KV + h / (H / KV)) * Sk * HD;
  const int k_end = causal ? min(Sk, q0 + R) : Sk;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;

  // sweep 1: the row's max m and sum l of exp(s - m) over visible keys
  float m = rt::NEG_INF, l = 0.f;
  for (int u0 = k_lo / TK * TK; u0 < k_end; u0 += TK) {
    for (int e = threadIdx.x; e < TK * HD; e += NT)
      Ks[e] = u0 + e / HD < k_end
                  ? rt::to_f(k[kv_base + (size_t)u0 * HD + e]) : 0.f;
    __syncthreads();
#pragma unroll 1
    for (int j = 0; j < TK; ++j) {
      const int u = u0 + j;
      const float s = dot_row<HD, SPLIT>(qr, Ks + j * HD, part, gmask) * scale;
      if (!(active && u < k_end && visible(i, u, causal, window))) continue;
      if (s > m) {
        l *= expf(m - s);
        m = s;
      }
      l += expf(s - m);
    }
    __syncthreads();
  }
  const float lse = m + logf(l);

  // sweep 2: dq = sum_u P_iu (dO_i . v_u - D_i) k_u, then * scale
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
      const float s = dot_row<HD, SPLIT>(qr, Ks + j * HD, part, gmask) * scale;
      const float dp = dot_row<HD, SPLIT>(dor, Vs + j * HD, part, gmask);
      if (!(active && u < k_end && visible(i, u, causal, window))) continue;
      const float p = expf(s - lse);
      axpy_row<HD, SPLIT>(acc, p * (dp - d), Ks + j * HD, part);
    }
    __syncthreads();
  }

  if (active) {
    store_row<T, HD, SPLIT>(dq + row * HD, part, acc, scale);
    if (part == 0) {
      lse_out[row] = lse;
      d_out[row] = d;
    }
  }
}

// Pass 2: dk and dv, over the group's query heads.
template <typename T, int HD>
__global__ void __launch_bounds__(rows<HD>() * bsplit<HD>())
    bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dd, T* __restrict__ dk,
                    T* __restrict__ dv, int H, int KV, int Sq, int Sk,
                    int causal, int window, float scale) {
  constexpr int SPLIT = bsplit<HD>(), DPT = HD / SPLIT, R = rows<HD>();
  constexpr int NT = R * SPLIT, TQ = tile<HD>();
  static_assert(DPT % 4 == 0 && DPT <= 32 && DPT * SPLIT == HD, "head dim");
  __shared__ __align__(16) float Qs[TQ * HD];
  __shared__ __align__(16) float Os[TQ * HD];  // dO rows
  __shared__ float Ls[TQ], Ds[TQ];
  const int b = blockIdx.x, kvh = blockIdx.y, k0 = blockIdx.z * R;
  const int part = threadIdx.x % SPLIT;
  const int u = k0 + threadIdx.x / SPLIT;
  const bool active = u < Sk;
  const unsigned gmask = group_mask(SPLIT);
  const int G = H / KV;

  const size_t krow = ((size_t)b * KV + kvh) * Sk + u;
  float kr[DPT], vr[DPT], dka[DPT], dva[DPT];
  load_row<T, HD, SPLIT>(k + krow * HD, active, part, kr);
  load_row<T, HD, SPLIT>(v + krow * HD, active, part, vr);
#pragma unroll
  for (int e = 0; e < DPT; ++e) dka[e] = dva[e] = 0.f;

  // queries that can see one of the block's keys
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(Sq, k0 + R - 1 + window) : Sq;
  for (int g = 0; g < G; ++g) {
    const size_t qbase = ((size_t)b * H + kvh * G + g) * Sq;
    for (int i0 = q_lo / TQ * TQ; i0 < q_hi; i0 += TQ) {
      for (int e = threadIdx.x; e < TQ * HD; e += NT) {
        const bool in = i0 + e / HD < q_hi;
        Qs[e] = in ? rt::to_f(q[(qbase + i0) * HD + e]) : 0.f;
        Os[e] = in ? rt::to_f(dout[(qbase + i0) * HD + e]) : 0.f;
      }
      for (int e = threadIdx.x; e < TQ; e += NT) {
        const bool in = i0 + e < q_hi;
        Ls[e] = in ? lse[qbase + i0 + e] : 0.f;
        Ds[e] = in ? dd[qbase + i0 + e] : 0.f;
      }
      __syncthreads();
#pragma unroll 1
      for (int j = 0; j < TQ; ++j) {
        const int i = i0 + j;
        const float s =
            dot_row<HD, SPLIT>(kr, Qs + j * HD, part, gmask) * scale;
        const float dp = dot_row<HD, SPLIT>(vr, Os + j * HD, part, gmask);
        if (!(active && i < q_hi && visible(i, u, causal, window))) continue;
        const float p = expf(s - Ls[j]);
        axpy_row<HD, SPLIT>(dva, p, Os + j * HD, part);
        axpy_row<HD, SPLIT>(dka, p * (dp - Ds[j]), Qs + j * HD, part);
      }
      __syncthreads();
    }
  }

  if (active) {
    store_row<T, HD, SPLIT>(dk + krow * HD, part, dka, scale);
    store_row<T, HD, SPLIT>(dv + krow * HD, part, dva, 1.f);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, void* dq, void* dk,
                   void* dv, float* lse, float* dd, int B, int H, int KV,
                   int Sq, int Sk, int causal, int window, float scale,
                   cudaStream_t stream) {
  constexpr int R = rows<HD>(), NT = R * bsplit<HD>();
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* do_ = static_cast<const T*>(dout);
  bwd_dq_kernel<T, HD><<<dim3(B, H, (Sq + R - 1) / R), NT, 0, stream>>>(
      q_, k_, v_, static_cast<const T*>(o), do_, static_cast<T*>(dq), lse,
      dd, H, KV, Sq, Sk, causal, window, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dkdv_kernel<T, HD><<<dim3(B, KV, (Sk + R - 1) / R), NT, 0, stream>>>(
      q_, k_, v_, do_, lse, dd, static_cast<T*>(dk), static_cast<T*>(dv), H,
      KV, Sq, Sk, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_by_hd(int hd, const void* q, const void* k,
                         const void* v, const void* o, const void* dout,
                         void* dq, void* dk, void* dv, float* lse, float* dd,
                         int B, int H, int KV, int Sq, int Sk, int causal,
                         int window, float scale, cudaStream_t st) {
#define FLASH_BWD_HD(N)                                                     \
  case N:                                                                   \
    return launch<T, N>(q, k, v, o, dout, dq, dk, dv, lse, dd, B, H, KV, Sq, \
                        Sk, causal, window, scale, st);
  // the head dims of kernels/build.py:HEAD_DIMS
  switch (hd) {
    FLASH_BWD_HD(16)
    FLASH_BWD_HD(64)
    FLASH_BWD_HD(80)
    FLASH_BWD_HD(128)
    FLASH_BWD_HD(256)
  }
#undef FLASH_BWD_HD
  return cudaErrorInvalidValue;
}

}  // namespace

// Returns the cudaError_t of the two launches (0 = success). q, o, dout,
// dq: (B, H, Sq, hd); k, v, dk, dv: (B, KV, Sk, hd), all of one dtype
// (float32, bf16 or f16) and contiguous; lse, dd: (B, H, Sq) float32
// scratch; B, Sq and Sk > 0; window <= 0: no window. Checked by the Python
// wrapper (kernels/flash_attention.py:flash_attention_bwd).
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, void* dq, void* dk,
                                   void* dv, void* lse, void* dd, int dtype,
                                   int B, int H, int KV, int Sq, int Sk,
                                   int hd, int causal, int window,
                                   float scale, void* stream) {
  if (H % KV != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  float* d = static_cast<float*>(dd);
  if (dtype == rt::F32)
    return launch_by_hd<float>(hd, q, k, v, o, dout, dq, dk, dv, l, d, B, H,
                               KV, Sq, Sk, causal, window, scale, st);
  if (dtype == rt::BF16)
    return launch_by_hd<__nv_bfloat16>(hd, q, k, v, o, dout, dq, dk, dv, l,
                                       d, B, H, KV, Sq, Sk, causal, window,
                                       scale, st);
  if (dtype == rt::F16)
    return launch_by_hd<__half>(hd, q, k, v, o, dout, dq, dk, dv, l, d, B, H,
                                KV, Sq, Sk, causal, window, scale, st);
  return cudaErrorInvalidValue;
}
