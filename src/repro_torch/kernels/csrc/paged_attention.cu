// Paged single-token GQA decode attention for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/paged_attention.py:paged_attention (the
// Pallas TPU kernel, def :84 / pl.pallas_call :119). Same function: q
// (B, H, hd) attends to the first ctx_lens[b] tokens of its sequence,
// gathered from (N, bs, KV, hd) pools through the (B, M) block table, with
// an online softmax; ctx == 0 gives zeros; int8 / fp8-e4m3 pools are
// dequantized in-register against (N, bs, KV) float32 scale tables.
//
// What bounds it on the H100: bytes. Each context token's K and V row is
// read once (2 * KV * hd elements per token) against ~4 * H * hd flops, far
// below the ~295 flop/byte ridge, so the floor is pool bytes / 3.35 TB/s.
// At serving batch sizes (B = 8 slots x KV = 3 heads = 24 blocks on 132
// SMs) the launch itself dominates: the kernel is launch-bound.
//
// Design: one block per (slot, KV head) holds the whole GQA group, so each
// K/V row is read from device memory once for all `group` query rows (the
// TPU kernel's (group, hd) tile). The block reads its own block-table
// entries (the TPU kernel's scalar prefetch) and sweeps only ceil(ctx/bs)
// blocks' worth of tokens. Four warps split the tokens; within a warp each
// lane owns dims lane + 32 i (ceil(hd / 32) of them; at hd 16 and 80 the
// last step covers only the first hd % 32 lanes), dots are warp-shuffle
// reductions, and m / l / acc
// stay in float32 registers, and so does q up to hd 128 (a group of up to
// 8). At hd 256 (a group of up to 16: recurrentgemma-2b has 10 query heads
// over one KV head) q sits in dynamic shared memory instead, which keeps
// the registers for acc. After the sweep the four warps' partial acc
// (4 * group * hd floats: 40 KiB at group 10, hd 256) are merged in the
// same dynamic buffer. Tokens at or past ctx are never read. Splitting the
// token axis across blocks (flash-decoding) to fill the card is a later
// change.

#include "common.cuh"

namespace {

constexpr int NW = 4;  // warps per block

// Largest GQA group (H / KV) an instantiation takes. The per-group loops
// are unrolled to this bound, the groups past H / KV skipped; a bound of
// 16 at hd 64 slowed smollm's group-3 decode by a quarter (PERF.md), so it
// stays 8 where the configs' groups fit (hd 64 / 128) and is 16 at hd 256.
template <int HD>
__host__ __device__ constexpr int max_group() { return HD >= 256 ? 16 : 8; }

// Whether a lane owns dim lane + 32 i (every lane does when 32 divides HD).
template <int HD>
__device__ __forceinline__ bool owns(int lane, int i) {
  return HD % 32 == 0 || lane + 32 * i < HD;
}

template <typename TQ, typename TKV, int HD, bool QUANT>
__global__ void __launch_bounds__(NW * 32)
    paged_attention_kernel(const TQ* __restrict__ q,
                           const TKV* __restrict__ k_pool,
                           const TKV* __restrict__ v_pool,
                           const float* __restrict__ k_scale,
                           const float* __restrict__ v_scale,
                           const int32_t* __restrict__ tables,
                           const int32_t* __restrict__ ctx_lens,
                           TQ* __restrict__ out, int H, int KV, int bs, int M,
                           float scale) {
  constexpr int PER = (HD + 31) / 32;  // dims per lane
  constexpr int MAXG = max_group<HD>();
  // q in registers up to hd 128 (MAXG * PER <= 32 floats a lane); at hd
  // 256 a group of 16 would need 128 more, so q waits in shared memory
  constexpr bool Q_SMEM = HD >= 256;
  // the warps' acc (NW x group x HD) after the sweep; q (group x HD)
  // during it when Q_SMEM
  extern __shared__ __align__(16) float smem[];
  __shared__ float sm_m[NW][MAXG], sm_l[NW][MAXG];
  const int b = blockIdx.x, kvh = blockIdx.y;
  const int group = H / KV;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ctx = min(ctx_lens[b], M * bs);

  // the group's query rows are contiguous: heads kvh * group + g
  const TQ* qg = q + ((size_t)b * H + (size_t)kvh * group) * HD;
  float qv[Q_SMEM ? 1 : MAXG][PER];
  if constexpr (Q_SMEM) {
    for (int e = threadIdx.x; e < group * HD; e += NW * 32)
      smem[e] = rt::to_f(qg[e]);
    __syncthreads();
  } else {
#pragma unroll
    for (int g = 0; g < MAXG; ++g)
#pragma unroll
      for (int i = 0; i < PER; ++i)
        qv[g][i] = g < group && owns<HD>(lane, i)
                       ? rt::to_f(qg[g * HD + lane + 32 * i])
                       : 0.f;
  }

  float acc[MAXG][PER], m[MAXG], l[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = rt::NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) acc[g][i] = 0.f;
  }

  for (int t = warp; t < ctx; t += NW) {
    const int blk = tables[(size_t)b * M + t / bs];
    const size_t row = (size_t)blk * bs + t % bs;  // pool token slot
    const size_t base = (row * KV + kvh) * HD;
    float kf[PER], vf[PER];
    const float ks = QUANT ? k_scale[row * KV + kvh] : 1.f;
    const float vs = QUANT ? v_scale[row * KV + kvh] : 1.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const bool own = owns<HD>(lane, i);
      kf[i] = own ? rt::to_f(k_pool[base + lane + 32 * i]) * ks : 0.f;
      vf[i] = own ? rt::to_f(v_pool[base + lane + 32 * i]) * vs : 0.f;
    }
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g < group) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < PER; ++i) {
          const float qi = !owns<HD>(lane, i) ? 0.f
                           : Q_SMEM ? smem[g * HD + lane + 32 * i]
                                    : qv[Q_SMEM ? 0 : g][i];
          part += qi * kf[i];
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, o);
        const float s = part * scale;
        const float m_new = fmaxf(m[g], s);
        const float alpha = expf(m[g] - m_new);
        const float p = expf(s - m_new);
        l[g] = l[g] * alpha + p;
#pragma unroll
        for (int i = 0; i < PER; ++i) acc[g][i] = acc[g][i] * alpha + p * vf[i];
        m[g] = m_new;
      }
    }
  }

  // merge the warps' partial states (every warp done with q in smem first)
  __syncthreads();
  float* sm_acc = smem;
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g < group) {
      if (lane == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
#pragma unroll
      for (int i = 0; i < PER; ++i)
        if (owns<HD>(lane, i))
          sm_acc[((size_t)warp * group + g) * HD + lane + 32 * i] = acc[g][i];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < group * HD; e += NW * 32) {
    const int g = e / HD, d = e % HD;
    float mx = rt::NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float a = expf(sm_m[w][g] - mx);
      L += a * sm_l[w][g];
      A += a * sm_acc[((size_t)w * group + g) * HD + d];
    }
    out[((size_t)b * H + kvh * group + g) * HD + d] =
        rt::from_f<TQ>(A / fmaxf(L, 1e-30f));
  }
}

template <typename TQ, typename TKV, int HD, bool QUANT>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const float* ks, const float* vs, const int32_t* tables,
                   const int32_t* ctx, void* out, int B, int H, int KV, int bs,
                   int M, float scale, cudaStream_t stream) {
  dim3 grid(B, KV);
  const size_t smem = (size_t)NW * (H / KV) * HD * sizeof(float);
  if (smem > 48 * 1024) {  // past the default dynamic limit: opt in
    const cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel<TQ, TKV, HD, QUANT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  paged_attention_kernel<TQ, TKV, HD, QUANT><<<grid, NW * 32, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(kp),
      static_cast<const TKV*>(vp), ks, vs, tables, ctx, static_cast<TQ*>(out),
      H, KV, bs, M, scale);
  return cudaGetLastError();
}

template <typename TQ, int HD>
cudaError_t by_pool(int kv_dtype, int q_dtype, const void* q, const void* kp,
                    const void* vp, const float* ks, const float* vs,
                    const int32_t* tables, const int32_t* ctx, void* out,
                    int B, int H, int KV, int bs, int M, float scale,
                    cudaStream_t stream) {
  if (kv_dtype == q_dtype)
    return launch<TQ, TQ, HD, false>(q, kp, vp, ks, vs, tables, ctx, out, B,
                                     H, KV, bs, M, scale, stream);
  if (kv_dtype == rt::I8)
    return launch<TQ, int8_t, HD, true>(q, kp, vp, ks, vs, tables, ctx, out,
                                        B, H, KV, bs, M, scale, stream);
  if (kv_dtype == rt::FP8_E4M3)
    return launch<TQ, __nv_fp8_e4m3, HD, true>(q, kp, vp, ks, vs, tables, ctx,
                                               out, B, H, KV, bs, M, scale,
                                               stream);
  return cudaErrorInvalidValue;
}

template <typename TQ>
cudaError_t by_hd(int hd, int kv_dtype, int q_dtype, const void* q,
                  const void* kp, const void* vp, const float* ks,
                  const float* vs, const int32_t* tables, const int32_t* ctx,
                  void* out, int B, int H, int KV, int bs, int M, float scale,
                  cudaStream_t stream) {
  if (hd == 16)
    return by_pool<TQ, 16>(kv_dtype, q_dtype, q, kp, vp, ks, vs, tables, ctx,
                           out, B, H, KV, bs, M, scale, stream);
  if (hd == 64)
    return by_pool<TQ, 64>(kv_dtype, q_dtype, q, kp, vp, ks, vs, tables, ctx,
                           out, B, H, KV, bs, M, scale, stream);
  if (hd == 80)
    return by_pool<TQ, 80>(kv_dtype, q_dtype, q, kp, vp, ks, vs, tables, ctx,
                           out, B, H, KV, bs, M, scale, stream);
  if (hd == 128)
    return by_pool<TQ, 128>(kv_dtype, q_dtype, q, kp, vp, ks, vs, tables,
                            ctx, out, B, H, KV, bs, M, scale, stream);
  if (hd == 256)
    return by_pool<TQ, 256>(kv_dtype, q_dtype, q, kp, vp, ks, vs, tables,
                            ctx, out, B, H, KV, bs, M, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success). Shapes: q/out
// (B, H, hd); pools (N, bs, KV, hd); scales (N, bs, KV) or null; tables
// (B, M); ctx (B,). All contiguous, checked by the Python wrapper.
extern "C" int paged_attention(const void* q, const void* k_pool,
                               const void* v_pool, const void* k_scale,
                               const void* v_scale, const void* tables,
                               const void* ctx_lens, void* out, int q_dtype,
                               int kv_dtype, int B, int H, int KV, int hd,
                               int bs, int M, float scale, void* stream) {
  if (H % KV != 0 || KV <= 0) return cudaErrorInvalidValue;
  if (H / KV > (hd >= 256 ? max_group<256>() : max_group<64>()))
    return cudaErrorInvalidValue;
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int32_t* tb = static_cast<const int32_t*>(tables);
  const int32_t* cl = static_cast<const int32_t*>(ctx_lens);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case rt::F32:
      return by_hd<float>(hd, kv_dtype, q_dtype, q, k_pool, v_pool, ks, vs,
                          tb, cl, out, B, H, KV, bs, M, scale, st);
    case rt::BF16:
      return by_hd<__nv_bfloat16>(hd, kv_dtype, q_dtype, q, k_pool, v_pool,
                                  ks, vs, tb, cl, out, B, H, KV, bs, M, scale,
                                  st);
    case rt::F16:
      return by_hd<__half>(hd, kv_dtype, q_dtype, q, k_pool, v_pool, ks, vs,
                           tb, cl, out, B, H, KV, bs, M, scale, st);
  }
  return cudaErrorInvalidValue;
}
