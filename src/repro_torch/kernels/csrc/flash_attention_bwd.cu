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
// when u <= i (causal), or both lie in a bidirectional prefix of `prefix`
// positions, and, with window > 0, u > i - window (common.cuh:
// flash_sees); GQA maps query head h to KV head h / (H / KV). With a
// prefix, a query tile that starts inside it runs its keys to the prefix's
// end (pass 1) and a key tile that starts inside it is seen by queries
// from 0 (pass 2); tiles wholly inside the prefix square go unmasked.
// Plain twin: kernels/ref.py:flash_attention_bwd_ref.
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
// it beyond: only wgmma reaches the tensor cores' rate.
//
// bf16 / f16: two wgmma passes and a group sum, no atomics (each output
// element is written once, every sum runs in a fixed order, so two
// launches give the same bits). One warpgroup of 128 threads a block; a
// tile is 64 rows (wgmma's M) of the inputs as hd / 16 panels of 16
// columns, 32-byte swizzled, brought in by TMA from tensor maps as in the
// forward (csrc/flash_attention.cu: make_map, the same descriptors).
//
// Pass 1 (bwd_dq_wgmma_kernel), a block per (64 query rows, head, batch):
// Q and dO land once, K / V tiles of 64 keys in a two-stage ring (thread 0
// loads tile j + 1 while tile j is computed). Per tile, S = Q K^T and
// dP = dO V^T are m64n64k16 chains over hd / 16 k-steps; P = 2^(S scale
// log2e - lse) and dS = P (dP - D) are formed on the accumulator fragment,
// which is dS K's A operand without a trip through shared memory; K's
// [key][hd] tile is the B operand, MN-major with the transpose bit (as the
// forward reads V). Tiles no row can see are skipped, and only tiles that
// cross the diagonal, the window's edge or Sk are masked. Each row's
// log-sum-exp is the one the forward wrote (saved under autograd; the
// wrapper runs the forward for it otherwise). D is summed from O and dO
// in the prologue. lse and D go to float32 scratch for pass 2.
//
// Pass 2 (bwd_dkdv_wgmma_kernel), a block per (64 key rows, part of the
// head dim, query head, batch): K / V land once, the Q / dO tiles of the
// queries that can see the keys in the ring, each row's lse and D read
// straight from the scratch into the fragment's columns. S^T = K Q^T and
// dP^T = V dO^T, then dV += P^T dO and dK += dS^T Q from registers. A
// block takes one query head, not the group's: the grid is (Sk / 64 x
// parts, H, B) rather than (B, KV, Sk / 64), which fills the card where KV
// is small (smollm 48 -> 144 blocks; recurrentgemma's hd 256 with one KV
// head from 72 blocks that each walk 10 heads to 1440 of one head and 64
// columns). dK and dV accumulate in registers, 2 x HDO / 2 floats a
// thread: past hd 80 a block keeps HDO = 64 of the hd columns (its part)
// and recomputes S^T and dP^T for each part. With a
// group (H > KV) each block writes float32 partials per query head and
// bwd_group_sum_kernel adds them in head order; with H == KV pass 2
// writes dK / dV itself.
//
// P and dS are float32 on the fragment and the tensor cores take 16-bit A
// operands; one rounding would be tens of bf16 ulps off the float32 twin
// where the gradients cancel, so each goes in as two halves, hi = rn(x)
// and lo = rn(x - hi), and every product with it is two wgmma chains
// (tests/test_torch_kernels.py::test_flash_bwd_hi_lo_stays_in_the_bf16_gate).
// Q, K, V and dO are exact 16-bit inputs and go in once.
//
// float32: the CUDA-core kernels of the first design (bwd_dq_kernel,
// bwd_dkdv_kernel): TF32 tensor cores keep ~10 bits of the inputs, which
// would break the float32 2e-5. Each query (pass 1) or key (pass 2) row
// belongs to SPLIT neighbouring threads of one warp, each holding DPT of
// its dims in float32 registers, interleaved in float4 steps as in the
// forward's CUDA-core kernel; dot products are the group's partial sums
// combined with warp shuffles. Pass 1 sweeps the K tiles twice (the row's
// log-sum-exp, then dq); pass 2 walks the group's query heads and their
// query tiles, staging Q, dO, lse and D in shared memory. At head dim 256
// a block takes 32 rows (256 threads, so a thread may keep its 128 floats
// in registers).

#include <type_traits>

#include "async_copy.cuh"
#include "common.cuh"
#include "wgmma.cuh"

namespace {

// ---------------------------------------------------------------------------
// float32 inputs: CUDA cores
// ---------------------------------------------------------------------------

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


// Pass 1: dq, and each row's lse and D.
template <typename T, int HD>
__global__ void __launch_bounds__(rows<HD>() * bsplit<HD>())
    bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ o,
                  const T* __restrict__ dout, T* __restrict__ dq,
                  float* __restrict__ lse_out, float* __restrict__ d_out,
                  int H, int KV, int Sq, int Sk, int causal, int window,
                  int prefix, float scale) {
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
  const int k_end = causal ? min(Sk, rt::flash_key_end(q0, R, prefix)) : Sk;
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
      if (!(active && u < k_end &&
            rt::flash_sees(i, u, causal, window, prefix)))
        continue;
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
      if (!(active && u < k_end &&
            rt::flash_sees(i, u, causal, window, prefix)))
        continue;
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
                    int causal, int window, int prefix, float scale) {
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

  // queries that can see one of the block's keys (from 0 for keys that
  // start inside the prefix)
  const int q_lo = causal && k0 >= prefix ? k0 : 0;
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
        if (!(active && i < q_hi &&
              rt::flash_sees(i, u, causal, window, prefix)))
          continue;
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

template <int HD>
cudaError_t launch_f32(const float* q, const float* k, const float* v,
                       const float* o, const float* dout, float* dq,
                       float* dk, float* dv, float* lse, float* dd, int B,
                       int H, int KV, int Sq, int Sk, int causal, int window,
                       int prefix, float scale, cudaStream_t stream) {
  constexpr int R = rows<HD>(), NT = R * bsplit<HD>();
  bwd_dq_kernel<float, HD><<<dim3(B, H, (Sq + R - 1) / R), NT, 0, stream>>>(
      q, k, v, o, dout, dq, lse, dd, H, KV, Sq, Sk, causal, window, prefix,
      scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dkdv_kernel<float, HD><<<dim3(B, KV, (Sk + R - 1) / R), NT, 0,
                               stream>>>(q, k, v, dout, lse, dd, dk, dv, H,
                                         KV, Sq, Sk, causal, window, prefix,
                                         scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// 16-bit inputs: wgmma
// ---------------------------------------------------------------------------

// Rows of a tile (wgmma's M) and of the other side's tiles, both passes.
constexpr int BM = 64;

// Shared memory of either pass: the block's two fixed tiles, two stages of
// the two streamed ones (each tile hd / 16 panels of BM rows x 32 bytes),
// then five barriers.
template <typename T, int HD>
__host__ __device__ constexpr size_t wgmma_smem_bytes() {
  return (size_t)6 * BM * HD * sizeof(T) + 5 * 8;
}

// Output columns a pass-2 block keeps: 2 x HDO / 2 float accumulators a
// thread, at most 80.
template <int HD>
__host__ __device__ constexpr int part_cols() {
  return HD <= 80 ? HD : 64;
}

using wg::ex2;
using wg::pack2;
using wg::unpack2;

// The ring both passes stream their tiles through: two stages, a "full"
// barrier per stage (the two tiles landed) and an "empty" one (the
// warpgroup is done with it). bar[0] is the fixed tiles' barrier.
struct Ring {
  uint64_t* bar;
  __device__ uint64_t* full(int st) const { return bar + 1 + st; }
  __device__ uint64_t* empty(int st) const { return bar + 3 + st; }
  __device__ void init() const {
    if (threadIdx.x == 0) {
      for (int i = 0; i < 5; ++i) tma::init(bar + i, 1);
      tma::fence_init();
    }
    __syncthreads();
  }
  // iteration `it`'s stage has landed; thread 0 then starts iteration
  // it + 1's loads (fetch(it + 1, stage)) once it - 1 released that stage
  template <typename F>
  __device__ void acquire(int it, int n, F&& fetch) const {
    const int st = it & 1;
    tma::wait(full(st), (it >> 1) & 1);
    if (threadIdx.x == 0 && it + 1 < n) {
      if (it > 0) tma::wait(empty(st ^ 1), ((it - 1) >> 1) & 1);
      fetch(it + 1, st ^ 1);
    }
  }
  __device__ void release(int it) const {
    if (threadIdx.x == 0) tma::arrive(empty(it & 1));
  }
};

// The (query, key) visibility of the masks.
__device__ __forceinline__ bool sees(int i, int u, int Sq, int Sk,
                                     int causal, int window, int prefix) {
  return i < Sq && u < Sk && rt::flash_sees(i, u, causal, window, prefix);
}

// dS (or P) on an m64n64 accumulator fragment as the A operand of four
// k-steps: register n is the pair x[2n], x[2n + 1], as hi = rn(x) and
// lo = rn(x - hi).
template <typename T>
__device__ __forceinline__ void split_hi_lo(const float (&x)[BM / 2],
                                            uint32_t (&hi)[BM / 4],
                                            uint32_t (&lo)[BM / 4]) {
  T* const tp = nullptr;
#pragma unroll
  for (int n = 0; n < BM / 4; ++n) {
    hi[n] = pack2(x[2 * n], x[2 * n + 1], tp);
    const float2 h = unpack2(hi[n], tp);
    lo[n] = pack2(x[2 * n] - h.x, x[2 * n + 1] - h.y, tp);
  }
}

// Pass 1's scores of one K tile (keys u0 ..): S = Q K^T, masked (-inf)
// where the tile crosses the diagonal (outside the prefix square), the
// window's edge or w_end, as the forward masks them, and dP = dO V^T.
template <typename T, int HD>
__device__ __forceinline__ void scores(float (&s)[BM / 2], float (&dp)[BM / 2],
                                       uint64_t dq, uint64_t ddo,
                                       uint64_t dk, uint64_t dv,
                                       uint64_t toff, int u0, int q0,
                                       int row, int w_end, int causal,
                                       int window, int prefix) {
  constexpr int NS = HD / 16;
  constexpr uint32_t KSTEP = BM * 32 >> 4;  // a panel, in 16-byte units
  const int tq_ = threadIdx.x & 3;
#pragma unroll
  for (int e = 0; e < BM / 2; ++e) s[e] = 0.f;
  wg::fence();
#pragma unroll
  for (int kk = 0; kk < NS; ++kk)
    wg::mma_ss<T, BM>(s, dq + kk * KSTEP, dk + toff + kk * KSTEP, kk > 0);
#pragma unroll
  for (int kk = 0; kk < NS; ++kk)
    wg::mma_ss<T, BM>(dp, ddo + kk * KSTEP, dv + toff + kk * KSTEP, kk > 0);
  wg::commit();
  wg::wait<0>();
  wg::keep(s);
  wg::keep(dp);
  const bool edge = u0 + BM > w_end ||
                    (causal && u0 + BM - 1 > q0 &&
                     !rt::flash_in_prefix(q0, BM, u0, BM, prefix)) ||
                    (window > 0 && u0 <= q0 + BM - 1 - window);
  if (edge) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = row + 8 * r;
#pragma unroll
      for (int c = 0; c < BM / 8; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int u = u0 + 8 * c + 2 * tq_ + e;
          const bool ok =
              u < w_end && rt::flash_sees(i, u, causal, window, prefix);
          if (!ok) s[4 * c + 2 * r + e] = -INFINITY;
        }
    }
  }
}

// Pass 1: dq, and each query row's lse (log2 units) and D into scratch.
template <typename T, int HD>
__global__ void __launch_bounds__(128, 1)
    bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tdo,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const T* __restrict__ o, const T* __restrict__ dout,
                        T* __restrict__ dq, const float* __restrict__ lse_in,
                        float* __restrict__ lse_out,
                        float* __restrict__ d_out, int H, int KV, int Sq,
                        int Sk, int Sqp, int causal, int window, int prefix,
                        float scale_log2, float scale) {
  constexpr int NS = HD / 16, NP = BM / 16;
  constexpr uint32_t SW32 = 3, PANEL = BM * 32, TILE = NS * PANEL;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sq = smem_raw;
  unsigned char* sdo = sq + TILE;
  unsigned char* sk = sdo + TILE;   // two stages
  unsigned char* sv = sk + 2 * TILE;  // two stages
  const Ring ring{reinterpret_cast<uint64_t*>(sv + 2 * TILE)};
  T* const tp = nullptr;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tq_ = lane & 3;
  // heaviest causal tiles first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int h = blockIdx.y, b = blockIdx.z, bh = b * H + h;
  const int kvz = b * KV + h / (H / KV);
  // the K tiles some row can see: the forward warpgroup's
  const int w_end = causal ? min(Sk, rt::flash_key_end(q0, BM, prefix)) : Sk;
  const int w_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int j0 = w_lo / BM, nt = max((w_end + BM - 1) / BM - j0, 0);

  auto fetch = [&](int it, int st) {
    const int j = j0 + it;
    tma::expect_tx(ring.full(st), 2 * TILE);
    tma::load_4d(sk + st * TILE, &tk, 0, j * BM, 0, kvz, ring.full(st));
    tma::load_4d(sv + st * TILE, &tv, 0, j * BM, 0, kvz, ring.full(st));
  };
  ring.init();
  if (threadIdx.x == 0) {
    tma::expect_tx(ring.bar, 2 * TILE);
    tma::load_4d(sq, &tq, 0, q0, 0, bh, ring.bar);
    tma::load_4d(sdo, &tdo, 0, q0, 0, bh, ring.bar);
    if (nt > 0) fetch(0, 0);
  }

  // this thread's rows, and their D = rowsum(dO * O) over the quad
  const int row = q0 + 16 * warp + lane / 4;  // and row + 8
  float dd[2], lse2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row + 8 * r;
    float d = 0.f;
    if (i < Sq) {
      const size_t at = ((size_t)bh * Sq + i) * HD + 2 * tq_;
#pragma unroll
      for (int c = 0; c < HD / 8; ++c) {
        const float2 x = unpack2(
            *reinterpret_cast<const uint32_t*>(o + at + 8 * c), tp);
        const float2 y = unpack2(
            *reinterpret_cast<const uint32_t*>(dout + at + 8 * c), tp);
        d = fmaf(x.x, y.x, d);
        d = fmaf(x.y, y.y, d);
      }
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    dd[r] = d;
    lse2[r] = i < Sq ? lse_in[(size_t)bh * Sq + i] : 0.f;
  }

  // Q, dO, K (for S), V (for dP): K-major, a k-step is one panel. K for
  // dS K: MN-major, its hd across panels, its keys down a panel (a k-step
  // is 16 rows, 512 bytes)
  const uint64_t dq_ = wg::desc(sq, 16, 256, SW32);
  const uint64_t ddo = wg::desc(sdo, 16, 256, SW32);
  const uint64_t dk0 = wg::desc(sk, 16, 256, SW32);
  const uint64_t dv0 = wg::desc(sv, 16, 256, SW32);
  const uint64_t dkt0 = wg::desc(sk, PANEL, 256, SW32);

  float acc[HD / 2], s[BM / 2], dp[BM / 2];
#pragma unroll
  for (int e = 0; e < HD / 2; ++e) acc[e] = 0.f;
  tma::wait(ring.bar, 0);

  // a row no key can see has P = 0 everywhere: any finite lse gives that
#pragma unroll
  for (int r = 0; r < 2; ++r)
    if (!isfinite(lse2[r])) lse2[r] = 0.f;

#pragma unroll 1
  for (int it = 0; it < nt; ++it) {
    ring.acquire(it, nt, fetch);
    const int j = j0 + it;
    const uint64_t toff = (it & 1) * (TILE >> 4);
    scores<T, HD>(s, dp, dq_, ddo, dk0, dv0, toff, j * BM, q0, row, w_end,
                  causal, window, prefix);
    // P = 2^(S scale log2e - lse) (0 where masked), dS = P (dP - D) into dp
#pragma unroll
    for (int c = 0; c < BM / 8; ++c)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = 4 * c + 2 * r + e;
          const float p = ex2(fmaf(s[x], scale_log2, -lse2[r]));
          dp[x] = p * (dp[x] - dd[r]);
        }
    uint32_t hi[BM / 4], lo[BM / 4];
    split_hi_lo<T>(dp, hi, lo);
    // dQ += dS_hi K + dS_lo K
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < NP; ++kk)
      wg::mma_rs<T, HD>(acc, hi + 4 * kk, dkt0 + toff + kk * (512 >> 4));
#pragma unroll
    for (int kk = 0; kk < NP; ++kk)
      wg::mma_rs<T, HD>(acc, lo + 4 * kk, dkt0 + toff + kk * (512 >> 4));
    wg::commit();
    wg::wait<0>();
    wg::keep(acc);
    wg::keep(hi);
    wg::keep(lo);
    ring.release(it);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row + 8 * r;
    if (i < Sq) {
      T* drow = dq + ((size_t)bh * Sq + i) * HD + 2 * tq_;
#pragma unroll
      for (int c = 0; c < HD / 8; ++c)
        *reinterpret_cast<uint32_t*>(drow + 8 * c) =
            pack2(acc[4 * c + 2 * r] * scale,
                  acc[4 * c + 2 * r + 1] * scale, tp);
    }
    if (tq_ == 0) {  // every row of the padded scratch, Sqp of them
      lse_out[(size_t)bh * Sqp + i] = lse2[r];
      d_out[(size_t)bh * Sqp + i] = dd[r];
    }
  }
}

// Pass 2: this block's part (HDO of the hd columns) of dk and dv for its
// 64 keys over query head h: written to dk / dv when H == KV, else float32
// partials (unscaled) for bwd_group_sum_kernel.
template <typename T, int HD, int HDO>
__global__ void __launch_bounds__(128, 1)
    bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse,
                          const float* __restrict__ dd,
                          float* __restrict__ dkp, float* __restrict__ dvp,
                          T* __restrict__ dk, T* __restrict__ dv, int H,
                          int KV, int Sq, int Sk, int Sqp, int causal,
                          int window, int prefix, float scale_log2,
                          float scale) {
  constexpr int NS = HD / 16, NP = BM / 16, PARTS = HD / HDO;
  constexpr uint32_t SW32 = 3, PANEL = BM * 32, TILE = NS * PANEL;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sk = smem_raw;
  unsigned char* sv = sk + TILE;
  unsigned char* sq = sv + TILE;      // two stages
  unsigned char* sdo = sq + 2 * TILE;  // two stages
  const Ring ring{reinterpret_cast<uint64_t*>(sdo + 2 * TILE)};
  T* const tp = nullptr;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tq_ = lane & 3;
  const int part = blockIdx.x % PARTS, k0 = blockIdx.x / PARTS * BM;
  const int h = blockIdx.y, b = blockIdx.z, bh = b * H + h;
  const int G = H / KV, kvz = b * KV + h / G;
  // the query tiles that can see one of the block's keys (from 0 for keys
  // that start inside the prefix)
  const int i_lo = causal && k0 >= prefix ? k0 : 0;
  const int i_hi = window > 0 ? min(Sq, k0 + BM - 1 + window) : Sq;
  const int t0 = i_lo / BM, nt = max((i_hi + BM - 1) / BM - t0, 0);

  auto fetch = [&](int it, int st) {
    const int i0 = (t0 + it) * BM;
    tma::expect_tx(ring.full(st), 2 * TILE);
    tma::load_4d(sq + st * TILE, &tq, 0, i0, 0, bh, ring.full(st));
    tma::load_4d(sdo + st * TILE, &tdo, 0, i0, 0, bh, ring.full(st));
  };
  ring.init();
  if (threadIdx.x == 0) {
    tma::expect_tx(ring.bar, 2 * TILE);
    tma::load_4d(sk, &tk, 0, k0, 0, kvz, ring.bar);
    tma::load_4d(sv, &tv, 0, k0, 0, kvz, ring.bar);
    if (nt > 0) fetch(0, 0);
  }

  // K, V (A of S^T, dP^T), Q, dO (their B): K-major. Q, dO as B of dS^T Q
  // and P^T dO: MN-major, starting at this part's first column panel
  const uint64_t dka = wg::desc(sk, 16, 256, SW32);
  const uint64_t dva = wg::desc(sv, 16, 256, SW32);
  const uint64_t dq0 = wg::desc(sq, 16, 256, SW32);
  const uint64_t ddo0 = wg::desc(sdo, 16, 256, SW32);
  const uint32_t poff = part * (HDO / 16) * (PANEL >> 4);
  const uint64_t dqt0 = wg::desc(sq, PANEL, 256, SW32) + poff;
  const uint64_t ddot0 = wg::desc(sdo, PANEL, 256, SW32) + poff;

  const int row = k0 + 16 * warp + lane / 4;  // this thread's keys: and + 8
  float kacc[HDO / 2], vacc[HDO / 2], st[BM / 2], dpt[BM / 2];
#pragma unroll
  for (int e = 0; e < HDO / 2; ++e) kacc[e] = vacc[e] = 0.f;
  tma::wait(ring.bar, 0);

#pragma unroll 1
  for (int it = 0; it < nt; ++it) {
    ring.acquire(it, nt, fetch);
    const int i0 = (t0 + it) * BM;
    const uint64_t toff = (it & 1) * (TILE >> 4);
    // this thread's columns' lse and D: queries i0 + 8 c + 2 tq + {0, 1}
    float2 ls[BM / 8], ds[BM / 8];
    const size_t at = (size_t)bh * Sqp + i0 + 2 * tq_;
#pragma unroll
    for (int c = 0; c < BM / 8; ++c) {
      ls[c] = *reinterpret_cast<const float2*>(lse + at + 8 * c);
      ds[c] = *reinterpret_cast<const float2*>(dd + at + 8 * c);
    }
    // S^T = K Q^T, dP^T = V dO^T
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < NS; ++kk)
      wg::mma_ss<T, BM>(st, dka + kk * (PANEL >> 4),
                        dq0 + toff + kk * (PANEL >> 4), kk > 0);
#pragma unroll
    for (int kk = 0; kk < NS; ++kk)
      wg::mma_ss<T, BM>(dpt, dva + kk * (PANEL >> 4),
                        ddo0 + toff + kk * (PANEL >> 4), kk > 0);
    wg::commit();
    wg::wait<0>();
    wg::keep(st);
    wg::keep(dpt);
    // P^T into st, dS^T into dpt; 0 where masked (edge tiles only)
    const bool edge = (causal && i0 < k0 + BM - 1 &&
                       !rt::flash_in_prefix(i0, BM, k0, BM, prefix)) ||
                      (window > 0 && i0 + BM - 1 >= k0 + window) ||
                      i0 + BM > Sq || k0 + BM > Sk;
#pragma unroll
    for (int c = 0; c < BM / 8; ++c)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = 4 * c + 2 * r + e;
          const int i = i0 + 8 * c + 2 * tq_ + e, u = row + 8 * r;
          const bool ok =
              !edge || sees(i, u, Sq, Sk, causal, window, prefix);
          const float l2 = e ? ls[c].y : ls[c].x, d = e ? ds[c].y : ds[c].x;
          const float p = ok ? ex2(fmaf(st[x], scale_log2, -l2)) : 0.f;
          st[x] = p;
          dpt[x] = ok ? p * (dpt[x] - d) : 0.f;
        }
    uint32_t phi[BM / 4], plo[BM / 4], shi[BM / 4], slo[BM / 4];
    split_hi_lo<T>(st, phi, plo);
    split_hi_lo<T>(dpt, shi, slo);
    // dV += P^T_hi dO + P^T_lo dO, dK += dS^T_hi Q + dS^T_lo Q
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < NP; ++kk)
      wg::mma_rs<T, HDO>(vacc, phi + 4 * kk, ddot0 + toff + kk * (512 >> 4));
#pragma unroll
    for (int kk = 0; kk < NP; ++kk)
      wg::mma_rs<T, HDO>(vacc, plo + 4 * kk, ddot0 + toff + kk * (512 >> 4));
#pragma unroll
    for (int kk = 0; kk < NP; ++kk)
      wg::mma_rs<T, HDO>(kacc, shi + 4 * kk, dqt0 + toff + kk * (512 >> 4));
#pragma unroll
    for (int kk = 0; kk < NP; ++kk)
      wg::mma_rs<T, HDO>(kacc, slo + 4 * kk, dqt0 + toff + kk * (512 >> 4));
    wg::commit();
    wg::wait<0>();
    wg::keep(vacc);
    wg::keep(kacc);
    wg::keep(phi);
    wg::keep(plo);
    wg::keep(shi);
    wg::keep(slo);
    ring.release(it);
  }

  // rows past Sk are not written; keys no query sees get zeros
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int u = row + 8 * r;
    if (u >= Sk) continue;
    const int col = part * HDO + 2 * tq_;
    if (G == 1) {
      const size_t at = ((size_t)kvz * Sk + u) * HD + col;
#pragma unroll
      for (int c = 0; c < HDO / 8; ++c) {
        *reinterpret_cast<uint32_t*>(dk + at + 8 * c) =
            pack2(kacc[4 * c + 2 * r] * scale,
                  kacc[4 * c + 2 * r + 1] * scale, tp);
        *reinterpret_cast<uint32_t*>(dv + at + 8 * c) =
            pack2(vacc[4 * c + 2 * r], vacc[4 * c + 2 * r + 1], tp);
      }
    } else {
      const size_t at = ((size_t)bh * Sk + u) * HD + col;
#pragma unroll
      for (int c = 0; c < HDO / 8; ++c) {
        *reinterpret_cast<float2*>(dkp + at + 8 * c) =
            make_float2(kacc[4 * c + 2 * r], kacc[4 * c + 2 * r + 1]);
        *reinterpret_cast<float2*>(dvp + at + 8 * c) =
            make_float2(vacc[4 * c + 2 * r], vacc[4 * c + 2 * r + 1]);
      }
    }
  }
}

// dk / dv of a group: the G query heads' float32 partials (B, H, Sk, hd)
// added in head order, dk times scale, rounded once. A thread per pair of
// elements of (B, KV, Sk, hd).
template <typename T>
__global__ void bwd_group_sum_kernel(const float* __restrict__ dkp,
                                     const float* __restrict__ dvp,
                                     T* __restrict__ dk, T* __restrict__ dv,
                                     int G, int plane, size_t pairs,
                                     float scale) {
  T* const tp = nullptr;
  const size_t n = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= pairs) return;
  const size_t e = 2 * n, kvp = e / plane;  // plane = Sk * hd
  const size_t src = kvp * G * plane + e % plane;
  float2 ks = make_float2(0.f, 0.f), vs = ks;
  for (int g = 0; g < G; ++g) {
    const float2 a = *reinterpret_cast<const float2*>(dkp + src + g * (size_t)plane);
    const float2 c = *reinterpret_cast<const float2*>(dvp + src + g * (size_t)plane);
    ks.x += a.x;
    ks.y += a.y;
    vs.x += c.x;
    vs.y += c.y;
  }
  *reinterpret_cast<uint32_t*>(dk + e) = pack2(ks.x * scale, ks.y * scale, tp);
  *reinterpret_cast<uint32_t*>(dv + e) = pack2(vs.x, vs.y, tp);
}

// A (planes, rows, HD) row-major 16-bit tensor as a 4-D map whose box is
// 64 rows of every 16-column panel, panel after panel, 32-byte swizzled;
// rows past `rows` read as zeros (csrc/flash_attention.cu:make_map).
template <typename T, int HD>
cudaError_t make_map(CUtensorMap* map, const void* base, int rows,
                     int planes) {
  const cuuint64_t dims[4] = {16, (cuuint64_t)rows, HD / 16,
                              (cuuint64_t)planes};
  const cuuint64_t strides[3] = {(cuuint64_t)HD * sizeof(T),
                                 16 * sizeof(T),
                                 (cuuint64_t)HD * sizeof(T) * rows};
  const cuuint32_t box[4] = {16, BM, HD / 16, 1};
  return tma::map_sw32(map, std::is_same<T, __half>::value, base, 4, dims,
                       strides, box);
}

template <typename K>
cudaError_t smem_opt_in(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename T, int HD>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         const void* o, const void* dout, void* dq, void* dk,
                         void* dv, const float* lse_in, float* lse,
                         float* dd, float* dkp, float* dvp, int B, int H,
                         int KV, int Sq, int Sk, int causal, int window,
                         int prefix, float scale, cudaStream_t stream) {
  constexpr int HDO = part_cols<HD>();
  constexpr size_t smem = wgmma_smem_bytes<T, HD>();
  const int Sqp = (Sq + BM - 1) / BM * BM, G = H / KV;
  const float scale_log2 = scale * 1.4426950408889634f;
  CUtensorMap tq, tdo, tk, tv;
  cudaError_t e = make_map<T, HD>(&tq, q, Sq, B * H);
  if (e == cudaSuccess) e = make_map<T, HD>(&tdo, dout, Sq, B * H);
  if (e == cudaSuccess) e = make_map<T, HD>(&tk, k, Sk, B * KV);
  if (e == cudaSuccess) e = make_map<T, HD>(&tv, v, Sk, B * KV);
  if (e == cudaSuccess) e = smem_opt_in(bwd_dq_wgmma_kernel<T, HD>, smem);
  if (e == cudaSuccess)
    e = smem_opt_in(bwd_dkdv_wgmma_kernel<T, HD, HDO>, smem);
  if (e != cudaSuccess) return e;
  bwd_dq_wgmma_kernel<T, HD><<<dim3(Sqp / BM, H, B), 128, smem, stream>>>(
      tq, tdo, tk, tv, static_cast<const T*>(o),
      static_cast<const T*>(dout), static_cast<T*>(dq), lse_in, lse, dd, H,
      KV, Sq, Sk, Sqp, causal, window, prefix, scale_log2, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const int kt = (Sk + BM - 1) / BM;
  bwd_dkdv_wgmma_kernel<T, HD, HDO>
      <<<dim3(kt * (HD / HDO), H, B), 128, smem, stream>>>(
          tk, tv, tq, tdo, lse, dd, dkp, dvp, static_cast<T*>(dk),
          static_cast<T*>(dv), H, KV, Sq, Sk, Sqp, causal, window, prefix,
          scale_log2, scale);
  if ((e = cudaGetLastError()) != cudaSuccess || G == 1) return e;
  const size_t pairs = (size_t)B * KV * Sk * HD / 2;
  bwd_group_sum_kernel<T><<<(unsigned)((pairs + 255) / 256), 256, 0,
                            stream>>>(dkp, dvp, static_cast<T*>(dk),
                                      static_cast<T*>(dv), G, Sk * HD, pairs,
                                      scale);
  return cudaGetLastError();
}

// the head dims of kernels/build.py:HEAD_DIMS; CALL(N) launches head dim N
#define FLASH_BWD_BY_HD(CALL)    \
  switch (hd) {                  \
    case 16:                     \
      return CALL(16);           \
    case 64:                     \
      return CALL(64);           \
    case 80:                     \
      return CALL(80);           \
    case 128:                    \
      return CALL(128);          \
    case 256:                    \
      return CALL(256);          \
  }                              \
  return cudaErrorInvalidValue;

template <typename T>
cudaError_t wgmma_by_hd(int hd, const void* q, const void* k, const void* v,
                        const void* o, const void* dout, void* dq, void* dk,
                        void* dv, const float* lse_in, float* lse, float* dd,
                        float* dkp, float* dvp, int B, int H, int KV, int Sq,
                        int Sk, int causal, int window, int prefix,
                        float scale, cudaStream_t st) {
#define CALL(N)                                                              \
  launch_wgmma<T, N>(q, k, v, o, dout, dq, dk, dv, lse_in, lse, dd, dkp, dvp, \
                     B, H, KV, Sq, Sk, causal, window, prefix, scale, st)
  FLASH_BWD_BY_HD(CALL)
#undef CALL
}

cudaError_t f32_by_hd(int hd, const float* q, const float* k, const float* v,
                      const float* o, const float* dout, float* dq,
                      float* dk, float* dv, float* lse, float* dd, int B,
                      int H, int KV, int Sq, int Sk, int causal, int window,
                      int prefix, float scale, cudaStream_t st) {
#define CALL(N)                                                          \
  launch_f32<N>(q, k, v, o, dout, dq, dk, dv, lse, dd, B, H, KV, Sq, Sk, \
                causal, window, prefix, scale, st)
  FLASH_BWD_BY_HD(CALL)
#undef CALL
}
#undef FLASH_BWD_BY_HD

}  // namespace

// Both return the cudaError_t of their launches (0 = success). q, o,
// dout, dq: (B, H, Sq, hd); k, v, dk, dv: (B, KV, Sk, hd), all of one dtype
// and contiguous; B, Sq and Sk > 0; window <= 0: no window; prefix: the
// bidirectional prefix's length (0: none; read only when causal). Checked
// by the Python wrapper (kernels/flash_attention.py:flash_attention_bwd).

// float32: the CUDA-core kernels. lse, dd: (B, H, Sq) float32 scratch.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, void* dq, void* dk,
                                   void* dv, void* lse, void* dd, int dtype,
                                   int B, int H, int KV, int Sq, int Sk,
                                   int hd, int causal, int window,
                                   float scale, void* stream, int prefix) {
  if (H % KV != 0 || dtype != rt::F32) return cudaErrorInvalidValue;
  return f32_by_hd(hd, static_cast<const float*>(q),
                   static_cast<const float*>(k), static_cast<const float*>(v),
                   static_cast<const float*>(o),
                   static_cast<const float*>(dout), static_cast<float*>(dq),
                   static_cast<float*>(dk), static_cast<float*>(dv),
                   static_cast<float*>(lse), static_cast<float*>(dd), B, H,
                   KV, Sq, Sk, causal, window, max(prefix, 0), scale,
                   static_cast<cudaStream_t>(stream));
}

// bf16 / f16: the wgmma passes. All of q, k, v, o, dout 16-byte aligned
// (TMA). lse_in: (B, H, Sq) float32, each row's log-sum-exp in log2 units
// as the forward writes it (flash_attention_wgmma). lse, dd: (B, H, Sqp) float32 scratch, Sqp = Sq rounded up to 64.
// dkp, dvp: (B, H, Sk, hd) float32 scratch, read only when H > KV.
extern "C" int flash_attention_bwd_wgmma(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, const void* lse_in,
    void* lse, void* dd, void* dkp, void* dvp, int dtype, int B, int H,
    int KV, int Sq, int Sk, int hd, int causal, int window, float scale,
    void* stream, int prefix) {
  if (H % KV != 0) return cudaErrorInvalidValue;
  prefix = max(prefix, 0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* li = static_cast<const float*>(lse_in);
  float* l = static_cast<float*>(lse);
  float* d = static_cast<float*>(dd);
  float* kp = static_cast<float*>(dkp);
  float* vp = static_cast<float*>(dvp);
  if (dtype == rt::BF16)
    return wgmma_by_hd<__nv_bfloat16>(hd, q, k, v, o, dout, dq, dk, dv, li,
                                      l, d, kp, vp, B, H, KV, Sq, Sk, causal,
                                      window, prefix, scale, st);
  if (dtype == rt::F16)
    return wgmma_by_hd<__half>(hd, q, k, v, o, dout, dq, dk, dv, li, l, d,
                               kp, vp, B, H, KV, Sq, Sk, causal, window,
                               prefix, scale, st);
  return cudaErrorInvalidValue;
}
