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
// hundreds it sits at or above the bf16 ridge, and only wgmma reaches the
// tensor cores' 989 TFLOP/s.
//
// Two kernels, chosen by dtype in kernels/flash_attention.py:
//
// flash_wgmma_kernel (bf16, f16): a block of two warpgroups per (b, h,
// 128-row q tile), each warpgroup owning 64 rows (wgmma's M); both read
// the block's K/V tiles of 64 keys. Thread 0 brings the tiles in with TMA
// copies from tensor maps, one box per tile (Q once; K and V in a
// two-stage ring: tile j + 1 loads while tile j is computed, into the
// stage both warpgroups have released on its "empty" mbarrier; nothing
// else holds the warpgroups to each other). Copies made by every thread
// (cp.async) took each SM longer than a tile's products, and one box per
// panel kept thread 0, and with it the block, waiting (PERF.md §6). A
// tile lands as hd / 16 panels of 16 columns, 32-byte swizzled,
// which takes every head dim (hd 80 too) and is what wgmma's
// 32-byte-swizzle descriptors read. S = Q K^T is a wgmma m64n64k16 chain
// over hd / 16 steps with float32 accumulators; the causal / window mask is
// applied only on tiles that cross the diagonal, the window's edge or Sk,
// and a warpgroup skips tiles none of its rows can see. The online softmax
// (2^x of log2e-scaled scores, row max over the quad of threads that share
// a row, O rescaled only when a max moved) runs on the accumulator
// fragment in registers, which then becomes P.V's A operand without a trip
// through shared memory. P is rounded to the input type for the tensor
// cores as two halves, hi = rn(P) and lo = rn(P - hi), and O += P_hi V +
// P_lo V: one rounding of P would be tens of bf16 ulps off the float32
// twin where outputs cancel near 0 (chip_smoke.py's gate is 2;
// tests/test_torch_kernels.py::test_flash_single_bf16_p_breaks_the_bf16_gate),
// the pair keeps ~16 bits. V is wgmma's B operand straight from its [key]
// [hd] tile, MN-major with the transpose bit (16-bit types only).
//
// flash_attention_kernel (float32): the CUDA-core kernel of the first
// port. TF32 tensor cores keep ~10 bits of the inputs, which would break
// the float32 2e-5 that the card-vs-CPU phases hold the model to. Each
// query row belongs to SPLIT neighbouring threads of one warp, each
// holding DPT = hd / SPLIT of its dims (q and acc in float32 registers,
// interleaved in float4 steps so the group's shared-memory reads are
// conflict-free): SPLIT = 1 up to hd 64, 2 at hd 80 and hd 128, 4 at hd
// 256. A key's score is the group's partial dots summed with warp
// shuffles. K/V tiles of TK keys (32; 16 at hd 256) are staged in shared
// memory and read by every row of the tile.

#include <type_traits>

#include "async_copy.cuh"
#include "common.cuh"
#include "wgmma.cuh"

namespace {

// Query rows per block (both kernels).
constexpr int BQ = 64;

// ---------------------------------------------------------------------------
// 16-bit inputs: wgmma
// ---------------------------------------------------------------------------

// The wgmma kernel's shape: WGS warpgroups of 128 threads per block, each
// owning 64 query rows (wgmma's M) and all sharing the block's K/V tiles;
// BN keys per tile (kernels/build.py:FLASH_KEY_TILE), in two stages.
constexpr int WGS = 2;
constexpr int BQW = BQ * WGS;  // query rows per block
constexpr int BN = 64;

// Shared memory: Q (BQW rows), then two stages of K and of V (BN rows
// each), every tile as hd / 16 panels of 16 columns (32 bytes a row,
// 32-byte swizzle) one after another, then the barriers.
template <typename T, int HD>
__host__ __device__ constexpr size_t wgmma_smem_bytes() {
  return (size_t)(BQW + 4 * BN) * HD * sizeof(T) + 5 * 8;
}

using wg::ex2;
using wg::pack2;
using wg::unpack2;

template <typename T, int HD>
__global__ void __launch_bounds__(WGS * 128, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       T* __restrict__ out, int H, int KV, int Sq, int Sk,
                       int causal, int window, float scale_log2) {
  constexpr int NS = HD / 16;         // k-steps of Q.K^T, panels of a tile
  constexpr int NP = BN / 16;         // k-steps of P.V
  constexpr uint32_t SW32 = 3;        // descriptor mode: 32-byte swizzle
  constexpr uint32_t QPANEL = BQW * 32, PANEL = BN * 32;  // bytes
  constexpr uint32_t TILE = NS * PANEL;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sq = smem_raw;
  unsigned char* sk = sq + NS * QPANEL;       // two stages
  unsigned char* sv = sk + 2 * TILE;          // two stages
  // barriers: Q landed; tile in stage 0 / 1 landed (full); both
  // warpgroups done with stage 0 / 1 (empty)
  uint64_t* bar = reinterpret_cast<uint64_t*>(sv + 2 * TILE);
  uint64_t* full = bar + 1;
  uint64_t* empty = bar + 3;
  T* const tp = nullptr;              // selects pack2 / unpack2 for T
  const int wgi = threadIdx.x / 128;  // this thread's warpgroup
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int tq_ = lane & 3;
  // heaviest causal tiles first
  const int qb = (gridDim.x - 1 - blockIdx.x) * BQW;  // the block's rows
  const int q0 = qb + BQ * wgi;                         // the warpgroup's
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvz = b * KV + h / (H / KV);  // the K/V maps' plane coordinate
  // keys the block visits, and those this warpgroup's rows can see
  const int k_end = causal ? min(Sk, qb + BQW) : Sk;
  const int k_lo = window > 0 ? max(0, qb - window + 1) : 0;
  const int w_end = causal ? min(Sk, q0 + BQ) : Sk;
  const int w_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int j0 = k_lo / BN, j1 = (k_end + BN - 1) / BN;

  // tile j of K and V into stage st, one box each (rows past Sk come
  // back as zeros)
  auto fetch = [&](int j, int st) {
    tma::expect_tx(full + st, 2 * TILE);
    tma::load_4d(sk + st * TILE, &tk, 0, j * BN, 0, kvz, full + st);
    tma::load_4d(sv + st * TILE, &tv, 0, j * BN, 0, kvz, full + st);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < 3; ++i) tma::init(bar + i, 1);
    for (int i = 3; i < 5; ++i) tma::init(bar + i, WGS);
    tma::fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    tma::expect_tx(bar, NS * QPANEL);
    tma::load_4d(sq, &tq, 0, qb, 0, b * H + h, bar);
    if (j0 < j1) fetch(j0, 0);
  }

  // Q, K: K-major, a k-step is one panel (8-row groups 256 bytes apart).
  // V: MN-major for P.V, its hd runs across panels (PANEL apart) and its
  // keys down a panel (a k-step is 16 rows, 512 bytes)
  const uint64_t dq = wg::desc(sq + wgi * BQ * 32, 16, 256, SW32);
  const uint64_t dk0 = wg::desc(sk, 16, 256, SW32);
  const uint64_t dv0 = wg::desc(sv, PANEL, 256, SW32);

  float o[HD / 2], s[BN / 2];
#pragma unroll
  for (int e = 0; e < HD / 2; ++e) o[e] = 0.f;
  float m[2] = {rt::NEG_INF, rt::NEG_INF}, l[2] = {0.f, 0.f};
  const int row = q0 + 16 * warp + lane / 4;  // and row + 8
  tma::wait(bar, 0);

#pragma unroll 1
  for (int j = j0; j < j1; ++j) {
    const int st = (j - j0) & 1;
    const uint64_t dk = dk0 + st * (TILE >> 4), dv = dv0 + st * (TILE >> 4);
    tma::wait(full + st, ((j - j0) >> 1) & 1);
    // tile j + 1 loads while tile j is computed, into the stage tile j - 1
    // used once both warpgroups are done with it; the warpgroups are not
    // held to each other otherwise, so one's softmax can run while the
    // other's products do
    if (threadIdx.x == 0 && j + 1 < j1) {
      if (j > j0) tma::wait(empty + (st ^ 1), ((j - 1 - j0) >> 1) & 1);
      fetch(j + 1, st ^ 1);
    }

    // a warpgroup skips tiles none of its rows can see
    const int u0 = j * BN;
    if (q0 < Sq && u0 < w_end && u0 + BN > w_lo) {
      // S = Q K^T
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) s[e] = 0.f;
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < NS; ++kk)
        wg::mma_ss<T, BN>(s, dq + kk * (QPANEL >> 4),
                          dk + kk * (PANEL >> 4), kk > 0);
      wg::commit();
      wg::wait<0>();
      wg::keep(s);

      // mask (edge tiles only), online softmax on the fragment
      const bool edge = u0 + BN > w_end || (causal && u0 + BN - 1 > q0) ||
                        (window > 0 && u0 <= q0 + BQ - 1 - window);
      if (edge) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = row + 8 * r;
#pragma unroll
          for (int c = 0; c < BN / 8; ++c)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int u = u0 + 8 * c + 2 * tq_ + e;
              const bool ok = u < w_end && (!causal || u <= i) &&
                              (window <= 0 || u > i - window);
              if (!ok) s[4 * c + 2 * r + e] = -INFINITY;
            }
        }
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // row max of the raw scores (two chains), over the quad
        float mx0 = s[2 * r], mx1 = s[2 * r + 1];
#pragma unroll
        for (int c = 1; c < BN / 8; ++c) {
          mx0 = fmaxf(mx0, s[4 * c + 2 * r]);
          mx1 = fmaxf(mx1, s[4 * c + 2 * r + 1]);
        }
        float mx = fmaxf(mx0, mx1);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx * scale_log2);
        alpha[r] = ex2(m[r] - m_new);
        m[r] = m_new;
        float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
        for (int c = 0; c < BN / 8; ++c) {
          const float p0 = ex2(fmaf(s[4 * c + 2 * r], scale_log2, -m_new));
          const float p1 =
              ex2(fmaf(s[4 * c + 2 * r + 1], scale_log2, -m_new));
          s[4 * c + 2 * r] = p0;
          s[4 * c + 2 * r + 1] = p1;
          sum0 += p0;
          sum1 += p1;
        }
        l[r] = l[r] * alpha[r] + (sum0 + sum1);
      }
      // rescale O only when some row's max moved
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int c = 0; c < HD / 8; ++c) {
          o[4 * c] *= alpha[0];
          o[4 * c + 1] *= alpha[0];
          o[4 * c + 2] *= alpha[1];
          o[4 * c + 3] *= alpha[1];
        }
      }

      // P as wgmma A fragments: k-step kk's register i is the pair
      // s[8 kk + 2 i], s[8 kk + 2 i + 1]; hi and lo halves
      uint32_t ph[NP * 4], pl[NP * 4];
#pragma unroll
      for (int n = 0; n < NP * 4; ++n) {
        ph[n] = pack2(s[2 * n], s[2 * n + 1], tp);
        const float2 hi = unpack2(ph[n], tp);
        pl[n] = pack2(s[2 * n] - hi.x, s[2 * n + 1] - hi.y, tp);
      }
      // O += P_hi V + P_lo V
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < NP; ++kk)
        wg::mma_rs<T, HD>(o, ph + 4 * kk, dv + kk * (512 >> 4));
#pragma unroll
      for (int kk = 0; kk < NP; ++kk)
        wg::mma_rs<T, HD>(o, pl + 4 * kk, dv + kk * (512 >> 4));
      wg::commit();
      wg::wait<0>();
      wg::keep(o);
      wg::keep(ph);
      wg::keep(pl);
    }
    if ((threadIdx.x & 127) == 0) tma::arrive(empty + st);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float den = fmaxf(sum, 1e-30f);
    const int i = row + 8 * r;
    if (i < Sq) {
      T* orow = out + (((size_t)b * H + h) * Sq + i) * HD + 2 * tq_;
#pragma unroll
      for (int c = 0; c < HD / 8; ++c)
        *reinterpret_cast<uint32_t*>(orow + 8 * c) =
            pack2(o[4 * c + 2 * r] / den, o[4 * c + 2 * r + 1] / den, tp);
    }
  }
}

// A (planes, rows, HD) row-major 16-bit tensor as a 4-D map (16 columns,
// rows, HD / 16 column panels, planes) whose box is `box_rows` rows of
// every panel, landing panel after panel, each row 32 bytes and 32-byte
// swizzled; rows past `rows` read as zeros.
template <typename T, int HD>
cudaError_t make_map(CUtensorMap* map, const void* base, int rows,
                     int planes, int box_rows) {
  const cuuint64_t dims[4] = {16, (cuuint64_t)rows, HD / 16,
                              (cuuint64_t)planes};
  const cuuint64_t strides[3] = {(cuuint64_t)HD * sizeof(T),
                                 16 * sizeof(T),
                                 (cuuint64_t)HD * sizeof(T) * rows};
  const cuuint32_t box[4] = {16, (cuuint32_t)box_rows, HD / 16, 1};
  return tma::map_sw32(map, std::is_same<T, __half>::value, base, 4, dims,
                       strides, box);
}

template <typename T, int HD>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* out, int B, int H, int KV, int Sq, int Sk,
                         int causal, int window, float scale,
                         cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t e = make_map<T, HD>(&tq, q, Sq, B * H, BQW);
  if (e == cudaSuccess) e = make_map<T, HD>(&tk, k, Sk, B * KV, BN);
  if (e == cudaSuccess) e = make_map<T, HD>(&tv, v, Sk, B * KV, BN);
  if (e != cudaSuccess) return e;
  constexpr size_t smem = wgmma_smem_bytes<T, HD>();
  if (smem > 48 * 1024) {  // past the default dynamic limit: opt in
    e = cudaFuncSetAttribute(flash_wgmma_kernel<T, HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((Sq + BQW - 1) / BQW, H, B);
  flash_wgmma_kernel<T, HD><<<grid, WGS * 128, smem, stream>>>(
      tq, tk, tv, static_cast<T*>(out), H, KV, Sq, Sk, causal, window,
      scale * 1.4426950408889634f);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32 inputs: CUDA cores
// ---------------------------------------------------------------------------

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
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       void* out, int B, int H, int KV, int Sq, int Sk,
                       int causal, int window, float scale,
                       cudaStream_t stream) {
  dim3 grid(B, H, (Sq + BQ - 1) / BQ);
  flash_attention_kernel<T, HD><<<grid, BQ * split<HD>(), 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), H, KV, Sq, Sk, causal,
      window, scale);
  return cudaGetLastError();
}

// LAUNCH##_by_hd: LAUNCH<T, hd> for each head dim of kernels/build.py:
// HEAD_DIMS.
#define FLASH_BY_HD(LAUNCH)                                                  \
  template <typename T>                                                      \
  cudaError_t LAUNCH##_by_hd(int hd, const void* q, const void* k,           \
                             const void* v, void* out, int B, int H, int KV, \
                             int Sq, int Sk, int causal, int window,         \
                             float scale, cudaStream_t st) {                 \
    switch (hd) {                                                            \
      case 16:                                                               \
        return LAUNCH<T, 16>(q, k, v, out, B, H, KV, Sq, Sk, causal, window, \
                             scale, st);                                     \
      case 64:                                                               \
        return LAUNCH<T, 64>(q, k, v, out, B, H, KV, Sq, Sk, causal, window, \
                             scale, st);                                     \
      case 80:                                                               \
        return LAUNCH<T, 80>(q, k, v, out, B, H, KV, Sq, Sk, causal, window, \
                             scale, st);                                     \
      case 128:                                                              \
        return LAUNCH<T, 128>(q, k, v, out, B, H, KV, Sq, Sk, causal,        \
                              window, scale, st);                            \
      case 256:                                                              \
        return LAUNCH<T, 256>(q, k, v, out, B, H, KV, Sq, Sk, causal,        \
                              window, scale, st);                            \
    }                                                                        \
    return cudaErrorInvalidValue;                                            \
  }
FLASH_BY_HD(launch_f32)
FLASH_BY_HD(launch_wgmma)
#undef FLASH_BY_HD

}  // namespace

// Both return the cudaError_t of the launch (0 = success). Shapes: q/out
// (B, H, Sq, hd); k/v (B, KV, Sk, hd), all one dtype and contiguous,
// checked by the Python wrapper. window <= 0: no window.

// float32 q / k / v: the CUDA-core kernel.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int dtype, int B, int H, int KV,
                               int Sq, int Sk, int hd, int causal, int window,
                               float scale, void* stream) {
  if (H % KV != 0 || dtype != rt::F32) return cudaErrorInvalidValue;
  return launch_f32_by_hd<float>(hd, q, k, v, out, B, H, KV, Sq, Sk, causal,
                                 window, scale,
                                 static_cast<cudaStream_t>(stream));
}

// bf16 / f16 q / k / v: the wgmma kernel.
extern "C" int flash_attention_wgmma(const void* q, const void* k,
                                     const void* v, void* out, int dtype,
                                     int B, int H, int KV, int Sq, int Sk,
                                     int hd, int causal, int window,
                                     float scale, void* stream) {
  if (H % KV != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rt::BF16)
    return launch_wgmma_by_hd<__nv_bfloat16>(hd, q, k, v, out, B, H, KV, Sq,
                                             Sk, causal, window, scale, st);
  if (dtype == rt::F16)
    return launch_wgmma_by_hd<__half>(hd, q, k, v, out, B, H, KV, Sq, Sk,
                                      causal, window, scale, st);
  return cudaErrorInvalidValue;
}
