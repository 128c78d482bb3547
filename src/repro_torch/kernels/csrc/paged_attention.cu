// Paged single-token GQA decode attention for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/paged_attention.py:paged_attention (the
// Pallas TPU kernel, def :84 / pl.pallas_call :119). Same function: q
// (B, H, hd) attends to the first ctx_lens[b] tokens of its sequence,
// gathered from (N, bs, KV, hd) pools through the (B, M) block table, with
// a softmax; ctx == 0 gives zeros; int8 / fp8-e4m3 pools are dequantized
// against (N, bs, KV) float32 scale tables. With window > 0 (the local
// attention layers of recurrentgemma-2b, whose paged history keeps every
// token) row b attends only to tokens ctx_b - window <= i < ctx_b, as the
// JAX oracle's mask (src/repro/models/attention.py:
// paged_decode_attention_block) does.
//
// What bounds it on the H100: bytes. Each context token's K and V row is
// read once (2 * KV * hd elements per token) against ~4 * H * hd flops, far
// below the ~295 flop/byte ridge, so the floor is pool bytes / 3.35 TB/s.
// Reaching it takes many blocks in flight, wide loads and few instructions
// per token.
//
// Design: a flash-decoding split in one launch. Each row's token axis is
// cut into chunks of CHUNK tokens, a constant (never derived from the
// batch, the card or occupancy), and the grid is (B, KV, ceil(M * bs /
// CHUNK)): a block takes one chunk of one (row, KV head) for the whole
// GQA group, so each K/V row is read once for all `group` query rows (the
// TPU kernel's (group, hd) tile). A block whose chunk starts at or past
// its row's ctx, or ends at or below the window's first token, exits at
// once and is no part of the merge; tokens outside [ctx - window, ctx) are
// never read (in the first live chunk the warps skip the rows below the
// window), and chunks cross block-table boundaries freely. The chunks
// stay aligned to token 0 whatever the window, so with ctx <= window the
// launch does exactly what it does without one.
//
// Inside a chunk each of the eight warps takes a tile of 16 tokens: lane
// i gathers token i's K and V rows into shared memory with one bulk TMA
// copy each (row pitches padded so the reads below meet no bank
// conflicts). Scores: lanes 2 i and 2 i + 1 own token i, each half of its
// dims, and compute its dot with every query head of the group in
// float32, q broadcast from shared memory: one shuffle per head per token
// instead of a reduction over the row's lanes; the tile's max and sum per
// head take one warp reduction each. P.V: lanes own 8 dims of a row and
// walk the tile's tokens, P broadcast from shared memory. The eight
// warps' (m, l, acc) are then merged in warp order.
//
// Merge across chunks: a row with one chunk writes its output directly.
// Otherwise each block writes its partial (m, l, acc) to the float32
// scratch, fences, and counts itself in on the (row, KV head)'s counter;
// the block that comes last merges the partials in split order and resets
// the counter to 0. No value is combined with atomics, so a row's output
// bits depend on its own ctx, window and data only, not on the batch or
// on which block finished first: the engine and generate() can be held to
// each other token for token.

#include <type_traits>

#include "async_copy.cuh"
#include "common.cuh"

namespace {

constexpr int NW = 8;         // warps per block
constexpr int NT = NW * 32;   // threads per block
constexpr int TT = 16;        // tokens per warp tile (two lanes each)
constexpr int CHUNK = NW * TT;  // tokens per split (build.py:PAGED_CHUNK)
constexpr int DPL = 8;        // dims per lane in P.V

// Lanes per token row in P.V: hd / 8 rounded up to a power of 2 (hd 80
// leaves 6 of 16 idle).
template <int HD>
__host__ __device__ constexpr int lanes_per_row() {
  return HD <= 16 ? 2 : HD <= 32 ? 4 : HD <= 64 ? 8 : HD <= 128 ? 16 : 32;
}

// Largest GQA group (H / KV) an instantiation takes, a multiple of 4 (the
// score pass runs query heads in fours): 8 up to hd 128, 16 at hd 256
// (recurrentgemma-2b has 10 query heads over one KV head).
template <int HD>
__host__ __device__ constexpr int max_group() { return HD >= 256 ? 16 : 8; }

// A pool row in 16-byte slots, and the padded pitch of a row in a tile:
// 2 mod 8 slots, so the 8 lanes of a quarter warp reading 4 rows' slots c
// and c + 1 (the score pass) or 4 rows' first slots (P.V at hd 16) hit 8
// different bank groups.
template <typename TKV, int HD>
__host__ __device__ constexpr int row_slots() {
  return HD * (int)sizeof(TKV) / 16;
}
template <typename TKV, int HD>
__host__ __device__ constexpr int pitch() {
  return row_slots<TKV, HD>() <= 2 ? 2
                                   : (row_slots<TKV, HD>() + 5) / 8 * 8 + 2;
}
// K and V tiles side by side where they fit; else V reuses K's tile
// after the score pass (float32 pools at hd 256).
template <typename TKV, int HD>
__host__ __device__ constexpr bool two_tiles() {
  return 2 * NW * TT * pitch<TKV, HD>() * 16 <= 160 * 1024;
}
template <typename TKV, int HD>
__host__ __device__ constexpr size_t tile_bytes() {
  return (size_t)NW * (two_tiles<TKV, HD>() ? 2 : 1) * TT *
         pitch<TKV, HD>() * 16;
}
// The dynamic shared memory's first region: the tiles, later the warps'
// acc and the last block's weights per split.
template <typename TKV, int HD>
__host__ __device__ size_t region_bytes(int group, int n_split) {
  size_t r = tile_bytes<TKV, HD>();
  const size_t accs = (size_t)NW * group * HD * 4;
  const size_t weights = ((size_t)2 * n_split * group * 4 + 15) / 16 * 16;
  r = r > accs ? r : accs;
  return r > weights ? r : weights;
}

// A 1-byte pool element from its bits.
__device__ __forceinline__ int8_t from_byte(uint32_t x, int8_t*) {
  return static_cast<int8_t>(x & 0xffu);
}
__device__ __forceinline__ __nv_fp8_e4m3 from_byte(uint32_t x,
                                                   __nv_fp8_e4m3*) {
  __nv_fp8_e4m3 e;
  e.__x = static_cast<__nv_fp8_storage_t>(x & 0xffu);
  return e;
}

// N consecutive pool elements held in the 32-bit words w[] (as loaded),
// in float32.
template <typename TKV, int N>
__device__ __forceinline__ void to_float(const uint32_t* w, float* x) {
#pragma unroll
  for (int d = 0; d < N; ++d) {
    if constexpr (sizeof(TKV) == 4) {
      x[d] = __uint_as_float(w[d]);
    } else if constexpr (sizeof(TKV) == 2) {
      const uint32_t h = (w[d / 2] >> (16 * (d % 2))) & 0xffffu;
      if constexpr (std::is_same<TKV, __nv_bfloat16>::value)
        x[d] = __uint_as_float(h << 16);
      else
        x[d] = __half2float(__ushort_as_half(static_cast<unsigned short>(h)));
    } else {
      TKV* const tp = nullptr;
      x[d] = rt::to_f(from_byte(w[d / 4] >> (8 * (d % 4)), tp));
    }
  }
}

template <typename TQ, typename TKV, int HD, bool QUANT>
__global__ void __launch_bounds__(NT)
    paged_attention_kernel(const TQ* __restrict__ q,
                           const TKV* __restrict__ k_pool,
                           const TKV* __restrict__ v_pool,
                           const float* __restrict__ k_scale,
                           const float* __restrict__ v_scale,
                           const int32_t* __restrict__ tables,
                           const int32_t* __restrict__ ctx_lens,
                           TQ* __restrict__ out, float* __restrict__ scratch,
                           int* __restrict__ counters, int H, int KV, int bs,
                           int M, int window, float scale_log2) {
  constexpr int LPR = lanes_per_row<HD>();
  constexpr int RPW = 32 / LPR;        // token rows per warp in P.V
  constexpr int MAXG = max_group<HD>();
  constexpr int SLOTS = row_slots<TKV, HD>();
  constexpr int P = pitch<TKV, HD>();
  constexpr int VEC = 16 / (int)sizeof(TKV);   // elements per slot
  constexpr bool TWO = two_tiles<TKV, HD>();
  // dynamic shared memory: the warps' K (and V) tiles, reused by the
  // merges; q as float32 (query heads rounded up to 4, the extra rows 0);
  // each warp's scores, then its P
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int group = H / KV;
  const int group4 = (group + 3) / 4 * 4;
  const int n_split = gridDim.z;
  const size_t region = region_bytes<TKV, HD>(group, n_split);
  uint4* tiles = reinterpret_cast<uint4*>(smem_raw);
  float* merge = reinterpret_cast<float*>(smem_raw);
  float* sq = reinterpret_cast<float*>(smem_raw + region);
  float* sp = sq + group4 * HD;        // [NW][MAXG][TT]
  __shared__ float sm_m[NW][MAXG], sm_l[NW][MAXG], sm_L[MAXG];
  __shared__ int sm_last;

  const int b = blockIdx.x, kvh = blockIdx.y, split = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ctx = max(0, min(ctx_lens[b], M * bs));
  // the window's first token, the first live split and the live splits
  const int lo = window > 0 ? max(0, ctx - window) : 0;
  const int s_lo = lo / CHUNK;
  const int c0 = split * CHUNK, c1 = min(c0 + CHUNK, ctx);
  const int n_act = (ctx + CHUNK - 1) / CHUNK - s_lo;
  // the group's query / output rows are contiguous: heads kvh * group + g
  const size_t qrow0 = (size_t)b * H + (size_t)kvh * group;

  if (c0 >= ctx || split < s_lo) {
    if (ctx == 0 && split == 0)
      for (int e = threadIdx.x; e < group * HD; e += NT)
        out[qrow0 * HD + e] = rt::from_f<TQ>(0.f);
    return;
  }

  // this warp's tile: tokens t0 + skip .. t0 + n_tok - 1, lane i's is
  // t0 + i (skip > 0 only where the window starts inside the tile)
  const int t0 = c0 + TT * warp;
  const int n_tok = max(0, min(TT, c1 - t0));
  const int skip = max(0, min(n_tok, lo - t0));
  uint4* kt = tiles + (size_t)warp * (TWO ? 2 : 1) * TT * P;
  uint4* vt = TWO ? kt + TT * P : kt;
  float* wp = sp + (size_t)warp * MAXG * TT;
  constexpr uint32_t ROW = HD * sizeof(TKV);   // bytes of a pool row
  __shared__ uint64_t sm_bar[NW][2];   // the warp's K and V tiles landed
  uint64_t* kbar = sm_bar[warp];
  uint64_t* vbar = sm_bar[warp] + 1;
  size_t rowoff = 0;                   // the lane's token row in the pools
  float ks = 1.f, vs = 1.f;
  if (lane >= skip && lane < n_tok) {
    const int t = t0 + lane;
    const size_t slot = (size_t)tables[(size_t)b * M + t / bs] * bs + t % bs;
    rowoff = (slot * KV + kvh) * HD;
    if constexpr (QUANT) {
      ks = k_scale[slot * KV + kvh];
      vs = v_scale[slot * KV + kvh];
    }
  }
  // each lane copies its own token's row with one bulk TMA copy; rows
  // outside the tile's tokens are neither copied nor read
  auto copy_tile = [&](uint4* dst, const TKV* pool, uint64_t* bar) {
    if (lane == 0) tma::expect_tx(bar, (n_tok - skip) * ROW);
    __syncwarp();
    if (lane >= skip && lane < n_tok)
      tma::load_1d(dst + lane * P, pool + rowoff, ROW, bar);
  };
  if (n_tok > skip) {
    if (lane == 0) {
      tma::init(kbar, 1);
      tma::init(vbar, 1);
      tma::fence_init();
    }
    __syncwarp();
    copy_tile(kt, k_pool, kbar);
    if (TWO) copy_tile(vt, v_pool, vbar);
  }

  // q in float32 while the copies fly
  const TQ* qg = q + qrow0 * HD;
  for (int e = threadIdx.x; e < group4 * HD; e += NT)
    sq[e] = e < group * HD ? rt::to_f(qg[e]) : 0.f;
  __syncthreads();

  const int sub = lane % LPR, rslot = lane / LPR;
  const int d0 = DPL * sub;            // this lane's first dim in P.V
  const bool owns = d0 < HD;
  float acc[MAXG][DPL];
#pragma unroll
  for (int g = 0; g < MAXG; ++g)
#pragma unroll
    for (int d = 0; d < DPL; ++d) acc[g][d] = 0.f;

  if (n_tok > skip) {
    tma::wait(kbar, 0);
    // scores: lanes 2 i and 2 i + 1 own token i, each the even or the
    // odd slots of its row, query heads four at a time
    const int half = lane & 1;
    const uint4* krow = kt + (lane >> 1) * P;
    for (int g0 = 0; g0 < group4; g0 += 4) {
      float s4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
      for (int c = half; c < SLOTS; c += 2) {
        const uint4 raw = krow[c];
        const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
        float kf[VEC];
        to_float<TKV, VEC>(w, kf);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4* q4 =
              reinterpret_cast<const float4*>(sq + (g0 + i) * HD + c * VEC);
#pragma unroll
          for (int e = 0; e < VEC / 4; ++e) {
            const float4 x = q4[e];
            s4[i] += x.x * kf[4 * e] + x.y * kf[4 * e + 1] +
                     x.z * kf[4 * e + 2] + x.w * kf[4 * e + 3];
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s4[i] += __shfl_xor_sync(0xffffffffu, s4[i], 1);
        if (half == 0) wp[(g0 + i) * TT + (lane >> 1)] = s4[i];
      }
    }
    __syncwarp();
    // softmax over the tile per query head (lane = token): max, P, sum;
    // P * v_scale is what P.V multiplies the raw V by
    const bool valid = lane >= skip && lane < n_tok;
    for (int g = 0; g < group; ++g) {
      const float x = valid ? wp[g * TT + lane] * (ks * scale_log2)
                            : rt::NEG_INF;
      float mx = x;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float p = valid ? exp2f(x - mx) : 0.f;
      float sum = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane < TT) wp[g * TT + lane] = QUANT ? p * vs : p;
      if (lane == 0) {
        sm_m[warp][g] = mx;
        sm_l[warp][g] = sum;
      }
    }
    if (!TWO) {      // V into K's tile, once every lane is done with K
      tma::fence_proxy_async();
      __syncwarp();
      copy_tile(vt, v_pool, vbar);
    }
    tma::wait(vbar, 0);
    // P.V: lanes own 8 dims of a row, RPW rows at a time
    if (owns) {
      for (int tt = skip + rslot; tt < n_tok; tt += RPW) {
        float vf[DPL];
        if constexpr (sizeof(TKV) == 4) {
          const uint4 a = vt[tt * P + 2 * sub], c = vt[tt * P + 2 * sub + 1];
          const uint32_t w[8] = {a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w};
          to_float<TKV, 8>(w, vf);
        } else if constexpr (sizeof(TKV) == 2) {
          const uint4 a = vt[tt * P + sub];
          const uint32_t w[4] = {a.x, a.y, a.z, a.w};
          to_float<TKV, 8>(w, vf);
        } else {
          const uint2 a = reinterpret_cast<const uint2*>(vt + tt * P)[sub];
          const uint32_t w[2] = {a.x, a.y};
          to_float<TKV, 8>(w, vf);
        }
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
          if (g < group) {
            const float pg = wp[g * TT + tt];
#pragma unroll
            for (int d = 0; d < DPL; ++d) acc[g][d] += pg * vf[d];
          }
        }
      }
    }
    // the row slots of the warp hold sums under one max: add them
#pragma unroll
    for (int o = LPR; o < 32; o <<= 1)
#pragma unroll
      for (int g = 0; g < MAXG; ++g)
#pragma unroll
        for (int d = 0; d < DPL; ++d)
          acc[g][d] += __shfl_xor_sync(0xffffffffu, acc[g][d], o);
  } else {
    for (int g = lane; g < group; g += 32) {
      sm_m[warp][g] = rt::NEG_INF;
      sm_l[warp][g] = 0.f;
    }
  }

  // merge the warps (every warp done with its tile first)
  __syncthreads();
#pragma unroll
  for (int g = 0; g < MAXG; ++g)
    if (g < group && rslot == 0 && owns)
#pragma unroll
      for (int d = 0; d < DPL; ++d)
        merge[((size_t)warp * group + g) * HD + d0 + d] = acc[g][d];
  __syncthreads();
  // the first live split's partial
  const size_t part0 = ((size_t)b * KV + kvh) * n_split;
  // a partial: acc (group x HD), m, l, padded to whole float4s
  const int stride = group * HD + (2 * group + 3) / 4 * 4;
  for (int e = threadIdx.x; e < group * HD; e += NT) {
    const int g = e / HD;
    float mx = rt::NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float a = exp2f(sm_m[w][g] - mx);
      L += a * sm_l[w][g];
      A += a * merge[(size_t)w * group * HD + e];
    }
    if (n_act == 1) {
      out[qrow0 * HD + e] = rt::from_f<TQ>(A / fmaxf(L, 1e-30f));
    } else {
      float* p = scratch + (part0 + split - s_lo) * stride;
      p[e] = A;
      if (e % HD == 0) {
        p[group * HD + g] = mx;
        p[group * HD + group + g] = L;
      }
    }
  }
  if (n_act == 1) return;

  // count this block in; the last of the row's n_act blocks merges
  __threadfence();
  __syncthreads();
  int* counter = counters + (size_t)b * KV + kvh;
  if (threadIdx.x == 0) {
    const int done = atomicAdd(counter, 1);
    sm_last = done == n_act - 1;
    if (sm_last) *counter = 0;   // every block of the row has counted in
  }
  __syncthreads();
  if (!sm_last) return;
  __threadfence();
  // the splits' m and l (read in parallel), then per query head the max,
  // each split's weight exp2(m - max) and the weighted l, in split order
  const float* p0 = scratch + part0 * stride;
  float* sm_w = merge;                   // n_act x group, then l beside it
  float* sm_pl = merge + n_act * group;
  for (int i = threadIdx.x; i < n_act * group; i += NT) {
    const float* p = p0 + (size_t)(i / group) * stride + group * HD;
    sm_w[i] = __ldcg(p + i % group);
    sm_pl[i] = __ldcg(p + group + i % group);
  }
  __syncthreads();
  if ((int)threadIdx.x < group) {
    const int g = threadIdx.x;
    float mx = rt::NEG_INF;
    for (int s = 0; s < n_act; ++s) mx = fmaxf(mx, sm_w[s * group + g]);
    float L = 0.f;
    for (int s = 0; s < n_act; ++s) {
      const float a = exp2f(sm_w[s * group + g] - mx);
      sm_w[s * group + g] = a;
      L += a * sm_pl[s * group + g];
    }
    sm_L[g] = L;
  }
  __syncthreads();
  // each thread's float4s e4 = threadIdx.x + NT k of the acc, the loads
  // of four splits in flight together, summed in split order
  constexpr int EPT = (MAXG * HD / 4 + NT - 1) / NT;
  const int n4 = group * HD / 4;
  float4 A[EPT];
#pragma unroll
  for (int k = 0; k < EPT; ++k) A[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s0 = 0; s0 < n_act; s0 += 4) {
    float4 x[4][EPT];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int k = 0; k < EPT; ++k) {
        const int e4 = threadIdx.x + NT * k;
        x[u][k] = s0 + u < n_act && e4 < n4
                      ? __ldcg(reinterpret_cast<const float4*>(
                                   p0 + (size_t)(s0 + u) * stride) + e4)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int k = 0; k < EPT; ++k) {
        const int e4 = threadIdx.x + NT * k;
        if (s0 + u < n_act && e4 < n4) {
          const float a = sm_w[(s0 + u) * group + 4 * e4 / HD];
          A[k].x += a * x[u][k].x;
          A[k].y += a * x[u][k].y;
          A[k].z += a * x[u][k].z;
          A[k].w += a * x[u][k].w;
        }
      }
  }
#pragma unroll
  for (int k = 0; k < EPT; ++k) {
    const int e4 = threadIdx.x + NT * k;
    if (e4 < n4) {
      const float den = fmaxf(sm_L[4 * e4 / HD], 1e-30f);
      TQ* o = out + qrow0 * HD + 4 * e4;
      o[0] = rt::from_f<TQ>(A[k].x / den);
      o[1] = rt::from_f<TQ>(A[k].y / den);
      o[2] = rt::from_f<TQ>(A[k].z / den);
      o[3] = rt::from_f<TQ>(A[k].w / den);
    }
  }
}

template <typename TQ, typename TKV, int HD, bool QUANT>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const float* ks, const float* vs, const int32_t* tables,
                   const int32_t* ctx, void* out, float* scratch,
                   int* counters, int B, int H, int KV, int bs, int M,
                   int window, float scale, cudaStream_t stream) {
  const int n_split = (M * bs + CHUNK - 1) / CHUNK;
  const int group = H / KV, group4 = (group + 3) / 4 * 4;
  dim3 grid(B, KV, n_split);
  // the kernel's layout: tiles / merges, q, scores
  const size_t smem = region_bytes<TKV, HD>(group, n_split) +
                      (size_t)group4 * HD * 4 +
                      (size_t)NW * max_group<HD>() * TT * 4;
  if (smem > 48 * 1024) {  // past the default dynamic limit: opt in
    const cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel<TQ, TKV, HD, QUANT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  paged_attention_kernel<TQ, TKV, HD, QUANT><<<grid, NT, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(kp),
      static_cast<const TKV*>(vp), ks, vs, tables, ctx, static_cast<TQ*>(out),
      scratch, counters, H, KV, bs, M, window, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

#define PAGED_ARGS                                                         \
  q, kp, vp, ks, vs, tables, ctx, out, scratch, counters, B, H, KV, bs, M, \
      window, scale, stream
#define PAGED_PARAMS                                                        \
  const void *q, const void *kp, const void *vp, const float *ks,           \
      const float *vs, const int32_t *tables, const int32_t *ctx, void *out, \
      float *scratch, int *counters, int B, int H, int KV, int bs, int M,   \
      int window, float scale, cudaStream_t stream

template <typename TQ, int HD>
cudaError_t by_pool(int kv_dtype, int q_dtype, PAGED_PARAMS) {
  if (kv_dtype == q_dtype) return launch<TQ, TQ, HD, false>(PAGED_ARGS);
  if (kv_dtype == rt::I8) return launch<TQ, int8_t, HD, true>(PAGED_ARGS);
  if (kv_dtype == rt::FP8_E4M3)
    return launch<TQ, __nv_fp8_e4m3, HD, true>(PAGED_ARGS);
  return cudaErrorInvalidValue;
}

template <typename TQ>
cudaError_t by_hd(int hd, int kv_dtype, int q_dtype, PAGED_PARAMS) {
  switch (hd) {
    case 16: return by_pool<TQ, 16>(kv_dtype, q_dtype, PAGED_ARGS);
    case 64: return by_pool<TQ, 64>(kv_dtype, q_dtype, PAGED_ARGS);
    case 80: return by_pool<TQ, 80>(kv_dtype, q_dtype, PAGED_ARGS);
    case 128: return by_pool<TQ, 128>(kv_dtype, q_dtype, PAGED_ARGS);
    case 256: return by_pool<TQ, 256>(kv_dtype, q_dtype, PAGED_ARGS);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success). Shapes: q/out
// (B, H, hd); pools (N, bs, KV, hd); scales (N, bs, KV) or null; tables
// (B, M); ctx (B,); window: 0 (none) or the tokens a row attends to, its
// last; scratch: float32, B * KV * ceil(M * bs / CHUNK) * (g * hd + 4
// ceil(2 g / 4)) for g = H / KV; counters: int32, B * KV, zero (and left
// zero). All contiguous, pools 16-byte aligned, checked by the Python
// wrapper.
extern "C" int paged_attention(const void* q, const void* k_pool,
                               const void* v_pool, const void* k_scale,
                               const void* v_scale, const void* tables,
                               const void* ctx_lens, void* out,
                               void* scratch, void* counters, int q_dtype,
                               int kv_dtype, int B, int H, int KV, int hd,
                               int bs, int M, int window, float scale,
                               void* stream) {
  if (H % KV != 0 || KV <= 0 || window < 0) return cudaErrorInvalidValue;
  if (H / KV > (hd >= 256 ? max_group<256>() : max_group<64>()))
    return cudaErrorInvalidValue;
  const void *q_ = q, *kp = k_pool, *vp = v_pool;
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int32_t* tables_ = static_cast<const int32_t*>(tables);
  const int32_t* ctx = static_cast<const int32_t*>(ctx_lens);
  float* scratch_ = static_cast<float*>(scratch);
  int* counters_ = static_cast<int*>(counters);
  cudaStream_t stream_ = static_cast<cudaStream_t>(stream);
#define PAGED_CALL(TQ)                                                     \
  by_hd<TQ>(hd, kv_dtype, q_dtype, q_, kp, vp, ks, vs, tables_, ctx, out, \
            scratch_, counters_, B, H, KV, bs, M, window, scale, stream_)
  switch (q_dtype) {
    case rt::F32: return PAGED_CALL(float);
    case rt::BF16: return PAGED_CALL(__nv_bfloat16);
    case rt::F16: return PAGED_CALL(__half);
  }
#undef PAGED_CALL
  return cudaErrorInvalidValue;
}
