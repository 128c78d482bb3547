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
// zeros rather than the TPU kernel's unspecified values. It runs on every
// engine admission, prefix-cache hit and speculative verify.
//
// What bounds it on the H100: at serving shapes (a few rows of <= 256
// suffix tokens over <= 512 cached tokens) the work is small: ~4 H hd
// flops per query-key pair on bytes read about once, so the bytes bound is
// a fraction of a microsecond and what a kernel can reach is set by how
// much of the card it fills and how short its chain of tiles is.
//
// Two kernels, chosen by dtype in kernels/paged_prefill.py:
//
// paged_prefill_wgmma_kernel (bf16 / f16 q, over a pool of q's dtype or an
// int8 / fp8-e4m3 pool with its float32 scales: the serving path): one
// warpgroup per block. A block owns (row n, KV head, a run of PB = 64 /
// group suffix positions), and its 64 wgmma rows are (position,
// head-in-group) pairs, position-major, so one K/V tile serves the whole
// GQA group and a short verify chain fills one tile (rows past the last
// whole position hold zeros and are never written). Q lands once by TMA,
// one 5-D box per 16-column panel over q (N, Ls, H, hd). The keys come in
// 64-key tiles through a two-stage ring (tile j + 1 loads while tile j is
// computed): first the pool positions below starts[n], then the suffix,
// causally, skipping tiles no query of the block can see. A 16-bit pool
// tile is gathered by TMA as 8-row runs of consecutive pool rows, one box
// per run through tables[n, t / bs] (the lanes of warp 0 issue them
// together), into a layout whose 8-row groups are wgmma's core-matrix
// groups, so one descriptor stride covers runs from different blocks; this
// needs bs % 8 == 0 (16 in the engine, 2048 for one block a row), and
// other block sizes (4 in the tests) are gathered by the block's threads
// into the same layout. A suffix tile is one box over k/v_suf (N, Ls, KV,
// hd). S = Q K^T and O += P V run on wgmma as in flash_attention.cu's
// tensor-core kernel: float32 scores and online softmax on the accumulator
// fragment, P rounded as hi + lo halves and multiplied twice (one rounding
// breaks chip_smoke.py's 2-ulp gate; tests/test_torch_kernels.py::
// test_paged_prefill_single_bf16_p_breaks_the_bf16_gate). Keys a row may
// not see are selected out of S; K/V rows past starts (pool) or past
// lengths - starts (suffix) are zeroed in shared memory before the
// products, since P = 0 times a stale NaN in V is a NaN on the tensor
// cores.
//
// Over an int8 / fp8 pool the codes enter the tensor cores unrounded:
// every int8 code (|c| <= 127) and every finite e4m3 value is exact in
// bf16 and in f16, and the scale is one float32 per pool row (slot, KV
// head), so it factors out of both products: q . (c_j s_j) = (q . c_j) s_j
// and sum_j p_j (c_j t_j) = sum_j (p_j t_j) c_j. The block's threads read
// a pool tile's 1-byte rows (16 codes a load, through tables[n, t / bs]),
// convert them in registers and store them as 16-bit values into the same
// run-major swizzled layout, beside the tile's 64 K and 64 V scales. Score
// column j is multiplied by k_scale_j in float32 on the accumulator
// fragment before the softmax, and P's column j by v_scale_j before its hi
// + lo split, so the only rounding is the one the 16-bit route has
// (ref.paged_prefill_tiled_ref orders the work the same way on the CPU).
// Rows no query of the block may see get code 0 and scale 0: an fp8 NaN
// code or a stale NaN scale must add nothing. The gather is synchronous
// (the suffix tiles keep the TMA ring): a pool tile waits for its loads,
// one round trip to L2 / HBM, before its products, which is what bounds
// this route at serving shapes beside the launch itself.
//
// What bounds it on the H100: at serving shapes (a few rows of <= 256
// suffix tokens over <= 512 cached tokens) the work is small: ~4 H hd
// flops per query-key pair on bytes read about once, so the bytes bound is
// a fraction of a microsecond and what a kernel can reach is set by how
// much of the card it fills and how short its chain of tiles is. It
// replaced, for 16-bit q, the CUDA-core kernel below, which folded one key
// at a time per thread in float32 on ~48 blocks of 96 threads and spilled
// q and acc at hd 256.
//
// paged_prefill_kernel (float32 q, over a float32, int8 or fp8 pool): the
// CUDA-core kernel of the first port, kept for float32, since TF32 tensor
// cores would break the float32 2e-5 that the card-vs-CPU phases hold. One
// block per (row, KV head, q-tile of BQ positions) holding all group * BQ
// query rows of that tile (one thread per query row, q and acc in
// registers), so every K/V tile staged in shared memory serves the whole
// GQA group. Inside the block a loop replaces the TPU kernel's sequential
// "arbitrary" key axis: first the pool tokens below starts (each token's
// block id read from the table; int8 / fp8 dequantized in-register), then
// the suffix tiles, skipping tiles above the causal diagonal. Shared memory
// holds two TK x hd float tiles (TK = 32 keys up to hd 128, 16 at hd 256).
// At hd 256 a thread's q and acc (512 floats) spill to local memory.
// Masked keys are never read, so stale or non-finite pool contents cannot
// leak into the result.

#include <type_traits>

#include "async_copy.cuh"
#include "common.cuh"
#include "wgmma.cuh"

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

template <int HD>
cudaError_t by_pool(int kv_dtype, const Args& a) {
  if (kv_dtype == rt::F32) return launch<float, float, HD, false>(a);
  if (kv_dtype == rt::I8) return launch<float, int8_t, HD, true>(a);
  if (kv_dtype == rt::FP8_E4M3) return launch<float, __nv_fp8_e4m3, HD, true>(a);
  return cudaErrorInvalidValue;
}

cudaError_t by_hd(int hd, int kv_dtype, const Args& a) {
  if (hd == 16) return by_pool<16>(kv_dtype, a);
  if (hd == 64) return by_pool<64>(kv_dtype, a);
  if (hd == 80) return by_pool<80>(kv_dtype, a);
  if (hd == 128) return by_pool<128>(kv_dtype, a);
  if (hd == 256) return by_pool<256>(kv_dtype, a);
  return cudaErrorInvalidValue;
}

}  // namespace

// float32 q: the CUDA-core kernel. Returns the cudaError_t of the launch
// (0 = success). Shapes: q/out (N, Ls, H, hd); k_suf/v_suf (N, Ls, KV,
// hd) in q's dtype; pools (P, bs, KV, hd); scales (P, bs, KV) or null;
// tables (N, M); starts / lengths (N,). All contiguous, checked by the
// Python wrapper.
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
  if (q_dtype != rt::F32) return cudaErrorInvalidValue;
  return by_hd(hd, kv_dtype, a);
}

// ---------------------------------------------------------------------------
// bf16 / f16 q over a pool of q's dtype or an int8 / fp8 pool: wgmma
// ---------------------------------------------------------------------------

namespace {

constexpr int WM = 64;  // a block's rows: (position, head-in-group) pairs
constexpr int BN = 64;  // keys a tile (kernels/build.py:FLASH_KEY_TILE)
// Shared memory beyond the tiles: three mbarriers (Q, and one a stage),
// padded to 32 bytes, then (1-byte pools) a stage's 64 K and 64 V scales
// for each of the two stages, then the row's block ids.
constexpr int BAR_BYTES = 32;

template <int QP>
__host__ __device__ constexpr int scale_bytes() {
  return QP ? 2 * 2 * BN * 4 : 0;
}

template <typename T, int HD>
__host__ __device__ constexpr size_t wg_tile_bytes() {  // Q + 2 x (K, V)
  return (size_t)(WM + 4 * BN) * HD * sizeof(T);
}

using wg::ex2;
using wg::pack2;
using wg::unpack2;

// Two 1-byte pool codes (the first in the low byte) as a packed pair of T,
// exactly: int8 codes are integers of at most 7 bits, e4m3 values have 4
// significant bits and exponents inside bf16's and f16's ranges.
template <int QP>
__device__ __forceinline__ uint32_t codes2(uint32_t x, __nv_bfloat16* tp) {
  if (QP == rt::I8)
    return pack2((float)(int8_t)(x & 0xff), (float)(int8_t)(x >> 8), tp);
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
      (__nv_fp8x2_storage_t)(x & 0xffff), __NV_E4M3);
  const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&h));
  return pack2(f.x, f.y, tp);
}
template <int QP>
__device__ __forceinline__ uint32_t codes2(uint32_t x, __half* tp) {
  if (QP == rt::I8)
    return pack2((float)(int8_t)(x & 0xff), (float)(int8_t)(x >> 8), tp);
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
      (__nv_fp8x2_storage_t)(x & 0xffff), __NV_E4M3);
  return (uint32_t)h.x | ((uint32_t)h.y << 16);
}

// 16 codes (one 16-column panel of a pool row) as that panel's 32 bytes
// of 16-bit values, stored at `at` in the 32-byte swizzle of row r.
template <int QP, typename T>
__device__ __forceinline__ void store_codes(unsigned char* dst, uint32_t at,
                                            int r, uint4 x) {
  T* const tp = nullptr;
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
  uint32_t o[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = codes2<QP>(w[i] & 0xffff, tp);
    o[2 * i + 1] = codes2<QP>(w[i] >> 16, tp);
  }
  const uint32_t sw = ((r >> 2) & 1) << 4;
  *reinterpret_cast<uint4*>(dst + at + sw) = make_uint4(o[0], o[1], o[2], o[3]);
  *reinterpret_cast<uint4*>(dst + at + (16 ^ sw)) =
      make_uint4(o[4], o[5], o[6], o[7]);
}

// Tile layouts in shared memory, 32-byte rows of 16 columns, 32-byte
// swizzled (a row's two 16-byte halves swapped in rows 4-7 of each 8):
//   panel-major (Q, suffix tiles): panel p of 64 rows at p * 2048 bytes;
//   run-major (pool tiles): 8-row run g at g * RUN, its panel p at + p * 256
//     (RUN = hd / 16 * 256), so a run of pool rows is one contiguous box.
// Both are wgmma descriptors with a stride between 8-row groups (256 or
// RUN) and between 16-column panels (2048 or 256). QP is the pool's dtype
// code for an int8 / fp8 pool (rt::I8, rt::FP8_E4M3), 0 for a pool of T.
template <typename T, int HD, int QP>
__global__ void __launch_bounds__(128)
    paged_prefill_wgmma_kernel(
        const __grid_constant__ CUtensorMap tq,
        const __grid_constant__ CUtensorMap tks,
        const __grid_constant__ CUtensorMap tvs,
        const __grid_constant__ CUtensorMap tkp,
        const __grid_constant__ CUtensorMap tvp,
        const unsigned char* __restrict__ k_pool,
        const unsigned char* __restrict__ v_pool,
        const float* __restrict__ k_scale, const float* __restrict__ v_scale,
        const int32_t* __restrict__ tables,
        const int32_t* __restrict__ starts,
        const int32_t* __restrict__ lengths, T* __restrict__ out, int Ls,
        int H, int KV, int bs, int M, int window, int pb, int tma_pool,
        float scale_log2) {
  constexpr int NS = HD / 16;       // k-steps of Q.K^T, panels of a tile
  constexpr int NP = BN / 16;       // k-steps of P.V
  constexpr uint32_t SW32 = 3;      // descriptor mode: 32-byte swizzle
  constexpr uint32_t PANEL = WM * 32;
  constexpr uint32_t TILE = NS * PANEL;
  constexpr uint32_t RUN = NS * 256;
  constexpr int ES = QP ? 1 : sizeof(T);  // bytes of a pool element
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sq = smem_raw;
  unsigned char* sk = sq + TILE;   // two stages
  unsigned char* sv = sk + 2 * TILE;  // two stages
  uint64_t* bar = reinterpret_cast<uint64_t*>(sv + 2 * TILE);
  uint64_t* full = bar + 1;        // tile in stage 0 / 1 landed
  float* ssc = reinterpret_cast<float*>(sv + 2 * TILE + BAR_BYTES);
  int* stab = reinterpret_cast<int*>(sv + 2 * TILE + BAR_BYTES +
                                     scale_bytes<QP>());
  T* const tp = nullptr;           // selects pack2 / unpack2 for T
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tq_ = lane & 3;
  const int n = blockIdx.z, kvh = blockIdx.y;
  const int group = H / KV;
  const int i0 = blockIdx.x * pb;          // the block's first position
  const int nrows = pb * group;            // rows that hold a query
  const int i_hi = min(i0 + pb, Ls) - 1;   // its last position
  const int st = starts[n];
  const int ln_s = lengths[n] - st;        // valid suffix tokens
  const int pool_end = min(st, M * bs);
  // the tiles some query of the block can see: pool tiles [p0, p1), then
  // suffix tiles [s0, s1)
  const int t_lo = window > 0 ? max(0, st + i0 - window + 1) : 0;
  const int u_lo = window > 0 ? max(0, i0 - window + 1) : 0;
  const int u_end = min(min(ln_s, Ls), i_hi + 1);
  const int p0 = t_lo / BN;
  const int p1 = t_lo < pool_end ? (pool_end + BN - 1) / BN : p0;
  const int s0 = u_lo / BN;
  const int s1 = u_lo < u_end ? (u_end + BN - 1) / BN : s0;
  const int np = p1 - p0, nt = np + s1 - s0;

  // the row's block ids; Q's rows past nrows zeroed (never written by TMA)
  for (int e = threadIdx.x; e < (pool_end + bs - 1) / bs; e += 128)
    stab[e] = tables[(size_t)n * M + e];
  for (int e = threadIdx.x; e < NS * (WM - nrows) * 2; e += 128) {
    const int p = e / ((WM - nrows) * 2), r = e % ((WM - nrows) * 2);
    reinterpret_cast<uint4*>(sq + p * PANEL + (nrows + r / 2) * 32)[r & 1] =
        make_uint4(0, 0, 0, 0);
  }
  tma::fence_proxy_async();
  if (threadIdx.x == 0) {
    for (int i = 0; i < 3; ++i) tma::init(bar + i, 1);
    tma::fence_init();
  }
  __syncthreads();

  // Issued by the 32 lanes of warp 0: tile j's K and V into `stage`. A
  // pool tile through TMA is one box of 8 rows per run that holds a key
  // below pool_end (lanes 2 g and 2 g + 1: run g's K and V); a pool tile
  // the threads gather only arrives on the barrier.
  auto fetch = [&](int j, int stage) {
    uint64_t* fb = full + stage;
    unsigned char* kd = sk + stage * TILE;
    unsigned char* vd = sv + stage * TILE;
    if (j < np) {
      const int t0 = (p0 + j) * BN;
      if (!tma_pool) {
        if (lane == 0) tma::arrive(fb);
        return;
      }
      const int runs = min(BN, pool_end - t0 + 7) / 8;
      if (lane == 0) tma::expect_tx(fb, runs * 2 * RUN);
      __syncwarp();
      if (lane < 2 * runs) {
        const int t = t0 + 8 * (lane >> 1);
        const int row = stab[t / bs] * bs + t % bs;
        tma::load_4d((lane & 1 ? vd : kd) + (lane >> 1) * RUN,
                     lane & 1 ? &tvp : &tkp, 0, row, 0, kvh, fb);
      }
    } else if (lane == 0) {
      const int u0 = (s0 + j - np) * BN;
      tma::expect_tx(fb, 2 * TILE);
      tma::load_5d(kd, &tks, 0, u0, 0, kvh, n, fb);
      tma::load_5d(vd, &tvs, 0, u0, 0, kvh, n, fb);
    }
  };
  if (warp == 0) {
    // Q: one box of (16 columns, the group's heads, pb positions) a panel
    if (lane == 0) tma::expect_tx(bar, NS * nrows * 32);
    __syncwarp();
    for (int p = lane; p < NS; p += 32)
      tma::load_5d(sq + p * PANEL, &tq, 0, kvh * group, i0, p, n, bar);
    if (nt > 0) fetch(0, 0);
  }

  // Q: K-major, a k-step is one panel
  const uint64_t dq = wg::desc(sq, 16, 256, SW32);
  float o[HD / 2], s[BN / 2];
#pragma unroll
  for (int e = 0; e < HD / 2; ++e) o[e] = 0.f;
  float m[2] = {rt::NEG_INF, rt::NEG_INF}, l[2] = {0.f, 0.f};
  const int row = 16 * warp + lane / 4;  // and row + 8
  const int ipos[2] = {i0 + row / group, i0 + (row + 8) / group};
  tma::wait(bar, 0);

#pragma unroll 1
  for (int j = 0; j < nt; ++j) {
    const int stg = j & 1;
    if (warp == 0 && j + 1 < nt) fetch(j + 1, stg ^ 1);
    tma::wait(full + stg, (j >> 1) & 1);
    const bool pool = j < np;
    const int k0 = pool ? (p0 + j) * BN : (s0 + j - np) * BN;
    unsigned char* kd = sk + stg * TILE;
    unsigned char* vd = sv + stg * TILE;
    float* ksc = ssc + stg * 2 * BN;   // 1-byte pools: the tile's scales
    float* vsc = ksc + BN;
    if (pool && QP) {
      // the threads read the 1-byte rows some query of the block may see
      // (code 0 and scale 0 elsewhere), 16 codes a load, all loads first,
      // and store them as 16-bit values into the run-major swizzled layout
      constexpr int ITEMS = (BN * NS + 127) / 128;
      uint4 kx[ITEMS], vx[ITEMS];
#pragma unroll
      for (int it = 0; it < ITEMS; ++it) {
        const int e = threadIdx.x + 128 * it, r = e / NS, t = k0 + r;
        kx[it] = vx[it] = make_uint4(0, 0, 0, 0);
        if (e < BN * NS && t >= t_lo && t < pool_end) {
          const size_t off =
              (((size_t)stab[t / bs] * bs + t % bs) * KV + kvh) * HD +
              (e % NS) * 16;
          kx[it] = *reinterpret_cast<const uint4*>(k_pool + off);
          vx[it] = *reinterpret_cast<const uint4*>(v_pool + off);
        }
      }
      if (threadIdx.x < BN) {
        const int t = k0 + threadIdx.x;
        float a = 0.f, b = 0.f;
        if (t >= t_lo && t < pool_end) {
          const size_t sr = ((size_t)stab[t / bs] * bs + t % bs) * KV + kvh;
          a = k_scale[sr];
          b = v_scale[sr];
        }
        ksc[threadIdx.x] = a;
        vsc[threadIdx.x] = b;
      }
#pragma unroll
      for (int it = 0; it < ITEMS; ++it) {
        const int e = threadIdx.x + 128 * it, r = e / NS, p = e % NS;
        if (e < BN * NS) {
          const uint32_t at = (r / 8) * RUN + p * 256 + (r % 8) * 32;
          store_codes<QP, T>(kd, at, r, kx[it]);
          store_codes<QP, T>(vd, at, r, vx[it]);
        }
      }
      tma::fence_proxy_async();
      __syncthreads();
    } else if (pool && !tma_pool) {
      // the threads gather the pool rows below pool_end (zeros past it),
      // 16 bytes at a time, into the run-major swizzled layout
      for (int e = threadIdx.x; e < BN * HD / 8; e += 128) {
        const int r = e / (HD / 8), ch = e % (HD / 8), t = k0 + r;
        uint4 kx = make_uint4(0, 0, 0, 0), vx = kx;
        if (t < pool_end) {
          const size_t off =
              ((((size_t)stab[t / bs] * bs + t % bs) * KV + kvh) * HD +
               ch * 8) * ES;
          kx = *reinterpret_cast<const uint4*>(k_pool + off);
          vx = *reinterpret_cast<const uint4*>(v_pool + off);
        }
        const uint32_t at = (r / 8) * RUN + (ch / 2) * 256 + (r % 8) * 32 +
                            (((ch & 1) ^ ((r >> 2) & 1)) << 4);
        *reinterpret_cast<uint4*>(kd + at) = kx;
        *reinterpret_cast<uint4*>(vd + at) = vx;
      }
      tma::fence_proxy_async();
      __syncthreads();
    } else {
      // zero the rows of keys past pool_end / past the valid suffix: they
      // may hold stale or non-finite values, which P = 0 would not cancel
      const int valid = max(pool ? pool_end - k0 : ln_s - k0, 0);
      if (valid < BN) {
        for (int e = threadIdx.x; e < (BN - valid) * NS; e += 128) {
          const int r = valid + e / NS, p = e % NS;
          const uint32_t at = pool ? (r / 8) * RUN + p * 256 + (r % 8) * 32
                                   : p * PANEL + r * 32;
          uint4* dk = reinterpret_cast<uint4*>(kd + at);
          uint4* dv = reinterpret_cast<uint4*>(vd + at);
          dk[0] = dk[1] = dv[0] = dv[1] = make_uint4(0, 0, 0, 0);
        }
        tma::fence_proxy_async();
        __syncthreads();
      }
    }

    // S = Q K^T
    const uint64_t dk = wg::desc(kd, 16, pool ? RUN : 256, SW32);
    const uint32_t kstep = pool ? 256 : PANEL;
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) s[e] = 0.f;
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < NS; ++kk)
      wg::mma_ss<T, BN>(s, dq + kk * (PANEL >> 4), dk + kk * (kstep >> 4),
                        kk > 0);
    wg::commit();
    wg::wait<0>();
    wg::keep(s);
    if (QP && pool) {
      // S's column j times k_scale_j: the pool rows' dequantization
#pragma unroll
      for (int c = 0; c < BN / 8; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float sc = ksc[8 * c + 2 * tq_ + e];
          s[4 * c + e] *= sc;
          s[4 * c + 2 + e] *= sc;
        }
    }

    // mask (tiles some key of which a query of the block may not see)
    const bool edge =
        pool ? k0 + BN > pool_end || (window > 0 && k0 <= st + i_hi - window)
             : k0 + BN - 1 > i0 || k0 + BN > ln_s ||
                   (window > 0 && k0 <= i_hi - window);
    if (edge) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = ipos[r];
#pragma unroll
        for (int c = 0; c < BN / 8; ++c)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = k0 + 8 * c + 2 * tq_ + e;
            const bool ok =
                pool ? key < pool_end && (window <= 0 || key > st + i - window)
                     : key <= i && key < ln_s &&
                           (window <= 0 || key > i - window);
            if (!ok) s[4 * c + 2 * r + e] = -INFINITY;
          }
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
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
        const float q0 = ex2(fmaf(s[4 * c + 2 * r], scale_log2, -m_new));
        const float q1 = ex2(fmaf(s[4 * c + 2 * r + 1], scale_log2, -m_new));
        s[4 * c + 2 * r] = q0;
        s[4 * c + 2 * r + 1] = q1;
        sum0 += q0;
        sum1 += q1;
      }
      l[r] = l[r] * alpha[r] + (sum0 + sum1);
    }
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int c = 0; c < HD / 8; ++c) {
        o[4 * c] *= alpha[0];
        o[4 * c + 1] *= alpha[0];
        o[4 * c + 2] *= alpha[1];
        o[4 * c + 3] *= alpha[1];
      }
    }
    if (QP && pool) {
      // P's column j times v_scale_j (l keeps the unscaled sum), before
      // the hi + lo split: O += (P t) C_v
#pragma unroll
      for (int c = 0; c < BN / 8; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float sc = vsc[8 * c + 2 * tq_ + e];
          s[4 * c + e] *= sc;
          s[4 * c + 2 + e] *= sc;
        }
    }

    // P as wgmma A fragments, hi and lo halves; O += P_hi V + P_lo V. V is
    // MN-major: 16-column panels (2048 or 256 bytes apart) across hd, 8-key
    // groups (256 or RUN apart) down a k-step of 16 keys
    uint32_t ph[NP * 4], pl[NP * 4];
#pragma unroll
    for (int e = 0; e < NP * 4; ++e) {
      ph[e] = pack2(s[2 * e], s[2 * e + 1], tp);
      const float2 hi = unpack2(ph[e], tp);
      pl[e] = pack2(s[2 * e] - hi.x, s[2 * e + 1] - hi.y, tp);
    }
    const uint64_t dv = pool ? wg::desc(vd, 256, RUN, SW32)
                             : wg::desc(vd, PANEL, 256, SW32);
    const uint32_t vstep = pool ? 2 * RUN : 512;
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < NP; ++kk)
      wg::mma_rs<T, HD>(o, ph + 4 * kk, dv + kk * (vstep >> 4));
#pragma unroll
    for (int kk = 0; kk < NP; ++kk)
      wg::mma_rs<T, HD>(o, pl + 4 * kk, dv + kk * (vstep >> 4));
    wg::commit();
    wg::wait<0>();
    wg::keep(o);
    wg::keep(ph);
    wg::keep(pl);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float den = fmaxf(sum, 1e-30f);
    const int rr = row + 8 * r, i = ipos[r];
    if (rr < nrows && i < Ls) {
      T* orow = out + (((size_t)n * Ls + i) * H + kvh * group + rr % group) *
                          HD + 2 * tq_;
#pragma unroll
      for (int c = 0; c < HD / 8; ++c)
        *reinterpret_cast<uint32_t*>(orow + 8 * c) =
            pack2(o[4 * c + 2 * r] / den, o[4 * c + 2 * r + 1] / den, tp);
    }
  }
}

struct WArgs {
  const void *q, *ks_, *vs_, *kp, *vp;
  const float *ksc, *vsc;
  const int32_t *tables, *starts, *lengths;
  void* out;
  int N, Ls, H, KV, P, bs, M, window;
  float scale;
  cudaStream_t stream;
};

template <typename T, int HD, int QP>
cudaError_t launch_wgmma(const WArgs& a) {
  constexpr cuuint64_t E = sizeof(T);
  const int group = a.H / a.KV;
  if (group > WM) return cudaErrorInvalidValue;
  const int pb = WM / group;
  const cuuint64_t N = a.N, Ls = a.Ls, H = a.H, KV = a.KV;
  // q (N, Ls, H, hd) as (16 columns, heads, positions, panels, rows)
  const cuuint64_t qd[5] = {16, H, Ls, HD / 16, N};
  const cuuint64_t qs[4] = {HD * E, H * HD * E, 16 * E, Ls * H * HD * E};
  const cuuint32_t qb[5] = {16, (cuuint32_t)group, (cuuint32_t)pb, 1, 1};
  // k/v_suf (N, Ls, KV, hd) as (16 columns, positions, panels, KV heads,
  // rows): a box is 64 positions of every panel
  const cuuint64_t sd[5] = {16, Ls, HD / 16, KV, N};
  const cuuint64_t ss[4] = {KV * HD * E, 16 * E, HD * E, Ls * KV * HD * E};
  const cuuint32_t sb[5] = {16, BN, HD / 16, 1, 1};
  // pools of T (P, bs, KV, hd) as (16 columns, pool rows, panels, KV
  // heads): a box is one 8-row run of every panel
  const cuuint64_t pd[4] = {16, (cuuint64_t)a.P * a.bs, HD / 16, KV};
  const cuuint64_t ps[3] = {KV * HD * E, 16 * E, HD * E};
  const cuuint32_t pbx[4] = {16, 8, HD / 16, 1};
  constexpr bool f16 = std::is_same<T, __half>::value;
  const bool tma_pool = QP == 0 && a.bs % 8 == 0;
  CUtensorMap tq, tks, tvs, tkp, tvp;
  cudaError_t e = tma::map_sw32(&tq, f16, a.q, 5, qd, qs, qb);
  if (e == cudaSuccess) e = tma::map_sw32(&tks, f16, a.ks_, 5, sd, ss, sb);
  if (e == cudaSuccess) e = tma::map_sw32(&tvs, f16, a.vs_, 5, sd, ss, sb);
  if (e != cudaSuccess) return e;
  if (tma_pool) {
    e = tma::map_sw32(&tkp, f16, a.kp, 4, pd, ps, pbx);
    if (e == cudaSuccess) e = tma::map_sw32(&tvp, f16, a.vp, 4, pd, ps, pbx);
    if (e != cudaSuccess) return e;
  } else {
    tkp = tks;  // never read: the threads gather the pool
    tvp = tvs;
  }
  constexpr int SMEM_MAX = 232448;  // an H100 block's dynamic limit
  static bool opted_in = false;
  if (!opted_in) {
    e = cudaFuncSetAttribute(paged_prefill_wgmma_kernel<T, HD, QP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_MAX);
    if (e != cudaSuccess) return e;
    opted_in = true;
  }
  const size_t smem = wg_tile_bytes<T, HD>() + BAR_BYTES +
                      scale_bytes<QP>() + (size_t)a.M * 4;
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  dim3 grid((a.Ls + pb - 1) / pb, a.KV, a.N);
  paged_prefill_wgmma_kernel<T, HD, QP><<<grid, 128, smem, a.stream>>>(
      tq, tks, tvs, tkp, tvp, static_cast<const unsigned char*>(a.kp),
      static_cast<const unsigned char*>(a.vp), a.ksc, a.vsc, a.tables,
      a.starts, a.lengths, static_cast<T*>(a.out), a.Ls, a.H, a.KV, a.bs,
      a.M, a.window, pb, tma_pool, a.scale * 1.4426950408889634f);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t wgmma_by_pool(int dtype, int kv_dtype, const WArgs& a) {
  if (kv_dtype == dtype) return launch_wgmma<T, HD, 0>(a);
  if (a.ksc == nullptr || a.vsc == nullptr) return cudaErrorInvalidValue;
  if (kv_dtype == rt::I8) return launch_wgmma<T, HD, rt::I8>(a);
  if (kv_dtype == rt::FP8_E4M3) return launch_wgmma<T, HD, rt::FP8_E4M3>(a);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t wgmma_by_hd(int hd, int dtype, int kv_dtype, const WArgs& a) {
  switch (hd) {
    case 16: return wgmma_by_pool<T, 16>(dtype, kv_dtype, a);
    case 64: return wgmma_by_pool<T, 64>(dtype, kv_dtype, a);
    case 80: return wgmma_by_pool<T, 80>(dtype, kv_dtype, a);
    case 128: return wgmma_by_pool<T, 128>(dtype, kv_dtype, a);
    case 256: return wgmma_by_pool<T, 256>(dtype, kv_dtype, a);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// bf16 / f16 q and suffix over a pool of their dtype, or over an int8 /
// fp8 pool (kv_dtype) with its float32 scale tables: the wgmma kernel.
// Returns the cudaError_t of the launch (0 = success). Shapes as
// paged_prefill's, P the pool's block count; every tensor contiguous and
// 16-byte aligned, H a multiple of KV with H / KV <= 64, checked by the
// Python wrapper.
extern "C" int paged_prefill_wgmma(const void* q, const void* k_suf,
                                   const void* v_suf, const void* k_pool,
                                   const void* v_pool, const void* k_scale,
                                   const void* v_scale, const void* tables,
                                   const void* starts, const void* lengths,
                                   void* out, int dtype, int kv_dtype, int N,
                                   int Ls, int H, int KV, int hd, int P,
                                   int bs, int M, int window, float scale,
                                   void* stream) {
  if (H % KV != 0 || N <= 0 || Ls <= 0) return cudaErrorInvalidValue;
  const WArgs a{q,
                k_suf,
                v_suf,
                k_pool,
                v_pool,
                static_cast<const float*>(k_scale),
                static_cast<const float*>(v_scale),
                static_cast<const int32_t*>(tables),
                static_cast<const int32_t*>(starts),
                static_cast<const int32_t*>(lengths),
                out,
                N,
                Ls,
                H,
                KV,
                P,
                bs,
                M,
                window,
                scale,
                static_cast<cudaStream_t>(stream)};
  if (dtype == rt::BF16)
    return wgmma_by_hd<__nv_bfloat16>(hd, dtype, kv_dtype, a);
  if (dtype == rt::F16) return wgmma_by_hd<__half>(hd, dtype, kv_dtype, a);
  return cudaErrorInvalidValue;
}
