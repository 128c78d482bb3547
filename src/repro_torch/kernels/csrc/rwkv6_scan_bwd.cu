// The gradient of the RWKV6 recurrence for Hopper (sm_90a).
//
// Replaces no TPU kernel: src/repro/kernels/rwkv6_scan.py (the Pallas
// kernel, def :55 / pl.pallas_call :65) is forward only, and the JAX model
// differentiates its lax.scan (src/repro/models/recurrent.py:124). This is
// the backward of csrc/rwkv6_scan.cu, launched by the autograd Function of
// kernels/rwkv6_scan.py when rwkv6-3b trains. Per (batch, head), with the
// forward's states S_{t-1} (S_{-1} = s0) and G_t = dL/dS_t in total,
// starting from G_{T-1} = dS_T, the walk t = T - 1 .. 0 takes
//
//     dr_t = (S_{t-1} + diag(u) k_t^T v_t) dy_t
//     dk_t = r_t * u * (v_t . dy_t) + G_t v_t  = (G_t + (r_t u)^T dy_t) v_t
//     dv_t = (sum_i r_ti u_i k_ti) dy_t + k_t G_t  = k_t (G_t + (r_t u)^T dy_t)
//     du  += r_t * k_t * (v_t . dy_t)            (over B and T)
//     dw_t = rowsum(G_t * S_{t-1})
//     G_{t-1} = diag(w_t) G_t + r_t^T dy_t,      ds0 = G_{-1}
//
// (kernels/ref.py:rwkv6_scan_bwd_ref, its twin). Inputs: r, k, v, dy (B,
// H, T, N) of one dtype, w (B, H, T, N), u (H, N), s0 (B, H, N, N) or
// null, s_steps (B, H, T, N, N) (the forward kernel's per-step states,
// bit-equal to the forward's own), dS_T (B, H, N, N) or null, float32.
// Outputs: dr, dk, dv in r's dtype (accumulated in float32), dw (B, H, T,
// N), du (H, N), ds0 (B, H, N, N) float32.
//
// What bounds it on the H100: the states, N^2 float32 a head a step (1.34
// GB at 4 x 40 x 512 x 64), read once, then ~14 float32 operations per
// state element per step; both recurrences (S forward, G backward) are
// elementwise in (i, j), so nothing but the sums below is sequential.
//
// Design. Column j of S and of G depends only on column j: a block owns
// JC = 16 value columns of one head (grid B * H x N / 16, as the forward's)
// and walks t backward with its G slice in registers, one thread per key
// row i (N threads, one or two warps), each holding G_t[i, j0 .. j0 + 15].
// Row sums over j (dr, dk, dw, du) are then each thread's own serial sums,
// over the block's 16 columns only: they go to per-tile partial buffers
// (du accumulates over t in a register), which a second kernel sums over
// the tiles, and a third over the tiles and the batch (du), in a fixed
// order. Column sums over i (dv) are complete in the block: a warp folds
// its 16 columns x 32 rows in 16 shuffles (each step halves the columns a
// lane holds), and the warps' sums meet in shared memory once a chunk. No
// float atomics anywhere, so two launches give the same bits. Each
// thread's state slice S_{t-1}[i, j0 ..] (64 contiguous bytes) is loaded
// PF steps ahead into a ring of registers; the step vectors (w, r, k for
// every row, v and dy for the block's columns) come a chunk of TC steps
// at a time into shared memory by 16-byte cp.async copies, the next
// chunk's issued before the current chunk's walk.
//
// Inputs must be 16-byte aligned with N a multiple of 8 (the copies'
// rule; kernels/rwkv6_scan.py pads and copies otherwise).

#include <algorithm>

#include "async_copy.cuh"
#include "common.cuh"

namespace {

constexpr int JC = 16;  // value columns per block
constexpr int TC = 16;  // steps per staged chunk
constexpr int PF = 4;   // steps of states in flight per thread
static_assert(TC % PF == 0, "a chunk holds whole rings");

// One staged chunk: w (TC x N float32), r, k (TC x N of T), v, dy
// (TC x JC of T: the block's columns).
template <typename T>
__host__ __device__ constexpr size_t buf_bytes(int N) {
  return (size_t)TC * N * 4 + 2 * (size_t)TC * N * sizeof(T) +
         2 * (size_t)TC * JC * sizeof(T);
}
// two chunk buffers, then each warp's dv column sums of a chunk
template <typename T>
__host__ __device__ constexpr size_t smem_bytes(int N, int nw) {
  return 2 * buf_bytes<T>(N) + (size_t)TC * nw * JC * 4;
}

template <typename T, int N>
__global__ void __launch_bounds__(32 * ((N + 31) / 32))
    rwkv6_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ w,
                     const float* __restrict__ u,
                     const float* __restrict__ s0,
                     const float* __restrict__ s_steps,
                     const T* __restrict__ dy,
                     const float* __restrict__ dS_T, T* __restrict__ dv,
                     float* __restrict__ ds0, float* __restrict__ parts,
                     float* __restrict__ du_parts, int H, int Tn) {
  constexpr int NW = (N + 31) / 32, NT = 32 * NW;
  extern __shared__ __align__(128) unsigned char smem[];
  const int bh = blockIdx.x, tile = blockIdx.y, tiles = gridDim.y;
  const int BH = gridDim.x;
  const int j0 = tile * JC, width = min(JC, N - j0);
  const int i = threadIdx.x, lane = i % 32, warp = i / 32;
  const bool valid = i < N;
  const size_t bb = buf_bytes<T>(N);
  float* dvred = reinterpret_cast<float*>(smem + 2 * bb);
  const size_t in0 = (size_t)bh * Tn * N;  // the head's first input row

  auto sw = [&](int b) { return reinterpret_cast<float*>(smem + b * bb); };
  auto sr = [&](int b) {
    return reinterpret_cast<T*>(smem + b * bb + (size_t)TC * N * 4);
  };
  auto sk = [&](int b) { return sr(b) + TC * N; };
  auto sv = [&](int b) { return sr(b) + 2 * TC * N; };
  auto sd = [&](int b) { return sr(b) + 2 * TC * N + TC * JC; };

  // the columns past `width` of v and dy stay zero
  for (int e = i; e < 2 * 2 * TC * JC; e += NT) {
    const int b = e / (2 * TC * JC), o = e % (2 * TC * JC);
    sv(b)[o] = rt::from_f<T>(0.f);
  }
  __syncthreads();  // before any copy lands in those buffers
  // chunk q (processing index p = q * TC + m, step t = Tn - 1 - p) into
  // buffer q % 2 by 16-byte cp.async pieces, row m holding step t
  auto stage = [&](int q) {
    const int b = q & 1, rows = min(TC, Tn - q * TC);
    constexpr int PW = N / 4;                       // pieces of a w row
    constexpr int PR = N * (int)sizeof(T) / 16;     // of an r / k row
    const int PV = width * (int)sizeof(T) / 16;     // of a v / dy slice
    const int per = PW + 2 * PR + 2 * PV;
    for (int e = i; e < rows * per; e += NT) {
      const int m = e / per, o = e % per;
      const size_t row = in0 + (size_t)(Tn - 1 - q * TC - m) * N;
      if (o < PW) {
        tma::cp_async_16(sw(b) + m * N + o * 4, w + row + o * 4);
      } else if (o < PW + 2 * PR) {
        const int x = o - PW, which = x / PR, c = (x % PR) * (16 / sizeof(T));
        tma::cp_async_16((which ? sk(b) : sr(b)) + m * N + c,
                         (which ? k : r) + row + c);
      } else {
        const int x = o - PW - 2 * PR, which = x / PV;
        const int c = (x % PV) * (16 / sizeof(T));
        tma::cp_async_16((which ? sd(b) : sv(b)) + m * JC + c,
                         (which ? dy : v) + row + j0 + c);
      }
    }
  };
  // S_{t-1}[i, j0 .. j0 + 15] (zeros past the columns and rows)
  auto load_state = [&](float (&d)[JC], int t) {
    const float* src =
        t > 0 ? s_steps + ((size_t)bh * Tn + (t - 1)) * N * N
              : s0 != nullptr ? s0 + (size_t)bh * N * N : nullptr;
#pragma unroll
    for (int q = 0; q < JC / 4; ++q) {
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (src != nullptr && valid && 4 * q < width)
        x = *reinterpret_cast<const float4*>(src + (size_t)i * N + j0 +
                                             4 * q);
      d[4 * q] = x.x;
      d[4 * q + 1] = x.y;
      d[4 * q + 2] = x.z;
      d[4 * q + 3] = x.w;
    }
  };

  float G[JC];
#pragma unroll
  for (int c = 0; c < JC; ++c)
    G[c] = dS_T != nullptr && valid && c < width
               ? dS_T[((size_t)bh * N + i) * N + j0 + c]
               : 0.f;
  const float ui = valid ? u[(bh % H) * N + i] : 0.f;
  float ring[PF][JC];
#pragma unroll
  for (int s = 0; s < PF; ++s)
    if (s < Tn) load_state(ring[s], Tn - 1 - s);
  const int nch = (Tn + TC - 1) / TC;
  if (nch > 0) stage(0);
  tma::cp_async_wait_all();
  __syncthreads();

  const size_t E = (size_t)BH * Tn * N;  // elements of one partial array
  float* pr = parts + (size_t)tile * E;
  float* pk = parts + (size_t)(tiles + tile) * E;
  float* pw = parts + (size_t)(2 * tiles + tile) * E;
  float duacc = 0.f;
#pragma unroll 1
  for (int q = 0; q < nch; ++q) {
    const int b = q & 1, rows = min(TC, Tn - q * TC);
    if (q + 1 < nch) stage(q + 1);
#pragma unroll 1
    for (int m0 = 0; m0 < rows; m0 += PF) {
#pragma unroll
      for (int s = 0; s < PF; ++s) {
        const int m = m0 + s;
        if (m < rows) {
          const int p = q * TC + m, t = Tn - 1 - p;
          const float ri = valid ? rt::to_f(sr(b)[m * N + i]) : 0.f;
          const float ki = valid ? rt::to_f(sk(b)[m * N + i]) : 0.f;
          const float wi = valid ? sw(b)[m * N + i] : 0.f;
          const T* vs = sv(b) + m * JC;
          const T* ds = sd(b) + m * JC;
          const float ru = ri * ui, uk = ui * ki;
          float dr = 0.f, dk = 0.f, dw = 0.f, vd = 0.f, dvc[JC];
#pragma unroll
          for (int c = 0; c < JC; ++c) {
            const float vc = rt::to_f(vs[c]), dc = rt::to_f(ds[c]);
            const float S = ring[s][c];
            const float A = G[c] + ru * dc;
            dk += A * vc;
            dvc[c] = ki * A;
            dr += (S + uk * vc) * dc;
            dw += G[c] * S;
            vd += vc * dc;
            G[c] = wi * G[c] + ri * dc;
          }
          duacc += ri * ki * vd;
          if (valid) {
            const size_t o = in0 + (size_t)t * N + i;
            pr[o] = dr;
            pk[o] = dk;
            pw[o] = dw;
          }
          // the warp's column sums: each round a lane hands half its
          // columns to the lane 2n away and keeps the other half, so lane
          // l ends with column l / 2 summed over its 16 lanes, then over
          // the pair
#pragma unroll
          for (int n = JC / 2; n >= 1; n /= 2) {
            const bool up = lane & (2 * n);
#pragma unroll
            for (int c = 0; c < n; ++c) {
              const float send = up ? dvc[c] : dvc[c + n];
              const float keep = up ? dvc[c + n] : dvc[c];
              dvc[c] = keep + __shfl_xor_sync(0xffffffffu, send, 2 * n);
            }
          }
          dvc[0] += __shfl_xor_sync(0xffffffffu, dvc[0], 1);
          if (lane % 2 == 0) dvred[(m * NW + warp) * JC + lane / 2] = dvc[0];
          if (p + PF < Tn) load_state(ring[s], t - PF);
        }
      }
    }
    tma::cp_async_wait_all();
    __syncthreads();  // chunk q + 1 landed, chunk q's warp sums written
    for (int e = i; e < rows * JC; e += NT) {
      const int m = e / JC, c = e % JC;
      if (c < width) {
        float sum = dvred[m * NW * JC + c];
#pragma unroll
        for (int x = 1; x < NW; ++x) sum += dvred[(m * NW + x) * JC + c];
        dv[in0 + (size_t)(Tn - 1 - q * TC - m) * N + j0 + c] =
            rt::from_f<T>(sum);
      }
    }
    __syncthreads();  // the sums read, buffer b free for chunk q + 2
  }
  if (valid) {
#pragma unroll
    for (int c = 0; c < JC; ++c)
      if (c < width) ds0[((size_t)bh * N + i) * N + j0 + c] = G[c];
    du_parts[((size_t)tile * BH + bh) * N + i] = duacc;
  }
}

// dr, dk (to T) and dw: the tiles' partial sums added in tile order
template <typename T>
__global__ void rwkv6_bwd_sum_kernel(const float* __restrict__ parts,
                                     T* __restrict__ dr, T* __restrict__ dk,
                                     float* __restrict__ dw, size_t E,
                                     int tiles) {
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < E;
       e += (size_t)gridDim.x * blockDim.x) {
    float a = parts[e], b = parts[tiles * E + e], c = parts[2 * tiles * E + e];
    for (int x = 1; x < tiles; ++x) {
      a += parts[x * E + e];
      b += parts[(tiles + x) * E + e];
      c += parts[(2 * tiles + x) * E + e];
    }
    dr[e] = rt::from_f<T>(a);
    dk[e] = rt::from_f<T>(b);
    dw[e] = c;
  }
}

// du[h, i]: the partials of every batch row and tile, b outer, tile inner
__global__ void rwkv6_bwd_du_kernel(const float* __restrict__ du_parts,
                                    float* __restrict__ du, int B, int H,
                                    int N, int tiles) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= H * N) return;
  const int h = e / N, i = e % N;
  float s = 0.f;
  for (int b = 0; b < B; ++b)
    for (int x = 0; x < tiles; ++x)
      s += du_parts[((size_t)x * B * H + b * H + h) * N + i];
  du[e] = s;
}

template <typename T, int N>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const float* w, const float* u, const float* s0,
                   const float* s_steps, const void* dy, const float* dS_T,
                   void* dr, void* dk, void* dv, float* dw, float* du,
                   float* ds0, float* parts, float* du_parts, int B, int H,
                   int Tn, cudaStream_t stream) {
  constexpr int NW = (N + 31) / 32;
  const int tiles = (N + JC - 1) / JC;
  dim3 grid(B * H, tiles);
  rwkv6_bwd_kernel<T, N><<<grid, 32 * NW, smem_bytes<T>(N, NW), stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), w, u, s0, s_steps,
      static_cast<const T*>(dy), dS_T, static_cast<T*>(dv), ds0, parts,
      du_parts, H, Tn);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t E = (size_t)B * H * Tn * N;
  const int blocks = (int)std::min<size_t>((E + 255) / 256, 132 * 16);
  rwkv6_bwd_sum_kernel<T><<<blocks, 256, 0, stream>>>(
      parts, static_cast<T*>(dr), static_cast<T*>(dk), dw, E, tiles);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  rwkv6_bwd_du_kernel<<<(H * N + 255) / 256, 256, 0, stream>>>(
      du_parts, du, B, H, N, tiles);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_n(const void* r, const void* k, const void* v, const float* w,
                 const float* u, const float* s0, const float* s_steps,
                 const void* dy, const float* dS_T, void* dr, void* dk,
                 void* dv, float* dw, float* du, float* ds0, float* parts,
                 float* du_parts, int B, int H, int Tn, int N,
                 cudaStream_t st) {
#define RWKV_BWD_N(n)                                                       \
  case n:                                                                   \
    return launch<T, n>(r, k, v, w, u, s0, s_steps, dy, dS_T, dr, dk, dv,   \
                        dw, du, ds0, parts, du_parts, B, H, Tn, st);
  switch (N) {
    RWKV_BWD_N(8) RWKV_BWD_N(16) RWKV_BWD_N(24) RWKV_BWD_N(32)
    RWKV_BWD_N(40) RWKV_BWD_N(48) RWKV_BWD_N(56) RWKV_BWD_N(64)
  }
#undef RWKV_BWD_N
  return cudaErrorInvalidValue;
}

}  // namespace

// Returns the cudaError_t of the launches (0 = success). r, k, v, dy, dr,
// dk, dv: (B, H, T, N) of one dtype; w, dw (B, H, T, N), u, du (H, N), s0
// (B, H, N, N) or null, s_steps (B, H, T, N, N), dS_T (B, H, N, N) or
// null, ds0 (B, H, N, N), parts (3, N / 16, B, H, T, N) and du_parts
// (N / 16, B, H, N) float32 (tiles rounded up). All contiguous and 16-byte
// aligned, checked by the Python wrapper; B * H > 0, T > 0, N % 8 == 0.
extern "C" int rwkv6_scan_bwd(const void* r, const void* k, const void* v,
                              const void* w, const void* u, const void* s0,
                              const void* s_steps, const void* dy,
                              const void* dS_T, void* dr, void* dk, void* dv,
                              void* dw, void* du, void* ds0, void* parts,
                              void* du_parts, int dtype, int B, int H, int T,
                              int N, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || N <= 0 || N > 64 || N % 8 != 0)
    return cudaErrorInvalidValue;
  const float* wf = static_cast<const float*>(w);
  const float* uf = static_cast<const float*>(u);
  const float* s0f = static_cast<const float*>(s0);
  const float* ss = static_cast<const float*>(s_steps);
  const float* dST = static_cast<const float*>(dS_T);
  float* dwf = static_cast<float*>(dw);
  float* duf = static_cast<float*>(du);
  float* ds0f = static_cast<float*>(ds0);
  float* pf = static_cast<float*>(parts);
  float* dpf = static_cast<float*>(du_parts);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case rt::F32:
      return by_n<float>(r, k, v, wf, uf, s0f, ss, dy, dST, dr, dk, dv, dwf,
                         duf, ds0f, pf, dpf, B, H, T, N, st);
    case rt::BF16:
      return by_n<__nv_bfloat16>(r, k, v, wf, uf, s0f, ss, dy, dST, dr, dk,
                                 dv, dwf, duf, ds0f, pf, dpf, B, H, T, N, st);
    case rt::F16:
      return by_n<__half>(r, k, v, wf, uf, s0f, ss, dy, dST, dr, dk, dv, dwf,
                          duf, ds0f, pf, dpf, B, H, T, N, st);
  }
  return cudaErrorInvalidValue;
}
