// RG-LRU gated linear recurrence for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/rglru_scan.py:rglru_scan (the Pallas TPU
// kernel, def :44 / pl.pallas_call :57). Same function, independent per
// channel, with a float32 state:
//
//     h_t = a_t * h_{t-1} + x_t,   h_{-1} = h0 (zeros when null)
//
// over a, x (B, T, C); it writes every h_t to h_seq (B, T, C) in x's dtype
// and the last state to h_T (B, C) in float32. It is the scan of every
// RG-LRU layer of recurrentgemma (models/recurrent.py:rglru_block_seq): T
// = the prompt in lm.forward / lm.prefill, T = 1 in each decode step.
//
// What bounds it on the H100: bytes. Two reads and one write per element
// against 2 flops, far below any ridge point: at (1, 2304, 2560) float32
// the bound is 70.8 MB / 3.35 TB/s = 21.1 us. The time axis is sequential
// per channel, but the chain is short: a step is one float32 multiply and
// one float32 add, rounded on their own (__fmul_rn / __fadd_rn, no fused
// multiply-add: what kernels/ref.py:rglru_scan_ref computes, so kernel and
// twin give the same bits), ~8 cycles, ~10 us over 2304 steps. So the
// kernel can stay serial per channel and still reach the bytes bound, if
// the loads keep up.
//
// Why the first design did not: one thread per (b, c), 128 a block, each
// loading 8 steps of a and x ahead of their use. At (1, 2304, 2560) that
// is 2560 threads in 20 blocks (112 of 132 SMs idle) with ~164 KB of loads
// in flight across the card, where 3.35 TB/s at ~1 us of DRAM latency
// needs ~3 MB: it took 0.2978 ms, ~129 ns a step, one DRAM round trip for
// every 8 steps.
//
// Design (rglru_bulk_kernel): a block owns a tile of CW = 32 channels of
// one batch row, so (1, 2304, 2560) fills 80 blocks and (2, 512, 2560)
// 160, and its three warps form a pipeline over a ring of up to STAGES =
// 6 shared-memory stages, each holding TC = 64 steps of the tile's a and
// x (16 KB in float32), guarded by three mbarriers a stage:
//   - warp 1, the loader, copies a chunk's rows into a free stage with
//     16-byte cp.async copies (a row of the tile is CW contiguous
//     elements, 128 bytes in float32) and signals `full` when they land;
//     it runs up to 6 chunks (96 KB) ahead of the walk;
//   - warp 0, the walker, gives each lane one channel and walks the
//     chunk's steps in order with the state in a register, reading the
//     next U = 16 steps of a and x from shared memory before it runs the
//     current 16 dependent steps, and writes each h_t over a_t's slot
//     (already in a register), then signals `done`;
//   - warp 2, the storer, copies the chunk's h rows to h_seq in 16-byte
//     pieces and signals `empty`, which frees the stage for the loader.
// The first version of this kernel copied each row with a 1-D bulk (TMA)
// copy and let the walker store h_t straight to device memory: both were
// paced per operation (a 128-byte bulk copy, a 128-byte store a step from
// the one walking warp) and it took ~0.15 ms; 16-byte cp.async copies and
// a separate storing warp take each off the walk. Narrower tiles spread
// over all 132 SMs read no faster (PERF.md section 6). The rows must be
// 16-byte aligned (C * sizeof(T) % 16 == 0, a and x 16-byte aligned) and
// T >= TC, or the set-up outweighs the walk: the wrapper
// (kernels/rglru_scan.py:route) sends every other call, decode's T = 1
// among them, to rglru_direct_kernel, the first design, kept as it was.
// Both kernels compute each channel's steps in the same order, so both
// give the twin's bits.

#include "async_copy.cuh"
#include "common.cuh"

namespace {

// ---- the first design: one thread per (b, c) ----------------------------

constexpr int THREADS = 128;
constexpr int CHUNK = 8;  // time steps loaded ahead of their use

template <typename T>
__global__ void __launch_bounds__(THREADS)
    rglru_direct_kernel(const T* __restrict__ a, const T* __restrict__ x,
                        const float* __restrict__ h0, T* __restrict__ h_seq,
                        float* __restrict__ h_T, int B, int Tn, int C) {
  const long long id = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (id >= (long long)B * C) return;
  const long long b = id / C, c = id % C;
  const size_t base = (size_t)b * Tn * C + c;
  float h = h0 != nullptr ? h0[id] : 0.f;
  int t = 0;
  for (; t + CHUNK <= Tn; t += CHUNK) {
    float av[CHUNK], xv[CHUNK];
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      const size_t i = base + (size_t)(t + j) * C;
      av[j] = rt::to_f(a[i]);
      xv[j] = rt::to_f(x[i]);
    }
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      h = __fadd_rn(__fmul_rn(av[j], h), xv[j]);
      h_seq[base + (size_t)(t + j) * C] = rt::from_f<T>(h);
    }
  }
  for (; t < Tn; ++t) {
    const size_t i = base + (size_t)t * C;
    h = __fadd_rn(__fmul_rn(rt::to_f(a[i]), h), rt::to_f(x[i]));
    h_seq[i] = rt::from_f<T>(h);
  }
  h_T[id] = h;
}

// ---- the redesign: channel tiles, a ring of staged time chunks ----------

constexpr int CW = 32;      // channels per block: one walker lane each
constexpr int TC = 64;      // time steps per staged chunk
constexpr int STAGES = 6;   // stages of the ring, at most
constexpr int U = 16;       // steps the walker loads ahead of their use
constexpr int BULK_THREADS = 96;  // warp 0 walks, 1 loads, 2 stores
constexpr int SE = 2 * TC * CW;   // elements of a stage: a rows, x rows

// 3 * STAGES mbarriers (padded to 256 bytes), then the stages.
template <typename T>
constexpr size_t bulk_smem(int stages) {
  return 256 + (size_t)stages * SE * sizeof(T);
}

template <typename T>
__global__ void __launch_bounds__(BULK_THREADS)
    rglru_bulk_kernel(const T* __restrict__ a, const T* __restrict__ x,
                      const float* __restrict__ h0, T* __restrict__ h_seq,
                      float* __restrict__ h_T, int Tn, int C, int nst) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // copies landed
  uint64_t* done = full + STAGES;    // walked: h written over the a rows
  uint64_t* empty = done + STAGES;   // h rows stored: the stage is free
  T* stages = reinterpret_cast<T*>(smem + 256);
  constexpr int PE = 16 / (int)sizeof(T);  // elements in 16 bytes
  constexpr int PPR = CW / PE;             // 16-byte pieces of a full row
  const int b = blockIdx.y, c0 = blockIdx.x * CW;
  const int width = min(CW, C - c0), pieces = width / PE;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nchunks = (Tn + TC - 1) / TC;
  const size_t row0 = (size_t)b * Tn * C + c0;  // a[b, 0, c0]
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      tma::init(full + s, 32);
      tma::init(done + s, 32);
      tma::init(empty + s, 32);
    }
    tma::fence_init();
  }
  __syncthreads();

  if (warp == 1) {
    // the loader: chunk ci's rows of a and x into stage ci % nst once the
    // storer has freed it (after chunk ci - nst); lane l copies 16-byte
    // pieces l, l + 32, .. and arrives on the stage's full barrier when
    // its copies have landed
#pragma unroll 1
    for (int ci = 0; ci < nchunks; ++ci) {
      const int s = ci % nst;
      if (ci >= nst) tma::wait(empty + s, (ci / nst - 1) & 1);
      const int t0 = ci * TC, rows = min(TC, Tn - t0);
      const T* ga = a + row0 + (size_t)t0 * C;
      const T* gx = x + row0 + (size_t)t0 * C;
      T* sa = stages + (size_t)s * SE;
#pragma unroll 4
      for (int p = lane; p < rows * PPR; p += 32) {
        const int r = p / PPR, q = p % PPR;
        if (q < pieces) {
          tma::cp_async_16(sa + r * CW + q * PE,
                           ga + (size_t)r * C + q * PE);
          tma::cp_async_16(sa + (TC + r) * CW + q * PE,
                           gx + (size_t)r * C + q * PE);
        }
      }
      tma::cp_async_arrive(full + s);
    }
    tma::cp_async_wait_all();  // no copy outlives its thread
    return;
  }
  if (warp == 2) {
    // the storer: chunk ci's h rows, once walked, to h_seq in 16-byte
    // pieces (a row of the tile is CW contiguous elements of h_seq), then
    // the stage is free
#pragma unroll 1
    for (int ci = 0; ci < nchunks; ++ci) {
      const int s = ci % nst;
      tma::wait(done + s, (ci / nst) & 1);
      const int t0 = ci * TC, rows = min(TC, Tn - t0);
      const T* sh = stages + (size_t)s * SE;
      T* gh = h_seq + row0 + (size_t)t0 * C;
#pragma unroll 4
      for (int p = lane; p < rows * PPR; p += 32) {
        const int r = p / PPR, q = p % PPR;
        if (q < pieces)
          *reinterpret_cast<uint4*>(gh + (size_t)r * C + q * PE) =
              *reinterpret_cast<const uint4*>(sh + r * CW + q * PE);
      }
      tma::arrive(empty + s);
    }
    return;
  }

  // the walker: lane = channel c0 + lane, each chunk's steps in order,
  // h_t written over a_t's slot once a_t is in a register
  float h = h0 != nullptr && lane < width ? h0[(size_t)b * C + c0 + lane]
                                          : 0.f;
  int s = 0;
#pragma unroll 1
  for (int ci = 0; ci < nchunks; ++ci) {
    tma::wait(full + s, (ci / nst) & 1);
    const int rows = min(TC, Tn - ci * TC), groups = rows / U;
    T* ra = stages + (size_t)s * SE + lane;
    const T* rx = ra + TC * CW;
    float na[U], nx[U];  // the next group's inputs
    if (groups > 0) {
#pragma unroll
      for (int j = 0; j < U; ++j) {
        na[j] = rt::to_f(ra[j * CW]);
        nx[j] = rt::to_f(rx[j * CW]);
      }
    }
#pragma unroll 1
    for (int g = 0; g < groups; ++g) {
      float ca[U], cx[U];
#pragma unroll
      for (int j = 0; j < U; ++j) {
        ca[j] = na[j];
        cx[j] = nx[j];
      }
      T* ro = ra + g * U * CW;
      if (g + 1 < groups) {
#pragma unroll
        for (int j = 0; j < U; ++j) {
          na[j] = rt::to_f(ro[(U + j) * CW]);
          nx[j] = rt::to_f(rx[(g * U + U + j) * CW]);
        }
      }
#pragma unroll
      for (int j = 0; j < U; ++j) {
        h = __fadd_rn(__fmul_rn(ca[j], h), cx[j]);
        ro[j * CW] = rt::from_f<T>(h);
      }
    }
#pragma unroll 1
    for (int r = groups * U; r < rows; ++r) {  // the last chunk's tail
      h = __fadd_rn(__fmul_rn(rt::to_f(ra[r * CW]), h),
                    rt::to_f(rx[r * CW]));
      ra[r * CW] = rt::from_f<T>(h);
    }
    tma::arrive(done + s);
    s = s + 1 == nst ? 0 : s + 1;
  }
  if (lane < width) h_T[(size_t)b * C + c0 + lane] = h;
}

template <typename T>
cudaError_t launch_direct(const void* a, const void* x, const float* h0,
                          void* h_seq, float* h_T, int B, int Tn, int C,
                          cudaStream_t stream) {
  const long long n = (long long)B * C;
  const int blocks = (int)((n + THREADS - 1) / THREADS);
  rglru_direct_kernel<T><<<blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(x), h0,
      static_cast<T*>(h_seq), h_T, B, Tn, C);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bulk(const void* a, const void* x, const float* h0,
                        void* h_seq, float* h_T, int B, int Tn, int C,
                        cudaStream_t stream) {
  const uintptr_t mis = reinterpret_cast<uintptr_t>(a) |
                        reinterpret_cast<uintptr_t>(x) |
                        reinterpret_cast<uintptr_t>(h_seq);
  if (Tn < TC || B > 65535 || (mis & 15) || (C * sizeof(T)) % 16)
    return cudaErrorInvalidValue;  // the wrapper's route never sends these
  static bool opted_in = false;  // the largest ring, once
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        rglru_bulk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bulk_smem<T>(STAGES));
    if (e != cudaSuccess) return e;
    opted_in = true;
  }
  const int nst = min(STAGES, (Tn + TC - 1) / TC);
  dim3 grid((C + CW - 1) / CW, B);
  rglru_bulk_kernel<T><<<grid, BULK_THREADS, bulk_smem<T>(nst), stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(x), h0,
      static_cast<T*>(h_seq), h_T, Tn, C, nst);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(bool bulk, const void* a, const void* x, const float* h0,
                   void* h_seq, float* h_T, int B, int Tn, int C,
                   cudaStream_t st) {
  return bulk ? launch_bulk<T>(a, x, h0, h_seq, h_T, B, Tn, C, st)
              : launch_direct<T>(a, x, h0, h_seq, h_T, B, Tn, C, st);
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success). a, x, h_seq:
// (B, T, C) of one dtype; h0 (B, C) float32 or null; h_T (B, C) float32.
// All contiguous, checked by the Python wrapper; B * C > 0. bulk != 0
// launches rglru_bulk_kernel, which needs T >= 64, B <= 65535, a, x and
// h_seq 16-byte aligned and C * sizeof(T) a multiple of 16 (the wrapper's
// route), else rglru_direct_kernel.
extern "C" int rglru_scan(const void* a, const void* x, const void* h0,
                          void* h_seq, void* h_T, int dtype, int B, int T,
                          int C, int bulk, void* stream) {
  if (B <= 0 || C <= 0 || T < 0) return cudaErrorInvalidValue;
  const float* h0f = static_cast<const float*>(h0);
  float* hT = static_cast<float*>(h_T);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case rt::F32:
      return launch<float>(bulk, a, x, h0f, h_seq, hT, B, T, C, st);
    case rt::BF16:
      return launch<__nv_bfloat16>(bulk, a, x, h0f, h_seq, hT, B, T, C, st);
    case rt::F16:
      return launch<__half>(bulk, a, x, h0f, h_seq, hT, B, T, C, st);
  }
  return cudaErrorInvalidValue;
}
