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
// and S_T (B, H, N, N) in float32; given s_steps, also the state after
// every step, S_t for t = 0 .. T - 1, as (B, H, T, N, N) float32. It is
// the time mix of every RWKV6 layer (models/recurrent.py:rwkv_seq): T =
// the prompt in lm.forward / lm.prefill, T = 1 in each decode step, and T
// = a draft chain of at most 8 tokens in the serving engine's speculative
// verify, which keeps every step's state (s_steps) to roll a lane back
// to its accepted length. The TPU kernel starts from zeros;
// this one takes the carried state s0, which decode and resumed prefill
// need. Padded steps need no length argument: the caller zeroes k and sets
// w = 1 there, which leaves S unchanged.
//
// What bounds it on the H100: at a decode step, bytes (S read and written
// once, 16 KiB each per head); over a long prompt, float32 operations (7
// per state element per step) on a time axis that is sequential, so the
// latency of one step's dependent work sets the pace unless many
// independent columns share each SM.
//
// Design. The state's columns are independent: column j of S, and y_j,
// depend only on v_j and on the r, k, w and u rows every column shares.
// So the grid is (B * H, N / JC): a block owns JC = 16 value columns of
// one head (a 2048-token prompt at B = 1 fills 160 blocks, a decode step
// at B = 4 fills 640), and each column belongs to G = 4 lanes of one warp,
// lane g holding key rows g R .. g R + R - 1 (R = N / G, 16 at N = 64) of
// that column in registers. No state lives in shared memory, so no
// barrier guards it. y_j is summed over the key rows in order, i = 0 ..
// N - 1, as one serial chain passed lane to lane: lane g runs g steps
// behind lane 0 (at tick tau it takes step tau - g), adds its R terms of
// that step to the partial sum lane g - 1 handed it one tick earlier (a
// shuffle up) and hands the result on; the last lane writes y. So every
// tick each lane updates its R state elements for one step and adds R
// terms, and a step's chain costs G shuffles spread over G ticks rather
// than a wait; a decode step (T = 1) takes G ticks. The step inputs come a
// chunk of TC = 32 steps at a time: one thread copies a chunk's rows of w,
// r, k and v (contiguous in (B, H, T, N)) into shared memory with four
// bulk TMA copies, double buffered, so the block meets only when a buffer
// is to be refilled (once a chunk, after the last lane's last step of the
// chunk before), and not at all in a decode step. A warp's 8 columns x 4
// lanes read s0 and write S_T and y straight from and to device memory in
// 32-byte runs, and a lane loads its next step's inputs from shared
// memory while it finishes the current one. The same kernel and order
// serve T = 1 and T > 1. Every product and sum is a float32 operation
// rounded on its own (__fmul_rn / __fadd_rn: no fused multiply-add), in
// the order of the first kernel: each state element takes kv = k v,
// S = w S + kv, so S_T equals kernels/ref.py:rwkv6_scan_ref bit for bit,
// and y_j = (..((0 + t_0) + t_1) + ..) + t_{N-1}, which equals
// ref.rwkv6_scan_split_ref bit for bit. A shuffle tree over 16 lanes'
// partial sums was tried first: right to its own emulation, but its other
// rounding of y moved the rwkv6 bf16 prefill-vs-stepwise gate from 0.0898
// to 0.1523 at seed 0 (bound 0.125; PERF.md section 6), so the serial
// order stays and the redesign leaves every number the model computes as
// it was. The chain over 16 lanes was right too, but a decode step paid 16 ticks and
// a tick's overhead outweighed its 4 rows of work, hence 4 lanes of N / 4
// rows. It replaces a first kernel that gave each (b, h) one block of N
// threads, a thread per column walking all N key rows each step with the
// state in shared memory and a block barrier every step.
//
// Per-step states: each lane writes its R state elements of column j to
// s_steps right after it updates them, in the same 32-byte runs as S_T,
// so S_t there is bit-equal to S_T of the same call cut to t + 1 steps
// and to t + 1 single-step calls chained through s0. The extra bytes are
// T N^2 4 per (b, h): for a verify chain of T <= 8 at N = 64, 128 KiB,
// against 32 KiB of s0 and S_T. It is a separate instantiation (STATES),
// so a call without s_steps runs the same code as before it existed: a
// run-time test of s_steps in the step loop cost the 2048-token prompt
// ~5% (benchmarks/torch_rwkv6_scan_times.py, PERF.md section 6).
//
// Inputs must be 16-byte aligned with N a multiple of 8 (the bulk copies'
// rule; kernels/rwkv6_scan.py checks both).

#include "async_copy.cuh"
#include "common.cuh"

namespace {

constexpr int MAX_N = 64;
constexpr int G = 4;        // lanes per value column
constexpr int JC = 16;      // value columns per block
constexpr int NT = G * JC;  // threads per block
constexpr int TC = 32;      // steps per chunk
constexpr int NB = 2;       // chunk buffers (chunks in flight)
constexpr int SS = JC + 1;  // row stride of the staged state slice

// One chunk buffer: w (tc * N float32), then r, k, v (tc * N of T each).
template <typename T>
__host__ __device__ size_t buf_bytes(int tc, int N) {
  return (size_t)tc * N * (sizeof(float) + 3 * sizeof(T));
}
// NB mbarriers (padded to 128 bytes), then NB chunk buffers.
template <typename T>
__host__ __device__ size_t smem_bytes(int tc, int N) {
  return 128 + NB * buf_bytes<T>(tc, N);
}

// R consecutive elements as floats, in vector loads where R elements are
// a power-of-two number of bytes (the rows are so aligned in shared
// memory).
template <int R, typename T>
struct alignas(((R * sizeof(T)) & (R * sizeof(T) - 1)) == 0
                   ? R * sizeof(T) : sizeof(T)) Rows {
  T v[R];
};
template <int R, typename T>
__device__ __forceinline__ void load_rows(const T* p, float (&x)[R]) {
  const Rows<R, T> a = *reinterpret_cast<const Rows<R, T>*>(p);
#pragma unroll
  for (int i = 0; i < R; ++i) x[i] = rt::to_f(a.v[i]);
}

// R = N / G key rows a lane; STATES: write every step's state to s_steps.
template <typename T, int R, bool STATES>
__global__ void __launch_bounds__(NT)
    rwkv6_scan_kernel(const T* __restrict__ r, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ w,
                      const float* __restrict__ u,
                      const float* __restrict__ s0, T* __restrict__ y,
                      float* __restrict__ s_out,
                      float* __restrict__ s_steps, int H, int Tn,
                      int tcm) {
  constexpr int N = G * R;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  unsigned char* bufs = smem + 128;
  const size_t bb = buf_bytes<T>(tcm, N);
  const int bh = blockIdx.x;
  const int c = threadIdx.x / G, g = threadIdx.x % G;
  const int j = blockIdx.y * JC + c;
  const bool col = j < N;
  const size_t in0 = (size_t)bh * Tn * N;  // the head's first input
  const int nchunks = (Tn + tcm - 1) / tcm;
  const uint32_t rows = (uint32_t)tcm * N;  // elements of one array a chunk

  // chunk ci's rows of w, r, k, v into buffer ci % NB (thread 0)
  auto fetch = [&](int ci) {
    const int t0 = ci * tcm;
    const uint32_t n = (uint32_t)min(tcm, Tn - t0) * N;
    const size_t o = in0 + (size_t)t0 * N;
    unsigned char* b = bufs + (ci % NB) * bb;
    uint64_t* bar = full + ci % NB;
    tma::expect_tx(bar, n * (4 + 3 * sizeof(T)));
    tma::load_1d(b, w + o, n * 4, bar);
    tma::load_1d(b + rows * 4, r + o, n * sizeof(T), bar);
    tma::load_1d(b + rows * (4 + sizeof(T)), k + o, n * sizeof(T), bar);
    tma::load_1d(b + rows * (4 + 2 * sizeof(T)), v + o, n * sizeof(T), bar);
  };
  if (threadIdx.x == 0) {
    for (int b = 0; b < NB; ++b) tma::init(full + b, 1);
    tma::fence_init();
    for (int ci = 0; ci < min(NB, nchunks); ++ci) fetch(ci);
  }
  // the lane's rows of column j: a warp reads 4 rows x 8 columns at a time
  const size_t lj = (size_t)g * R * N + j;  // its first element in a state
  const size_t sj = (size_t)bh * N * N + lj;
  float S[R], ur[R];
#pragma unroll
  for (int p = 0; p < R; ++p) {
    S[p] = s0 != nullptr && col ? s0[sj + (size_t)p * N] : 0.f;
    ur[p] = u[(bh % H) * N + g * R + p];
  }
  __syncthreads();

  // Tick tau: lane g takes step s = tau - g, on inputs it loaded from
  // shared memory one tick earlier. The block waits for chunk cw just
  // before lane 0 first loads from it, and meets once the last lane has
  // finished chunk ce when that chunk's buffer is to be refilled.
  float rr[R], kk[R], ww[R], vj = 0.f;  // the inputs of the lane's step
  int srow = 0, sch = 0;  // its row within its chunk, its chunk
  const unsigned char* buf = bufs;  // that chunk's buffer
  auto load = [&]() {
    const int row = srow * N + g * R;
    const T* sr = reinterpret_cast<const T*>(buf + rows * 4);
    vj = col ? rt::to_f(sr[2 * rows + srow * N + j]) : 0.f;
    load_rows<R>(sr + row, rr);
    load_rows<R>(sr + rows + row, kk);
    load_rows<R>(reinterpret_cast<const float*>(buf) + row, ww);
  };
  float out = 0.f;  // this lane's partial sum of the previous tick
  int s = -g;       // this lane's step
  int cw = 0, ce = 0;
  int wait_at = -1, end_at = min(tcm, Tn) - 1 + G - 1;
  if (Tn > 0) {
    tma::wait(full, 0);
    ++cw;
    wait_at = tcm - 1;
    if (g == 0) load();
  }
  const int ticks = Tn > 0 ? Tn + G - 1 : 0;
#pragma unroll 1
  for (int tau = 0; tau < ticks; ++tau) {
    if (tau == wait_at && cw < nchunks) {
      tma::wait(full + cw % NB, (cw / NB) & 1);
      ++cw;
      wait_at += tcm;
    }
    const float in = __shfl_up_sync(0xffffffffu, out, 1, G);
    out = g == 0 ? 0.f : in;
    if (s >= 0 && s < Tn) {
      float term[R];
#pragma unroll
      for (int p = 0; p < R; ++p) {
        const float kv = __fmul_rn(kk[p], vj);
        const float sp = S[p];
        term[p] = __fmul_rn(rr[p], __fadd_rn(sp, __fmul_rn(ur[p], kv)));
        S[p] = __fadd_rn(__fmul_rn(ww[p], sp), kv);
      }
#pragma unroll
      for (int p = 0; p < R; ++p) out = __fadd_rn(out, term[p]);
      if (g == G - 1 && col) y[in0 + (size_t)s * N + j] = rt::from_f<T>(out);
      if (STATES && col) {
        float* st = s_steps + ((size_t)bh * Tn + s) * N * N + lj;
#pragma unroll
        for (int p = 0; p < R; ++p) st[(size_t)p * N] = S[p];
      }
      if (++srow == tcm) {
        srow = 0;
        ++sch;
        buf = bufs + (sch % NB) * bb;
      }
    }
    ++s;
    if (s >= 0 && s < Tn) load();  // the next tick's inputs
    if (tau == end_at) {
      // the last lane has taken chunk ce's last step: its buffer is free
      if (ce + NB < nchunks) {
        __syncthreads();
        if (threadIdx.x == 0) {
          tma::fence_proxy_async();
          fetch(ce + NB);
        }
      }
      ++ce;
      end_at = min((ce + 1) * tcm, Tn) - 1 + G - 1;
    }
  }

  if (col) {
#pragma unroll
    for (int p = 0; p < R; ++p) s_out[sj + (size_t)p * N] = S[p];
  }
}

template <typename T, int R, bool STATES>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const float* w, const float* u, const float* s0, void* y,
                   float* s_out, float* s_steps, int B, int H, int Tn,
                   cudaStream_t stream) {
  constexpr int N = G * R;
  static bool opted_in = false;  // the largest buffers, once
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        rwkv6_scan_kernel<T, R, STATES>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes<T>(TC, N));
    if (e != cudaSuccess) return e;
    opted_in = true;
  }
  const int tcm = max(1, min(Tn, TC));
  dim3 grid(B * H, (N + JC - 1) / JC);
  rwkv6_scan_kernel<T, R, STATES>
      <<<grid, NT, smem_bytes<T>(tcm, N), stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), w, u, s0, static_cast<T*>(y), s_out, s_steps,
      H, Tn, tcm);
  return cudaGetLastError();
}

// N = 8, 16, .., 64: R = N / G = 2, 4, .., 16.
template <typename T>
cudaError_t by_rows(const void* r, const void* k, const void* v,
                    const float* w, const float* u, const float* s0, void* y,
                    float* s_out, float* s_steps, int B, int H, int Tn, int N,
                    cudaStream_t st) {
#define RWKV_N(n)                                                        \
  case n:                                                                \
    return s_steps != nullptr                                            \
               ? launch<T, n / G, true>(r, k, v, w, u, s0, y, s_out,     \
                                        s_steps, B, H, Tn, st)           \
               : launch<T, n / G, false>(r, k, v, w, u, s0, y, s_out,    \
                                         nullptr, B, H, Tn, st);
  switch (N) {
    RWKV_N(8) RWKV_N(16) RWKV_N(24) RWKV_N(32)
    RWKV_N(40) RWKV_N(48) RWKV_N(56) RWKV_N(64)
  }
#undef RWKV_N
  return cudaErrorInvalidValue;
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success). r, k, v, y:
// (B, H, T, N) of one dtype; w (B, H, T, N), u (H, N), s0 (B, H, N, N) or
// null, s_out (B, H, N, N) and s_steps (B, H, T, N, N) or null float32.
// All contiguous and 16-byte aligned, checked by the Python wrapper; B * H
// > 0 and 0 < N <= 64, N % 8 == 0.
extern "C" int rwkv6_scan(const void* r, const void* k, const void* v,
                          const void* w, const void* u, const void* s0,
                          void* y, void* s_out, void* s_steps, int dtype,
                          int B, int H, int T, int N, void* stream) {
  if (B <= 0 || H <= 0 || T < 0 || N <= 0 || N > MAX_N || N % 8 != 0)
    return cudaErrorInvalidValue;
  const float* wf = static_cast<const float*>(w);
  const float* uf = static_cast<const float*>(u);
  const float* s0f = static_cast<const float*>(s0);
  float* so = static_cast<float*>(s_out);
  float* ss = static_cast<float*>(s_steps);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case rt::F32:
      return by_rows<float>(r, k, v, wf, uf, s0f, y, so, ss, B, H, T, N,
                            st);
    case rt::BF16:
      return by_rows<__nv_bfloat16>(r, k, v, wf, uf, s0f, y, so, ss, B, H, T,
                                    N, st);
    case rt::F16:
      return by_rows<__half>(r, k, v, wf, uf, s0f, y, so, ss, B, H, T, N,
                             st);
  }
  return cudaErrorInvalidValue;
}
