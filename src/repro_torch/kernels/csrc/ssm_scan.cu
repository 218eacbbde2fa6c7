// Mamba-1 selective scan for Hopper (sm_90a), written by hand:
//   h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t * u_t,   y_t = C_t . h_t + D * u_t
// with the state h (Din, N) kept in fp32 from h0 to hT.
//
// Replaces the TPU kernel repro/kernels/ssm_scan.py::ssm_scan_pallas (body
// _ssm_kernel).  There the grid walks channel tiles in parallel and time in
// sequential 256-step chunks, carrying h from one grid step to the next in
// VMEM scratch.  Blocks on the card run in no order and carry nothing, so
// here the time loop runs inside the block and only channels run in parallel.
//
// Design.  A group of G lanes (G the power of two >= N, at least 4) serves
// one (batch, channel): lane n keeps h[n] in a register for the whole scan,
// and y_t is a shuffle reduction over the group.  A block of 256 threads
// serves 256 / G neighbouring channels of one batch row.  Time runs in chunks
// of 32 steps: the block first stages the chunk's u and dt (channel-minor, so
// neighbouring threads read neighbouring addresses) and B_t, C_t (shared by
// every channel of the row) in shared memory, then scans the chunk, then
// writes the chunk's y from shared memory, again channel-minor.  Any T, any
// Din and N <= 32 are taken; the ragged edges are masked.
//
// What bounds it on the card.  At the one-period Jamba prefill (Bt 1, T 512,
// Din 8192, N 16; u, B, C bf16, dt fp32) it moves ~35 MB (0.0105 ms at
// 3.35 TB/s) and evaluates 67.1 M exponentials: at the special-function
// units' 16 per clock per SM that is ~0.016 ms, the bound.  Its ~0.4 GFLOP of
// fp32 arithmetic is below both.  The grid (Din / 16 blocks of 8 warps, ~4
// blocks per SM at Jamba's width) gives each SM ~32 warps to hide the
// exp -> FMA chain of a step.  expf, not __expf, and no fast-math flags: the
// state runs hundreds of steps against an oracle held at 5e-5.  Prefetching
// the next chunk while this one is scanned (cp.async) is later work.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK = 32;            // time steps staged in shared memory at once
constexpr int MAX_N = 32;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_float(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_float(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// Sum over the G lanes of a group (G a power of two; groups are aligned).
template <int G>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// u: (Bt, T, Din) T; delta: (Bt, T, Din) fp32; A: (Din, N) fp32;
// B, C: (Bt, T, N) T; D: (Din,) fp32; h0: (Bt, Din, N) fp32
// -> y: (Bt, T, Din) T; hT: (Bt, Din, N) fp32.  Grid (ceil(Din / CPB), Bt).
template <typename T, int G>
__global__ void __launch_bounds__(THREADS)
ssm_kernel(const T* __restrict__ u, const float* __restrict__ delta,
           const float* __restrict__ A, const T* __restrict__ B,
           const T* __restrict__ C, const float* __restrict__ D,
           const float* __restrict__ h0, T* __restrict__ y,
           float* __restrict__ hT, int Tlen, int Din, int N) {
  constexpr int CPB = THREADS / G;            // channels per block
  extern __shared__ __align__(16) float smem[];
  float* us = smem;                           // CHUNK * CPB
  float* ds = us + CHUNK * CPB;               // CHUNK * CPB
  float* ys = ds + CHUNK * CPB;               // CHUNK * CPB
  float* bs = ys + CHUNK * CPB;               // CHUNK * N
  float* cs = bs + CHUNK * N;                 // CHUNK * N

  const int tid = threadIdx.x;
  const int c = tid / G;                      // channel within the block
  const int n = tid % G;                      // state index of this lane
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * CPB;
  const int d = d0 + c;
  const bool live = d < Din && n < N;

  const size_t hoff = (static_cast<size_t>(b) * Din + d) * N + n;
  const float a = live ? A[static_cast<size_t>(d) * N + n] : 0.f;
  const float dskip = d < Din ? D[d] : 0.f;
  float h = live ? h0[hoff] : 0.f;

  const size_t row = static_cast<size_t>(b) * Tlen;     // first (b, t) row
  for (int t0 = 0; t0 < Tlen; t0 += CHUNK) {
    const int steps = min(CHUNK, Tlen - t0);
    for (int e = tid; e < steps * CPB; e += THREADS) {
      const int dd = d0 + e % CPB;
      float uv = 0.f, dv = 0.f;
      if (dd < Din) {
        const size_t off = (row + t0 + e / CPB) * Din + dd;
        uv = to_float(u[off]);
        dv = delta[off];
      }
      us[e] = uv;
      ds[e] = dv;
    }
    for (int e = tid; e < steps * N; e += THREADS) {
      const size_t off = (row + t0) * N + e;
      bs[e] = to_float(B[off]);
      cs[e] = to_float(C[off]);
    }
    __syncthreads();

#pragma unroll 4
    for (int tt = 0; tt < steps; ++tt) {
      const float dv = ds[tt * CPB + c];
      const float uv = us[tt * CPB + c];
      float p = 0.f;
      if (n < N) {
        const float decay = expf(dv * a);
        h = decay * h + (dv * uv) * bs[tt * N + n];
        p = h * cs[tt * N + n];
      }
      p = group_sum<G>(p);
      if (n == 0) ys[tt * CPB + c] = p + uv * dskip;
    }
    __syncthreads();

    for (int e = tid; e < steps * CPB; e += THREADS) {
      const int dd = d0 + e % CPB;
      if (dd < Din) from_float(y + (row + t0 + e / CPB) * Din + dd, ys[e]);
    }
    // The next chunk's staging overwrites us/ds/bs/cs only: every read of
    // them ended before the barrier above, and ys is next written after the
    // next chunk's barrier, which every thread reaches after its writes here.
  }
  if (live) hT[hoff] = h;
}

template <typename T, int G>
int launch_g(const void* u, const void* delta, const void* A, const void* B,
             const void* C, const void* D, const void* h0, void* y, void* hT,
             int Bt, int Tlen, int Din, int N, cudaStream_t stream) {
  constexpr int CPB = THREADS / G;
  const size_t smem = sizeof(float) * (3 * CHUNK * CPB + 2 * CHUNK * static_cast<size_t>(N));
  const dim3 grid((Din + CPB - 1) / CPB, Bt);
  ssm_kernel<T, G><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(u), static_cast<const float*>(delta),
      static_cast<const float*>(A), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<const float*>(D),
      static_cast<const float*>(h0), static_cast<T*>(y), static_cast<float*>(hT),
      Tlen, Din, N);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* u, const void* delta, const void* A, const void* B,
           const void* C, const void* D, const void* h0, void* y, void* hT,
           int Bt, int Tlen, int Din, int N, cudaStream_t stream) {
  if (N < 1 || N > MAX_N || Tlen < 1 || Din < 1 || Bt < 1 || Bt > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N <= 4) return launch_g<T, 4>(u, delta, A, B, C, D, h0, y, hT, Bt, Tlen, Din, N, stream);
  if (N <= 8) return launch_g<T, 8>(u, delta, A, B, C, D, h0, y, hT, Bt, Tlen, Din, N, stream);
  if (N <= 16) return launch_g<T, 16>(u, delta, A, B, C, D, h0, y, hT, Bt, Tlen, Din, N, stream);
  return launch_g<T, 32>(u, delta, A, B, C, D, h0, y, hT, Bt, Tlen, Din, N, stream);
}

}  // namespace

extern "C" {

// Returns the CUDA error of the launch (0 on success).  dtype of u, B, C and
// y: 0 fp32, 1 bf16; delta, A, D, h0 and hT are fp32.
int ssm_scan_fwd(const void* u, const void* delta, const void* A, const void* B,
                 const void* C, const void* D, const void* h0, void* y, void* hT,
                 int Bt, int Tlen, int Din, int N, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(u, delta, A, B, C, D, h0, y, hT, Bt, Tlen, Din, N, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(u, delta, A, B, C, D, h0, y, hT, Bt, Tlen, Din, N, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* ssm_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
