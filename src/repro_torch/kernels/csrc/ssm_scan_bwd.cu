// Gradient of the Mamba-1 selective scan (ssm_scan.cu) for Hopper (sm_90a),
// written by hand.  With a_t = exp(dt_t A) and G_t the gradient reaching
// h_t, walking t from T - 1 down to 0:
//   G_t      = dy_t[d] C_t[n] + a_{t+1} G_{t+1}        (G_{T-1} starts from dhT)
//   du_t[d]  = sum_n G_t dt_t B_t[n] + dy_t[d] D[d]
//   ddt_t[d] = sum_n G_t (A a_t h_{t-1} + u_t B_t[n])
//   dB_t[n]  = sum_d G_t dt_t u_t[d],   dC_t[n] = sum_d dy_t[d] h_t[d, n]
//   dA[d, n] = sum_{b, t} G_t dt_t a_t h_{t-1},   dD[d] = sum_{b, t} dy_t u_t
//   dh0      = a_0 G_0
// all in fp32.  There is no TPU kernel beside it: the JAX package trains
// through jax.vjp of its jnp two-level scan (repro/kernels/ops.py:146,
// impl="reference"); the Pallas scan has no VJP.
//
// What bounds it on the card.  At the Jamba training shape (Bt 8, T 256,
// Din 8192, N 16; u, B, C, dy bf16) it must read u, dy, dt, the checkpoints
// and write du and ddt: ~270 MB, 0.081 ms at 3.35 TB/s; the 268 M
// exponentials take 0.064 ms at the special-function units' 16 per clock per
// SM, 0.128 ms if each is taken twice.  This first kernel takes each three
// times (the checkpoint walk, the segment's recompute, the reverse walk).
//
// Design.  The forward's geometry: a block of 64 channels of one batch row,
// L lanes a channel (the power of two >= N / 4), four states a lane in
// registers, zero padded past N (a = 1, B = C = 0, h = 0: a padded state
// adds exact zeros).  Chunks of 32 steps are walked from the last to the
// first.  A chunk's u, dt, dy, B and C are staged in shared memory in fp32;
// its states are recomputed from the forward's checkpoint (the state
// entering the chunk) with the forward's arithmetic (ex2.approx of
// dt * (A log2 e)): one walk keeps the state entering each 8-step segment in
// registers, then each segment, last first, is walked forward again keeping
// its eight states in registers and walked back.  du and ddt are summed over
// a channel's L lanes by shuffles and written from shared memory a chunk at
// a time.  dB and dC are summed over the channels of a warp by shuffles,
// over the block's warps through shared memory in warp order, and written as
// per-block partials (Din / 64, Bt, T, N); dA and dD stay in registers over
// time and are written as per-batch-row partials.  A second kernel sums the
// partials in a fixed order (blocks, then batch rows, ascending).  No
// atomics: every sum has one order, so two calls are bit-equal and a
// recompute under activation checkpointing moves no bit.
#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int CPB = 64;              // channels a block (the forward's)
constexpr int CHUNK = 32;            // steps between the forward's checkpoints
constexpr int SEG = 8;               // steps a segment: its states in registers
constexpr int NSEG = CHUNK / SEG;
constexpr int STATES = 4;            // states a lane
constexpr int MAX_N = 32;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int REDUCE_THREADS = 256;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_float(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_float(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Shared memory of one block, in floats: u, dt, dy, du and ddt of a chunk
// ([CHUNK][CPB] each), B and C of a chunk ([CHUNK][4 L] each), and each
// warp's dB and dC terms of a segment ([SEG][warps][2][4 L]).
template <int L>
__host__ __device__ constexpr int smem_floats() {
  return 5 * CHUNK * CPB + 2 * CHUNK * STATES * L + SEG * (CPB * L / 32) * 2 * STATES * L;
}

// u, dy: (Bt, T, Din) T; delta: (Bt, T, Din) fp32; A: (Din, N) fp32; B, C:
// (Bt, T, N) T; D: (Din,) fp32; ckpt: (Bt, ceil(T / CHUNK), Din, N) fp32;
// dhT: (Bt, Din, N) fp32 -> du (T), ddelta (fp32), dh0 (fp32), and the
// partials dBp, dCp (Din / CPB, Bt, T, N), dAp (Bt, Din, N), dDp (Bt, Din).
// Grid (ceil(Din / CPB), Bt), CPB * L threads.
template <typename T, int L>
__global__ void __launch_bounds__(CPB * L, (L <= 4 ? 2 : 1))
ssm_bwd_kernel(const T* __restrict__ u, const float* __restrict__ delta,
               const float* __restrict__ A, const T* __restrict__ B,
               const T* __restrict__ C, const float* __restrict__ D,
               const float* __restrict__ ckpt, const T* __restrict__ dy,
               const float* __restrict__ dhT, T* __restrict__ du,
               float* __restrict__ ddelta, float* __restrict__ dh0,
               float* __restrict__ dBp, float* __restrict__ dCp,
               float* __restrict__ dAp, float* __restrict__ dDp,
               int Tlen, int Din, int N) {
  constexpr int THREADS = CPB * L;
  constexpr int NP = STATES * L;               // states a channel, padded
  constexpr int W = THREADS / 32;              // warps a block
  extern __shared__ __align__(16) float sm[];
  float* us = sm;                              // [CHUNK][CPB] u
  float* ds = us + CHUNK * CPB;                // [CHUNK][CPB] dt
  float* gs = ds + CHUNK * CPB;                // [CHUNK][CPB] dy
  float* dus = gs + CHUNK * CPB;               // [CHUNK][CPB] du before its cast
  float* dds = dus + CHUNK * CPB;              // [CHUNK][CPB] ddt
  float* bs = dds + CHUNK * CPB;               // [CHUNK][NP] B, zero past N
  float* cs = bs + CHUNK * NP;                 // [CHUNK][NP] C
  float* wr = cs + CHUNK * NP;                 // [SEG][W][2][NP] warps' dB, dC terms

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int c = tid / L;                       // channel within the block
  const int g = tid % L;                       // this lane's group of states
  const int b = blockIdx.y, Bt = gridDim.y;
  const int d0 = blockIdx.x * CPB;
  const int d = d0 + c;
  const bool dlive = d < Din;
  const size_t row = static_cast<size_t>(b) * Tlen;
  const int nchunks = (Tlen + CHUNK - 1) / CHUNK;

  float Af[STATES], a2[STATES], carry[STATES], dA[STATES];
#pragma unroll
  for (int s = 0; s < STATES; ++s) {
    const int n = STATES * g + s;
    const bool live = dlive && n < N;
    Af[s] = live ? A[static_cast<size_t>(d) * N + n] : 0.f;
    a2[s] = Af[s] * LOG2E;
    carry[s] = live ? dhT[(static_cast<size_t>(b) * Din + d) * N + n] : 0.f;
    dA[s] = 0.f;
  }
  const float dskip = dlive ? D[d] : 0.f;
  float dD = 0.f;

  // one forward step at chunk step tt, the forward kernel's arithmetic
  auto advance = [&](float (&h)[STATES], int tt) {
    const float dv = ds[tt * CPB + c];
    const float dvu = dv * us[tt * CPB + c];
    const float4 bv = *reinterpret_cast<const float4*>(bs + tt * NP + STATES * g);
    const float bb[STATES] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int s = 0; s < STATES; ++s) h[s] = ex2(dv * a2[s]) * h[s] + dvu * bb[s];
  };

  for (int k = nchunks - 1; k >= 0; --k) {
    const int t0 = k * CHUNK;
    const int steps = min(CHUNK, Tlen - t0);
    __syncthreads();                           // the previous chunk's du, ddt are out
    for (int e = tid; e < steps * CPB; e += THREADS) {
      const int r = e / CPB, ch = e % CPB;
      const bool ok = d0 + ch < Din;
      const size_t o = (row + t0 + r) * Din + d0 + ch;
      us[e] = ok ? to_float(u[o]) : 0.f;
      ds[e] = ok ? delta[o] : 0.f;
      gs[e] = ok ? to_float(dy[o]) : 0.f;
    }
    for (int e = tid; e < steps * NP; e += THREADS) {
      const int r = e / NP, n = e % NP;
      const bool ok = n < N;
      const size_t o = (row + t0 + r) * N + n;
      bs[e] = ok ? to_float(B[o]) : 0.f;
      cs[e] = ok ? to_float(C[o]) : 0.f;
    }
    __syncthreads();

    // the state entering each segment, from the chunk's checkpoint
    float hb[NSEG][STATES];
    {
      float h[STATES];
#pragma unroll
      for (int s = 0; s < STATES; ++s) {
        const int n = STATES * g + s;
        h[s] = dlive && n < N
                   ? ckpt[((static_cast<size_t>(b) * nchunks + k) * Din + d) * N + n] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < NSEG; ++j) {
#pragma unroll
        for (int s = 0; s < STATES; ++s) hb[j][s] = h[s];
        if (j + 1 < NSEG) {
          const int end = min(steps, (j + 1) * SEG);
          for (int tt = j * SEG; tt < end; ++tt) advance(h, tt);
        }
      }
    }

#pragma unroll
    for (int j = NSEG - 1; j >= 0; --j) {
      const int s0 = j * SEG;
      if (s0 >= steps) continue;               // past a ragged end (the whole block)
      float hist[SEG][STATES];                 // the state after each step of the segment
      {
        float h[STATES];
#pragma unroll
        for (int s = 0; s < STATES; ++s) h[s] = hb[j][s];
#pragma unroll
        for (int i = 0; i < SEG; ++i) {
          if (s0 + i < steps) advance(h, s0 + i);
#pragma unroll
          for (int s = 0; s < STATES; ++s) hist[i][s] = h[s];
        }
      }
#pragma unroll
      for (int i = SEG - 1; i >= 0; --i) {
        const int tt = s0 + i;
        if (tt >= steps) continue;             // uniform over the block
        const float dv = ds[tt * CPB + c];
        const float uv = us[tt * CPB + c];
        const float gy = gs[tt * CPB + c];
        const float dvu = dv * uv;
        const float4 bv = *reinterpret_cast<const float4*>(bs + tt * NP + STATES * g);
        const float4 cv = *reinterpret_cast<const float4*>(cs + tt * NP + STATES * g);
        const float bb[STATES] = {bv.x, bv.y, bv.z, bv.w};
        const float cc[STATES] = {cv.x, cv.y, cv.z, cv.w};
        float pdu = 0.f, pdd = 0.f, vb[STATES], vc[STATES];
#pragma unroll
        for (int s = 0; s < STATES; ++s) {
          const float hp = i == 0 ? hb[j][s] : hist[i > 0 ? i - 1 : 0][s];
          const float a = ex2(dv * a2[s]);
          const float G = gy * cc[s] + carry[s];
          const float ah = a * hp;
          pdu += G * bb[s];
          pdd += G * (Af[s] * ah + uv * bb[s]);
          dA[s] += G * dv * ah;
          vb[s] = G * dvu;
          vc[s] = gy * hist[i][s];
          carry[s] = a * G;
        }
#pragma unroll
        for (int o = 1; o < L; o <<= 1) {      // over the channel's L lanes
          pdu += __shfl_xor_sync(0xffffffffu, pdu, o);
          pdd += __shfl_xor_sync(0xffffffffu, pdd, o);
        }
        if (g == 0) {
          dus[tt * CPB + c] = pdu * dv + gy * dskip;
          dds[tt * CPB + c] = pdd;
          dD += gy * uv;
        }
#pragma unroll
        for (int o = L; o < 32; o <<= 1) {     // over the warp's channels
#pragma unroll
          for (int s = 0; s < STATES; ++s) {
            vb[s] += __shfl_xor_sync(0xffffffffu, vb[s], o);
            vc[s] += __shfl_xor_sync(0xffffffffu, vc[s], o);
          }
        }
        if (lane < L) {                        // the warp's first channel: g == lane
          float* w = wr + (i * W + warp) * 2 * NP + STATES * g;
          *reinterpret_cast<float4*>(w) = make_float4(vb[0], vb[1], vb[2], vb[3]);
          *reinterpret_cast<float4*>(w + NP) = make_float4(vc[0], vc[1], vc[2], vc[3]);
        }
      }
      __syncthreads();
      // the block's dB and dC of the segment's steps: its warps' terms in order
      for (int e = tid; e < SEG * 2 * NP; e += THREADS) {
        const int i = e / (2 * NP), which = (e / NP) % 2, n = e % NP;
        const int tt = s0 + i;
        if (tt < steps && n < N) {
          float sum = 0.f;
          for (int w = 0; w < W; ++w) sum += wr[((i * W + w) * 2 + which) * NP + n];
          float* out = which ? dCp : dBp;
          out[((static_cast<size_t>(blockIdx.x) * Bt + b) * Tlen + t0 + tt) * N + n] = sum;
        }
      }
      __syncthreads();                         // wr is the next segment's
    }
    for (int e = tid; e < steps * CPB; e += THREADS) {
      const int r = e / CPB, ch = e % CPB;
      if (d0 + ch < Din) {
        const size_t o = (row + t0 + r) * Din + d0 + ch;
        from_float(du + o, dus[e]);
        ddelta[o] = dds[e];
      }
    }
  }
#pragma unroll
  for (int s = 0; s < STATES; ++s) {
    const int n = STATES * g + s;
    if (dlive && n < N) {
      const size_t o = (static_cast<size_t>(b) * Din + d) * N + n;
      dh0[o] = carry[s];
      dAp[o] = dA[s];
    }
  }
  if (g == 0 && dlive) dDp[static_cast<size_t>(b) * Din + d] = dD;
}

// The partials summed in a fixed order: dB, dC over the channel blocks, dA,
// dD over the batch rows.  One thread an output element.
template <typename T>
__global__ void __launch_bounds__(REDUCE_THREADS)
ssm_bwd_reduce(const float* __restrict__ dBp, const float* __restrict__ dCp,
               const float* __restrict__ dAp, const float* __restrict__ dDp,
               T* __restrict__ dB, T* __restrict__ dC, float* __restrict__ dA,
               float* __restrict__ dD, int Bt, int Tlen, int Din, int N, int nblk) {
  const size_t nbc = static_cast<size_t>(Bt) * Tlen * N;
  const size_t na = static_cast<size_t>(Din) * N;
  const size_t total = 2 * nbc + na + Din;
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; e < total;
       e += stride) {
    if (e < 2 * nbc) {
      const bool isc = e >= nbc;
      const size_t i = isc ? e - nbc : e;
      const float* p = isc ? dCp : dBp;
      float sum = 0.f;
      for (int q = 0; q < nblk; ++q) sum += p[q * nbc + i];
      from_float((isc ? dC : dB) + i, sum);
    } else if (e < 2 * nbc + na) {
      const size_t i = e - 2 * nbc;
      float sum = 0.f;
      for (int q = 0; q < Bt; ++q) sum += dAp[q * na + i];
      dA[i] = sum;
    } else {
      const size_t i = e - 2 * nbc - na;
      float sum = 0.f;
      for (int q = 0; q < Bt; ++q) sum += dDp[q * static_cast<size_t>(Din) + i];
      dD[i] = sum;
    }
  }
}

template <typename T, int L>
int launch_l(const void* u, const void* delta, const void* A, const void* B, const void* C,
             const void* D, const void* ckpt, const void* dy, const void* dhT, void* du,
             void* ddelta, void* dA, void* dB, void* dC, void* dD, void* dh0, void* work,
             int Bt, int Tlen, int Din, int N, cudaStream_t stream) {
  const int smem = smem_floats<L>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(ssm_bwd_kernel<T, L>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nblk = (Din + CPB - 1) / CPB;
  const size_t nbc = static_cast<size_t>(Bt) * Tlen * N;
  float* dBp = static_cast<float*>(work);
  float* dCp = dBp + nblk * nbc;
  float* dAp = dCp + nblk * nbc;
  float* dDp = dAp + static_cast<size_t>(Bt) * Din * N;
  ssm_bwd_kernel<T, L><<<dim3(nblk, Bt), CPB * L, smem, stream>>>(
      static_cast<const T*>(u), static_cast<const float*>(delta),
      static_cast<const float*>(A), static_cast<const T*>(B), static_cast<const T*>(C),
      static_cast<const float*>(D), static_cast<const float*>(ckpt),
      static_cast<const T*>(dy), static_cast<const float*>(dhT), static_cast<T*>(du),
      static_cast<float*>(ddelta), static_cast<float*>(dh0), dBp, dCp, dAp, dDp,
      Tlen, Din, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t total = 2 * nbc + static_cast<size_t>(Din) * N + Din;
  const size_t want = (total + REDUCE_THREADS - 1) / REDUCE_THREADS;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  ssm_bwd_reduce<T><<<blocks, REDUCE_THREADS, 0, stream>>>(
      dBp, dCp, dAp, dDp, static_cast<T*>(dB), static_cast<T*>(dC),
      static_cast<float*>(dA), static_cast<float*>(dD), Bt, Tlen, Din, N, nblk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* u, const void* delta, const void* A, const void* B, const void* C,
           const void* D, const void* ckpt, const void* dy, const void* dhT, void* du,
           void* ddelta, void* dA, void* dB, void* dC, void* dD, void* dh0, void* work,
           int Bt, int Tlen, int Din, int N, cudaStream_t stream) {
  if (N < 1 || N > MAX_N || Tlen < 1 || Din < 1 || Bt < 1 || Bt > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  int lanes = 1;                       // lanes a channel: the power of two >= N / STATES
  while (lanes * STATES < N) lanes *= 2;
#define ARGS u, delta, A, B, C, D, ckpt, dy, dhT, du, ddelta, dA, dB, dC, dD, dh0, work, \
             Bt, Tlen, Din, N, stream
  if (lanes == 1) return launch_l<T, 1>(ARGS);
  if (lanes == 2) return launch_l<T, 2>(ARGS);
  if (lanes == 4) return launch_l<T, 4>(ARGS);
  return launch_l<T, 8>(ARGS);
#undef ARGS
}

}  // namespace

extern "C" {

// Two launches: the reverse scan, then the sums of its partials.  Returns
// the CUDA error of the launches (0 on success).  dtype of u, B, C, dy, du,
// dB and dC: 0 fp32, 1 bf16; every other tensor is fp32.  work: fp32 scratch
// of 2 ceil(Din / 64) Bt T N + Bt Din N + Bt Din elements.
int ssm_scan_bwd(const void* u, const void* delta, const void* A, const void* B,
                 const void* C, const void* D, const void* ckpt, const void* dy,
                 const void* dhT, void* du, void* ddelta, void* dA, void* dB, void* dC,
                 void* dD, void* dh0, void* work, int Bt, int Tlen, int Din, int N,
                 int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(u, delta, A, B, C, D, ckpt, dy, dhT, du, ddelta, dA, dB, dC, dD,
                         dh0, work, Bt, Tlen, Din, N, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(u, delta, A, B, C, D, ckpt, dy, dhT, du, ddelta, dA, dB,
                                 dC, dD, dh0, work, Bt, Tlen, Din, N, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* ssm_scan_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
