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
// What bounds it on the card.  At the one-period Jamba prefill (Bt 1, T 512,
// Din 8192, N 16; u, B, C bf16, dt fp32) it moves ~35 MB (0.0105 ms at
// 3.35 TB/s) and evaluates 67.1 M exponentials: at the special-function
// units' 16 per clock per SM that is ~0.016 ms, the bound.  The first kernel (a
// lane a state, a 4-level shuffle reduction of y every step, a precise expf,
// staging that waited before every chunk) ran at 8.5x that bound: a clock64
// trace gave a 32-step chunk 1.33 us of staging and 5.49 us of scan, bound by
// issue slots and shuffle latency, not by the exponentials.  This one runs at
// ~3x the bound with ~8 warps an SM (Din * L / 32 warps in all): the step
// loop is latency-bound, since the time chain cannot be split.
//
// Design.  L lanes serve one (batch, channel), L the power of two >= N / 4,
// and each lane keeps four states in registers (zero padded past N: a = 0,
// B = C = 0, so a padded state adds exact zeros).  At N 16 that is 4 lanes a
// channel.  A step costs a lane 4 ex2, ~12 FMA-class operations and two
// 16-byte shared loads of its B_t and C_t.  y is reduced over the L lanes
// once per L steps: each lane adds its partial y of L steps, then a
// reduce-scatter (L - 1 shuffles) leaves lane g the whole y of step g, which
// it writes (a padded row stride keeps those writes on distinct banks).  The
// decay is ex2.approx of dt * (a log2 e), with a log2 e formed once per
// state: one MUFU op per state and step (no --use_fast_math; the rest is
// IEEE).  A block of 64 channels (64 L threads) walks time in 32-step chunks
// through a two-stage ring: chunk k + 1 is in flight (16-byte cp.async, u, B
// and C in their own dtype) while chunk k is scanned.  B and C of a chunk are
// widened to fp32 once, each lane's four states together, while the previous
// chunk is written back; y goes out as 16-byte vectors.  Rows that are not
// 16-byte aligned (Din or N * itemsize not a multiple of 16) are staged
// element by element, synchronously; ragged Din, T and N are masked.
//
// Checkpoints for the backward (ssm_scan_bwd.cu).  A template flag, set when
// the caller passes a checkpoint buffer, makes each thread write its states
// as a chunk begins: ckpt (Bt, ceil(T / CHUNK), Din, N) fp32, entry k the
// state entering step k * CHUNK (entry 0 is h0).  Serving passes no buffer
// and launches the instantiation without the flag, whose code is the one
// without checkpoints.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int CPB = 64;              // channels a block
constexpr int CHUNK = 32;            // time steps a ring stage holds
constexpr int STATES = 4;            // states a lane
constexpr int MAX_N = 32;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_float(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_float(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 16 bytes from device memory into shared memory, zero filled when !valid.
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))), "l"(src),
                  "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait0() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Row stride of the y stage: CPB plus a pad that puts the L lanes of a
// channel, writing L different steps, on different banks.
__host__ __device__ constexpr int ys_stride(int L) { return CPB + (32 / L > 4 ? 32 / L : 4); }

// Reduce-scatter over the L lanes of a channel: p[i] holds this lane's
// partial y of step i; returns the sum over the L lanes of step g (this
// lane's index in its group).  L - 1 shuffles for L steps.
template <int L>
__device__ __forceinline__ float reduce_scatter(float (&p)[L], int g) {
#pragma unroll
  for (int half = L / 2; half >= 1; half /= 2) {
    const bool upper = (g & half) != 0;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float send = upper ? p[i] : p[i + half];
      const float keep = upper ? p[i + half] : p[i];
      p[i] = keep + __shfl_xor_sync(0xffffffffu, send, half);
    }
  }
  return p[0];
}

// 16 bytes of y from fp32 values: four floats or eight bf16.
__device__ __forceinline__ void store16(float* dst, const float* v) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store16(__nv_bfloat16* dst, const float* v) {
  uint4 out;
  uint32_t* w = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&p);
  }
  *reinterpret_cast<uint4*>(dst) = out;
}

// Shared memory of one block (ssm_scan.py::scan_geometry mirrors it):
// two raw stages of u (T), dt (fp32), B and C (T) as they lie in device
// memory; two stages of B and C widened to fp32 (per step, per lane group:
// its four B, then its four C); two stages of y in fp32, rows padded to
// ys_stride(L).
__host__ __device__ constexpr int round16(int bytes) { return (bytes + 15) / 16 * 16; }
template <typename T>
__host__ __device__ constexpr int raw_bc_bytes(int N) {
  return round16(CHUNK * N * static_cast<int>(sizeof(T)));
}
template <typename T>
__host__ __device__ constexpr int stage_bytes(int N) {
  return CHUNK * CPB * static_cast<int>(sizeof(T)) + CHUNK * CPB * 4 + 2 * raw_bc_bytes<T>(N);
}
template <typename T, int L>
__host__ __device__ constexpr int smem_bytes(int N) {
  return 2 * stage_bytes<T>(N) + 2 * CHUNK * L * 2 * STATES * 4 + 2 * CHUNK * ys_stride(L) * 4;
}

// u: (Bt, T, Din) T; delta: (Bt, T, Din) fp32; A: (Din, N) fp32;
// B, C: (Bt, T, N) T; D: (Din,) fp32; h0: (Bt, Din, N) fp32
// -> y: (Bt, T, Din) T; hT: (Bt, Din, N) fp32.  Grid (ceil(Din / CPB), Bt),
// CPB * L threads.  vec: every row 16-byte aligned (cp.async, vector stores).
// CK: write the chunk checkpoints into ckpt (see the header).
template <typename T, int L, bool CK>
__global__ void __launch_bounds__(CPB * L)
ssm_kernel(const T* __restrict__ u, const float* __restrict__ delta,
           const float* __restrict__ A, const T* __restrict__ B,
           const T* __restrict__ C, const float* __restrict__ D,
           const float* __restrict__ h0, T* __restrict__ y,
           float* __restrict__ hT, float* __restrict__ ckpt, int Tlen, int Din, int N,
           int vec) {
  constexpr int THREADS = CPB * L;
  constexpr int BC = 2 * STATES;              // a lane's B then C of one step
  constexpr int YS = ys_stride(L);
  constexpr int PER = 16 / static_cast<int>(sizeof(T));   // elements of T in 16 bytes
  extern __shared__ __align__(16) unsigned char smem[];
  const int sb = stage_bytes<T>(N);
  const int rb = raw_bc_bytes<T>(N);
  float* bcf = reinterpret_cast<float*>(smem + 2 * sb);   // [2][CHUNK][L][BC]
  float* ys = bcf + 2 * CHUNK * L * BC;                   // [2][CHUNK][YS]
  auto u_raw = [&](int st) { return reinterpret_cast<T*>(smem + st * sb); };
  auto dt_raw = [&](int st) {
    return reinterpret_cast<float*>(smem + st * sb + CHUNK * CPB * sizeof(T));
  };
  auto b_raw = [&](int st) {
    return reinterpret_cast<T*>(smem + st * sb + CHUNK * CPB * (sizeof(T) + 4));
  };
  auto c_raw = [&](int st) {
    return reinterpret_cast<T*>(smem + st * sb + CHUNK * CPB * (sizeof(T) + 4) + rb);
  };

  const int tid = threadIdx.x;
  const int c = tid / L;                      // channel within the block
  const int g = tid % L;                      // this lane's group of states
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * CPB;
  const int d = d0 + c;
  const bool dlive = d < Din;
  const size_t row = static_cast<size_t>(b) * Tlen;   // first (b, t) row

  float a2[STATES], h[STATES];
#pragma unroll
  for (int s = 0; s < STATES; ++s) {
    const int n = STATES * g + s;
    const bool live = dlive && n < N;
    a2[s] = live ? A[static_cast<size_t>(d) * N + n] * LOG2E : 0.f;
    h[s] = live ? h0[(static_cast<size_t>(b) * Din + d) * N + n] : 0.f;
  }
  const float dskip = dlive ? D[d] : 0.f;
  const int nchunks = (Tlen + CHUNK - 1) / CHUNK;

  // chunk kk of u, dt, B, C into raw stage st (one cp.async group)
  auto stage = [&](int kk, int st) {
    const int t0 = kk * CHUNK;
    const int steps = min(CHUNK, Tlen - t0);
    T* ur = u_raw(st);
    float* dr = dt_raw(st);
    T* br = b_raw(st);
    T* cr = c_raw(st);
    if (vec) {
      constexpr int SEG_U = CPB / PER, SEG_D = CPB / 4;
      for (int e = tid; e < steps * SEG_U; e += THREADS) {
        const int r = e / SEG_U, ch = (e % SEG_U) * PER;
        const bool ok = d0 + ch < Din;
        cp16(ur + r * CPB + ch, ok ? u + (row + t0 + r) * Din + d0 + ch : u, ok);
      }
      for (int e = tid; e < steps * SEG_D; e += THREADS) {
        const int r = e / SEG_D, ch = (e % SEG_D) * 4;
        const bool ok = d0 + ch < Din;
        cp16(dr + r * CPB + ch, ok ? delta + (row + t0 + r) * Din + d0 + ch : delta, ok);
      }
      const int segs = steps * N / PER;       // N * sizeof(T) is a multiple of 16
      const size_t off = (row + t0) * N;
      for (int e = tid; e < segs; e += THREADS) {
        cp16(br + e * PER, B + off + e * PER, true);
        cp16(cr + e * PER, C + off + e * PER, true);
      }
    } else {
      for (int e = tid; e < steps * CPB; e += THREADS) {
        const int r = e / CPB, ch = e % CPB;
        const bool ok = d0 + ch < Din;
        const size_t o = (row + t0 + r) * Din + d0 + ch;
        ur[e] = ok ? u[o] : T(0.f);
        dr[e] = ok ? delta[o] : 0.f;
      }
      const size_t off = (row + t0) * N;
      for (int e = tid; e < steps * N; e += THREADS) {
        br[e] = B[off + e];
        cr[e] = C[off + e];
      }
    }
    cp_async_commit();
  };

  // B, C of chunk kk (raw stage st) widened to fp32: for each step and lane
  // group, its STATES values of B, then of C (zero past N)
  auto widen = [&](int kk, int st) {
    const int steps = min(CHUNK, Tlen - kk * CHUNK);
    const T* br = b_raw(st);
    const T* cr = c_raw(st);
    float* out = bcf + st * CHUNK * L * BC;
    for (int e = tid; e < steps * L * STATES; e += THREADS) {
      const int r = e / (L * STATES), n = e % (L * STATES);
      const bool ok = n < N;
      float* o = out + (r * L + n / STATES) * BC + n % STATES;
      o[0] = ok ? to_float(br[r * N + n]) : 0.f;
      o[STATES] = ok ? to_float(cr[r * N + n]) : 0.f;
    }
  };

  // y of chunk kk from ys stage st
  auto write_back = [&](int kk, int st) {
    const int t0 = kk * CHUNK;
    const int steps = min(CHUNK, Tlen - t0);
    const float* yo = ys + st * CHUNK * YS;
    if (vec) {
      constexpr int SEG = CPB / PER;
      for (int e = tid; e < steps * SEG; e += THREADS) {
        const int r = e / SEG, ch = (e % SEG) * PER;
        if (d0 + ch < Din) store16(y + (row + t0 + r) * Din + d0 + ch, yo + r * YS + ch);
      }
    } else {
      for (int e = tid; e < steps * CPB; e += THREADS) {
        const int r = e / CPB, ch = e % CPB;
        if (d0 + ch < Din) from_float(y + (row + t0 + r) * Din + d0 + ch, yo[r * YS + ch]);
      }
    }
  };

  stage(0, 0);
  cp_async_wait0();
  __syncthreads();
  widen(0, 0);
  if (nchunks > 1) stage(1, 1);
  __syncthreads();

  for (int k = 0; k < nchunks; ++k) {
    if constexpr (CK) {                // the state entering chunk k
#pragma unroll
      for (int s = 0; s < STATES; ++s) {
        const int n = STATES * g + s;
        if (dlive && n < N)
          ckpt[((static_cast<size_t>(b) * nchunks + k) * Din + d) * N + n] = h[s];
      }
    }
    const int st = k & 1;
    const int steps = min(CHUNK, Tlen - k * CHUNK);
    const T* us = u_raw(st);
    const float* ds = dt_raw(st);
    const float* bc = bcf + st * CHUNK * L * BC + g * BC;
    float* yo = ys + st * CHUNK * YS;
    int tt = 0;
    if constexpr (L > 1) {
      // L steps at a time: every lane's partial y of each, then one
      // reduce-scatter; lane g writes step tt + g
      for (; tt + L <= steps; tt += L) {
        float p[L];
#pragma unroll
        for (int i = 0; i < L; ++i) {
          const float dv = ds[(tt + i) * CPB + c];
          const float uv = to_float(us[(tt + i) * CPB + c]);
          float bcv[BC];
#pragma unroll
          for (int q = 0; q < BC / 4; ++q) {
            const float4 v = reinterpret_cast<const float4*>(bc + (tt + i) * L * BC)[q];
            bcv[4 * q] = v.x;
            bcv[4 * q + 1] = v.y;
            bcv[4 * q + 2] = v.z;
            bcv[4 * q + 3] = v.w;
          }
          const float du = dv * uv;
          p[i] = 0.f;
#pragma unroll
          for (int s = 0; s < STATES; ++s) {
            h[s] = ex2(dv * a2[s]) * h[s] + du * bcv[s];
            p[i] += h[s] * bcv[STATES + s];
          }
        }
        const float sum = reduce_scatter<L>(p, g);
        yo[(tt + g) * YS + c] = sum + to_float(us[(tt + g) * CPB + c]) * dskip;
      }
    }
#pragma unroll 4
    for (; tt < steps; ++tt) {
      const float dv = ds[tt * CPB + c];
      const float uv = to_float(us[tt * CPB + c]);
      float bcv[BC];                   // B_t then C_t of this lane's states
#pragma unroll
      for (int q = 0; q < BC / 4; ++q) {
        const float4 v = reinterpret_cast<const float4*>(bc + tt * L * BC)[q];
        bcv[4 * q] = v.x;
        bcv[4 * q + 1] = v.y;
        bcv[4 * q + 2] = v.z;
        bcv[4 * q + 3] = v.w;
      }
      const float du = dv * uv;
      float p = 0.f;
#pragma unroll
      for (int s = 0; s < STATES; ++s) {
        h[s] = ex2(dv * a2[s]) * h[s] + du * bcv[s];
        p += h[s] * bcv[STATES + s];
      }
#pragma unroll
      for (int o = L / 2; o > 0; o >>= 1) p += __shfl_xor_sync(0xffffffffu, p, o);
      if (g == 0) yo[tt * YS + c] = p + uv * dskip;
    }
    cp_async_wait0();                  // chunk k + 1 has landed (this thread's copies)
    __syncthreads();                   // ... everyone's; every scan of chunk k is done
    if (k + 1 < nchunks) widen(k + 1, st ^ 1);
    write_back(k, st);
    if (k + 2 < nchunks) stage(k + 2, st);
    __syncthreads();                   // chunk k + 1's widened B, C are visible
  }
#pragma unroll
  for (int s = 0; s < STATES; ++s) {
    const int n = STATES * g + s;
    if (dlive && n < N) hT[(static_cast<size_t>(b) * Din + d) * N + n] = h[s];
  }
}

template <typename T, int L, bool CK>
int launch_k(const void* u, const void* delta, const void* A, const void* B,
             const void* C, const void* D, const void* h0, void* y, void* hT, void* ckpt,
             int Bt, int Tlen, int Din, int N, cudaStream_t stream) {
  const int smem = smem_bytes<T, L>(N);
  cudaError_t err = cudaFuncSetAttribute(ssm_kernel<T, L, CK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(u) | reinterpret_cast<uintptr_t>(delta) |
                         reinterpret_cast<uintptr_t>(B) | reinterpret_cast<uintptr_t>(C) |
                         reinterpret_cast<uintptr_t>(y);
  const int es = static_cast<int>(sizeof(T));
  const int vec = (ptrs & 15u) == 0 && (Din * es) % 16 == 0 && (Din * 4) % 16 == 0 &&
                  (N * es) % 16 == 0;
  const dim3 grid((Din + CPB - 1) / CPB, Bt);
  ssm_kernel<T, L, CK><<<grid, CPB * L, smem, stream>>>(
      static_cast<const T*>(u), static_cast<const float*>(delta),
      static_cast<const float*>(A), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<const float*>(D),
      static_cast<const float*>(h0), static_cast<T*>(y), static_cast<float*>(hT),
      static_cast<float*>(ckpt), Tlen, Din, N, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int L>
int launch_l(const void* u, const void* delta, const void* A, const void* B,
             const void* C, const void* D, const void* h0, void* y, void* hT, void* ckpt,
             int Bt, int Tlen, int Din, int N, cudaStream_t stream) {
  if (ckpt != nullptr)
    return launch_k<T, L, true>(u, delta, A, B, C, D, h0, y, hT, ckpt, Bt, Tlen, Din, N, stream);
  return launch_k<T, L, false>(u, delta, A, B, C, D, h0, y, hT, ckpt, Bt, Tlen, Din, N, stream);
}

template <typename T>
int launch(const void* u, const void* delta, const void* A, const void* B,
           const void* C, const void* D, const void* h0, void* y, void* hT, void* ckpt,
           int Bt, int Tlen, int Din, int N, cudaStream_t stream) {
  if (N < 1 || N > MAX_N || Tlen < 1 || Din < 1 || Bt < 1 || Bt > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  int lanes = 1;                       // lanes a channel: the power of two >= N / STATES
  while (lanes * STATES < N) lanes *= 2;
#define ARGS u, delta, A, B, C, D, h0, y, hT, ckpt, Bt, Tlen, Din, N, stream
  if (lanes == 1) return launch_l<T, 1>(ARGS);
  if (lanes == 2) return launch_l<T, 2>(ARGS);
  if (lanes == 4) return launch_l<T, 4>(ARGS);
  return launch_l<T, 8>(ARGS);
#undef ARGS
}

}  // namespace

extern "C" {

// Returns the CUDA error of the launch (0 on success).  dtype of u, B, C and
// y: 0 fp32, 1 bf16; delta, A, D, h0, hT and ckpt are fp32.  ckpt: null, or
// the (Bt, ceil(T / 32), Din, N) buffer of chunk checkpoints.
int ssm_scan_fwd(const void* u, const void* delta, const void* A, const void* B,
                 const void* C, const void* D, const void* h0, void* y, void* hT,
                 void* ckpt, int Bt, int Tlen, int Din, int N, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(u, delta, A, B, C, D, h0, y, hT, ckpt, Bt, Tlen, Din, N, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(u, delta, A, B, C, D, h0, y, hT, ckpt, Bt, Tlen, Din, N, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* ssm_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
