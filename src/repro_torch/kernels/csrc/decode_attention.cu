// Decode attention for Hopper (sm_90a), written by hand: one new query token
// per sequence against a KV cache under a boolean valid mask.
//
// Replaces the TPU kernel repro/kernels/decode_attention.py::
// decode_attention_pallas (body _decode_kernel): all G = Hq / Hkv query heads
// of one kv head in one program, online softmax in fp32 over cache tiles,
// masked scores at the reference's finite sentinel NEG_INF = -1e30.
//
// Design.  One block per (kv head, batch), 256 threads.  Per cache tile of TS
// rows: the K and V rows of the kv head are staged in shared memory as fp32
// (row stride D + 1, so column reads are free of bank conflicts); each thread
// scores (head, key) pairs; one warp per head folds the tile into that head's
// running max / denominator; each thread then owns up to four (head, dim)
// outputs of the fp32 accumulator.  valid_mask is read as bytes (torch.bool).
// Rows past S in the last tile do not exist (they are skipped, not masked).
//
// What bounds it on the card: device-memory bytes (each cache byte is read
// once; a few FLOPs per byte).  At B = 1 it runs B * Hkv blocks, 8 of 132 SMs
// on granite-3-2b, so it is far from that bound: splitting the cache across
// blocks (split-K with a second reduction pass) is later work.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 256;
constexpr int MAXPER = 4;            // accumulator outputs per thread: G * D <= 1024
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_float(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_float(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// q: (B, Hq, D); k, v: (B, S, Hkv, D); valid: (B, S) bytes; out: (B, Hq, D).
template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const uint8_t* __restrict__ valid,
              T* __restrict__ out, int S, int Hq, int Hkv, int D, int TS,
              float scale) {
  extern __shared__ __align__(16) float smem[];
  const int G = Hq / Hkv;
  const int DP = D + 1;
  float* ks = smem;                 // TS * DP
  float* vs = ks + TS * DP;         // TS * DP
  float* qs = vs + TS * DP;         // G * D, pre-scaled
  float* ss = qs + G * D;           // G * TS scores, then probabilities
  float* mrow = ss + G * TS;        // G running max
  float* lrow = mrow + G;           // G running denominators
  float* crow = lrow + G;           // G corrections of the current tile

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  const T* qb = q + (static_cast<size_t>(b) * Hq + static_cast<size_t>(hk) * G) * D;
  for (int e = tid; e < G * D; e += THREADS) qs[e] = to_float(qb[e]) * scale;
  for (int g = tid; g < G; g += THREADS) {
    mrow[g] = NEG_INF;
    lrow[g] = 0.f;
  }
  float acc[MAXPER];
#pragma unroll
  for (int i = 0; i < MAXPER; ++i) acc[i] = 0.f;

  const size_t row_stride = static_cast<size_t>(Hkv) * D;
  const T* kb = k + (static_cast<size_t>(b) * S * Hkv + hk) * D;
  const T* vb = v + (static_cast<size_t>(b) * S * Hkv + hk) * D;
  const uint8_t* mb = valid + static_cast<size_t>(b) * S;
  __syncthreads();

  for (int t0 = 0; t0 < S; t0 += TS) {
    const int n = min(TS, S - t0);
    for (int e = tid; e < n * D; e += THREADS) {
      const int r = e / D;
      const int c = e % D;
      const size_t off = static_cast<size_t>(t0 + r) * row_stride + c;
      ks[r * DP + c] = to_float(kb[off]);
      vs[r * DP + c] = to_float(vb[off]);
    }
    __syncthreads();

    for (int e = tid; e < G * TS; e += THREADS) {
      const int g = e / TS;
      const int j = e % TS;
      if (j < n) {
        const float* qg = qs + g * D;
        const float* kr = ks + j * DP;
        float d = 0.f;
        for (int c = 0; c < D; ++c) d = fmaf(qg[c], kr[c], d);
        ss[g * TS + j] = mb[t0 + j] ? d : NEG_INF;
      }
    }
    __syncthreads();

    for (int g = warp; g < G; g += WARPS) {
      float* sg = ss + g * TS;
      float mx = NEG_INF;
      for (int j = lane; j < n; j += 32) mx = fmaxf(mx, sg[j]);
      mx = warp_max(mx);
      const float m_new = fmaxf(mrow[g], mx);
      float ps = 0.f;
      for (int j = lane; j < n; j += 32) {
        const float p = expf(sg[j] - m_new);
        sg[j] = p;
        ps += p;
      }
      ps = warp_sum(ps);
      __syncwarp();   // every lane has read mrow[g] before lane 0 rewrites it
      if (lane == 0) {
        const float corr = expf(mrow[g] - m_new);
        crow[g] = corr;
        lrow[g] = lrow[g] * corr + ps;
        mrow[g] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < MAXPER; ++i) {
      const int e = tid + i * THREADS;
      if (e < G * D) {
        const int g = e / D;
        const int c = e % D;
        const float* pg = ss + g * TS;
        float a = acc[i] * crow[g];
        for (int j = 0; j < n; ++j) a = fmaf(pg[j], vs[j * DP + c], a);
        acc[i] = a;
      }
    }
    __syncthreads();
  }

  T* ob = out + (static_cast<size_t>(b) * Hq + static_cast<size_t>(hk) * G) * D;
#pragma unroll
  for (int i = 0; i < MAXPER; ++i) {
    const int e = tid + i * THREADS;
    if (e < G * D) from_float(ob + e, acc[i] / fmaxf(lrow[e / D], 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* valid,
           void* out, int B, int S, int Hq, int Hkv, int D, float scale,
           cudaStream_t stream) {
  const int G = Hq / Hkv;
  if (G * Hkv != Hq || G * D > MAXPER * THREADS || D > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  const int TS = D <= 64 ? 64 : 32;
  const size_t smem = sizeof(float) *
      (2 * static_cast<size_t>(TS) * (D + 1) + G * D + G * TS + 3 * G);
  const dim3 grid(Hkv, B);
  decode_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(valid), static_cast<T*>(out), S, Hq, Hkv, D,
      TS, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns the CUDA error of the launch (0 on success).  dtype: 0 fp32, 1 bf16.
int decode_attention_fwd(const void* q, const void* k, const void* v,
                         const void* valid, void* out, int B, int S, int Hq,
                         int Hkv, int D, float scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(q, k, v, valid, out, B, S, Hq, Hkv, D, scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, valid, out, B, S, Hq, Hkv, D, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
