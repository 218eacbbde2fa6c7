// Flash-attention forward for Hopper (sm_90a), written by hand.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention_pallas
// (body _attn_kernel): forward GQA attention with online softmax and fp32
// m / l / acc, causal and sliding-window masks over absolute int32 q_pos /
// kv_pos (so suffix-aligned prefill, Sq < Skv, works), kv head = h / G.
//
// Design.  One block per (64-row q tile, q head, batch), 256 threads: four
// threads per q row, each owning a quarter of the head dim (interleaved
// float4 chunks, so the four read 64 consecutive bytes of a shared K/V row and
// eight rows of a warp share them by broadcast).  K/V tiles of the kv head
// h / G are staged in shared memory as fp32; repeated heads are never
// materialised.  Scores are reduced across the four threads with two
// shuffles.  Unlike the Pallas kernel, any Sq / Skv is taken: the ragged q
// tile and the ragged kv tile are masked here.  Masked scores take the
// reference's finite sentinel NEG_INF = -1e30 (not -inf), so a fully masked
// tile gives exactly what kernels/ref.py gives and never a NaN.  A kv tile
// that is masked for every row of the q tile is skipped once every row has
// seen a valid key: its contribution is then exactly zero.
//
// What bounds it on the card: the multiply-adds (plain fp32 FMAs here, no
// mma/wgmma yet) and shared-memory reads, not device memory: each K/V byte
// is read once per q tile.  Tensor-core tiles are later work.
#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;              // q rows per block
constexpr int TPR = 4;              // threads per q row
constexpr int THREADS = BQ * TPR;   // 256

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&a);
  raw.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ bool key_valid(int kp, int qp, int causal, int window) {
  return (!causal || kp <= qp) && (window < 0 || kp > qp - window);
}

// q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D); out: (B, Sq, Hq, D); all contiguous.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ q_pos,
                 const int* __restrict__ kv_pos, T* __restrict__ out,
                 int Sq, int Skv, int Hq, int Hkv, int causal, int window,
                 float scale) {
  constexpr int NC = D / 16;                // float4 chunks per thread
  constexpr int BK = (D <= 64) ? 64 : 32;   // kv rows per shared tile
  __shared__ __align__(16) float ks[BK * D];
  __shared__ __align__(16) float vs[BK * D];
  __shared__ int kps[BK];
  __shared__ int q_lo, q_hi;

  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int part = tid % TPR;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int qi = blockIdx.x * BQ + row;
  const bool live = qi < Sq;

  float4 qr[NC];
  float4 acc[NC];
  const T* qrow = q + ((static_cast<size_t>(b) * Sq + (live ? qi : 0)) * Hq + h) * D;
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const float4 x = live ? load4(qrow + 4 * (part + TPR * i)) : make_float4(0.f, 0.f, 0.f, 0.f);
    qr[i] = make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const int qp = live ? q_pos[qi] : 0;
  float m = NEG_INF;
  float l = 0.f;
  bool seen = !live;   // rows past Sq never hold a tile back from a skip

  if (tid == 0) {
    q_lo = INT_MAX;
    q_hi = INT_MIN;
  }
  __syncthreads();
  if (live && part == 0) {
    atomicMin(&q_lo, qp);
    atomicMax(&q_hi, qp);
  }
  __syncthreads();
  const int lo = q_lo;
  const int hi = q_hi;

  const size_t row_stride = static_cast<size_t>(Hkv) * D;
  const T* kbase = k + (static_cast<size_t>(b) * Skv * Hkv + hk) * D;
  const T* vbase = v + (static_cast<size_t>(b) * Skv * Hkv + hk) * D;

  for (int t0 = 0; t0 < Skv; t0 += BK) {
    const int n = min(BK, Skv - t0);
    int maybe = 0;
    if (tid < n) {
      const int kp = kv_pos[t0 + tid];
      kps[tid] = kp;
      maybe = (!causal || kp <= hi) && (window < 0 || kp > lo - window);
    }
    const int any_maybe = __syncthreads_or(maybe);
    const int all_seen = __syncthreads_and(seen);
    if (!any_maybe && all_seen) continue;

    for (int e = tid; e < BK * (D / 4); e += THREADS) {
      const int r = e / (D / 4);
      const int c = 4 * (e % (D / 4));
      float4 kk = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vv = kk;
      if (r < n) {
        const size_t off = static_cast<size_t>(t0 + r) * row_stride + c;
        kk = load4(kbase + off);
        vv = load4(vbase + off);
      }
      store4(&ks[r * D + c], kk);
      store4(&vs[r * D + c], vv);
    }
    __syncthreads();

    float s[BK];
    float tmax = NEG_INF;
    bool any_valid = false;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float d = 0.f;
#pragma unroll
      for (int i = 0; i < NC; ++i) d = dot4(qr[i], load4(&ks[j * D + 4 * (part + TPR * i)]), d);
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      if (j < n) {
        const bool ok = key_valid(kps[j], qp, causal, window);
        any_valid |= ok;
        s[j] = ok ? d : NEG_INF;
        tmax = fmaxf(tmax, s[j]);
      }
    }
    const float m_new = fmaxf(m, tmax);
    const float corr = expf(m - m_new);
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      acc[i].x *= corr; acc[i].y *= corr; acc[i].z *= corr; acc[i].w *= corr;
    }
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      if (j < n) {
        const float p = expf(s[j] - m_new);
        psum += p;
#pragma unroll
        for (int i = 0; i < NC; ++i) {
          const float4 vv = load4(&vs[j * D + 4 * (part + TPR * i)]);
          acc[i].x = fmaf(p, vv.x, acc[i].x);
          acc[i].y = fmaf(p, vv.y, acc[i].y);
          acc[i].z = fmaf(p, vv.z, acc[i].z);
          acc[i].w = fmaf(p, vv.w, acc[i].w);
        }
      }
    }
    l = l * corr + psum;
    m = m_new;
    seen = seen || any_valid;
    __syncthreads();
  }

  if (live) {
    const float denom = fmaxf(l, 1e-30f);
    T* orow = out + ((static_cast<size_t>(b) * Sq + qi) * Hq + h) * D;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      store4(orow + 4 * (part + TPR * i),
             make_float4(acc[i].x / denom, acc[i].y / denom, acc[i].z / denom, acc[i].w / denom));
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* q_pos,
           const void* kv_pos, void* out, int B, int Sq, int Skv, int Hq,
           int Hkv, int causal, int window, float scale, cudaStream_t stream) {
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  flash_fwd_kernel<T, D><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(q_pos), static_cast<const int*>(kv_pos),
      static_cast<T*>(out), Sq, Skv, Hq, Hkv, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, const void* q_pos,
               const void* kv_pos, void* out, int B, int Sq, int Skv, int Hq,
               int Hkv, int D, int causal, int window, float scale,
               cudaStream_t stream) {
#define REPRO_FLASH_CASE(DD)                                                     \
  case DD:                                                                       \
    return launch<T, DD>(q, k, v, q_pos, kv_pos, out, B, Sq, Skv, Hq, Hkv,       \
                         causal, window, scale, stream);
  switch (D) {
    REPRO_FLASH_CASE(16)
    REPRO_FLASH_CASE(32)
    REPRO_FLASH_CASE(48)
    REPRO_FLASH_CASE(64)
    REPRO_FLASH_CASE(80)
    REPRO_FLASH_CASE(96)
    REPRO_FLASH_CASE(112)
    REPRO_FLASH_CASE(128)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_FLASH_CASE
}

}  // namespace

extern "C" {

// Returns the CUDA error of the launch (0 on success).  dtype: 0 fp32, 1 bf16.
// window < 0 means no sliding window.
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        const void* q_pos, const void* kv_pos, void* out,
                        int B, int Sq, int Skv, int Hq, int Hkv, int D,
                        int causal, int window, float scale, int dtype,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, q_pos, kv_pos, out, B, Sq, Skv, Hq, Hkv,
                             D, causal, window, scale, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, q_pos, kv_pos, out, B, Sq, Skv,
                                     Hq, Hkv, D, causal, window, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
