// Flash-attention backward for Hopper (sm_90a), written by hand.
//
// The gradient of the forward in flash_attention.cu (the port of
// repro/kernels/flash_attention.py::flash_attention_pallas): dq, dk and dv of
// softmax(mask(scale * q k^T)) v for GQA heads (kv head = h / G), causal and
// sliding-window masks over absolute int32 q_pos / kv_pos, any Sq / Skv, any
// head dim D that is a multiple of 8 up to 128, fp32 or bf16 in and out, fp32
// accumulation.  The JAX package trains by differentiating its jnp flash
// attention (repro/kernels/ops.py::_flash_reference); no TPU kernel has a
// backward.
//
// Masking follows the forward exactly.  A masked score is the finite
// sentinel NEG_INF = -1e30, so a row that has seen no valid key weights
// every existing key by 1 / Skv: it adds dO / Skv to dv of every key and
// nothing to dq or dk (the gradient at a masked score is zero).  A key past
// Skv does not exist and contributes nothing.
//
// Three kernels a call, all SIMT FMA, 256 threads a block, four threads a
// row, each with a quarter of the (padded) head dim in float4 chunks:
//   bwd_stats  one block per (64-row q tile, q head, batch): each row's max
//              score m and 1 / l (l the sum of exp(s - m) over the keys), and
//              Dr = rowsum(dO * O) with O the forward's output as stored.  The
//              pair (m, 1 / l) rather than lse = m + log l: for a row with no
//              valid key m = NEG_INF and log l vanishes beside it in fp32, so
//              lse could not give back the 1 / Skv weight;
//   bwd_dq     one block per (64-row q tile, q head, batch) over the kv
//              tiles: dq = scale * sum_j dS_ij k_j;
//   bwd_dkdv   one block per (64-row kv tile, kv head, batch) over the G q
//              heads of the group and their q tiles: dv = sum_i P_ij dO_i,
//              dk = sum_i dS_ij (scale q_i).  Each dk / dv row is written
//              once: no atomics, so two calls on the same inputs agree bit
//              for bit (recomputation under activation checkpointing
//              relies on it).
// with P = exp(s - m) / l and dS = P (dO v^T - Dr) on valid scores, 0 on
// masked ones.  All three compute s = (scale q) . k with the same chunk
// order and the same shuffle reduction, so P is the same number in each.
// A tile pair holding no valid score is skipped only where that is exact:
// bwd_dq skips it outright (masked scores add nothing to dq); bwd_stats and
// bwd_dkdv skip it only once every row of the q tile has seen a valid key
// (then P is exactly 0 on every masked score), the forward's rule.
//
// What bounds it on the card: at granite-3-2b's training shape (B 8, S 256,
// 32/8 heads, D 64, causal, bf16) the bound is device memory (42 MB of q, k,
// v, o, dO, dq, dk, dv: 0.0125 ms); the products (5.4 GFLOP over 8.4 M
// unmasked pairs) take 5.4 us at the bf16 tensor-core peak.  These kernels
// are bound by neither but by latency: each pair is a chain of two 4-lane
// dot products, two shuffle reductions, an exp and two axpys on the FMA
// units, in 256 dk / dv blocks of one block an SM (up to 238 registers a
// thread).  Tensor-core products (wgmma) and row statistics written by the
// forward are the redesign.
#include <climits>
#include <cstdint>
#include <cstring>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int ROWS = 64;              // rows a block owns
constexpr int TPR = 4;                // threads per row
constexpr int THREADS = ROWS * TPR;   // 256
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ bool key_valid(int kp, int qp, int causal, int window) {
  return (!causal || kp <= qp) && (window < 0 || kp > qp - window);
}

// whether a key at a position in [k_lo, k_hi] may be valid for a query at a
// position in [q_lo, q_hi]
__device__ __forceinline__ bool may_meet(int k_lo, int k_hi, int q_lo, int q_hi,
                                         int causal, int window) {
  return (!causal || k_lo <= q_hi) && (window < 0 || k_hi > q_lo - window);
}

template <typename T>
struct Io;

template <>
struct Io<float> {
  static __device__ __forceinline__ float4 load(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ void store(float* p, float4 x) {
    *reinterpret_cast<float4*>(p) = x;
  }
};

template <>
struct Io<__nv_bfloat16> {
  static __device__ __forceinline__ float4 load(const __nv_bfloat16* p) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    __nv_bfloat162 a, b;
    memcpy(&a, &raw.x, 4);
    memcpy(&b, &raw.y, 4);
    const float2 fa = __bfloat1622float2(a);
    const float2 fb = __bfloat1622float2(b);
    return make_float4(fa.x, fa.y, fb.x, fb.y);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float4 x) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
    const __nv_bfloat162 b = __floats2bfloat162_rn(x.z, x.w);
    uint2 raw;
    memcpy(&raw.x, &a, 4);
    memcpy(&raw.y, &b, 4);
    *reinterpret_cast<uint2*>(p) = raw;
  }
};

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void axpy4(float a, float4 x, float4& y) {
  y.x = fmaf(a, x.x, y.x);
  y.y = fmaf(a, x.y, y.y);
  y.z = fmaf(a, x.z, y.z);
  y.w = fmaf(a, x.w, y.w);
}

__device__ __forceinline__ float row_sum(float d) {
  d += __shfl_xor_sync(FULL, d, 1);
  return d + __shfl_xor_sync(FULL, d, 2);
}

__device__ __forceinline__ float4 scaled(float4 x, float s) {
  return make_float4(x.x * s, x.y * s, x.z * s, x.w * s);
}

// the column of this thread's i-th chunk
__device__ __forceinline__ int col(int part, int i) { return 4 * (part + TPR * i); }

// the q rows' position range of a q tile, over its live rows
__device__ __forceinline__ void position_range(int* lo, int* hi, bool live, int pos,
                                               int part) {
  if (threadIdx.x == 0) {
    *lo = INT_MAX;
    *hi = INT_MIN;
  }
  __syncthreads();
  if (live && part == 0) {
    atomicMin(lo, pos);
    atomicMax(hi, pos);
  }
  __syncthreads();
}

// Stage rows [t0, t0 + n) of a (.., S, H, D) head into a (BR, DP) fp32 tile,
// times `mul`; rows past n and columns past D are zero.
template <typename T, int DP, int BR>
__device__ __forceinline__ void stage(float* tile, const T* base, size_t row_stride, int t0,
                                      int n, int D, float mul) {
  for (int e = threadIdx.x; e < BR * (DP / 4); e += THREADS) {
    const int r = e / (DP / 4);
    const int c = 4 * (e % (DP / 4));
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n && c < D) x = scaled(Io<T>::load(base + static_cast<size_t>(t0 + r) * row_stride + c), mul);
    *reinterpret_cast<float4*>(&tile[r * DP + c]) = x;
  }
}

// --------------------------------------------------------------------------
// bwd_stats: m, 1 / l and Dr of each q row
// --------------------------------------------------------------------------
template <typename T, int DP>
__global__ void __launch_bounds__(THREADS)
bwd_stats(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ out,
          const T* __restrict__ dout, const int* __restrict__ q_pos,
          const int* __restrict__ kv_pos, float* __restrict__ m_out,
          float* __restrict__ linv_out, float* __restrict__ dr_out, int Sq, int Skv,
          int Hq, int Hkv, int D, int causal, int window, float scale) {
  constexpr int NC = DP / 16;
  constexpr int BK = (DP <= 64) ? 64 : 32;
  __shared__ __align__(16) float ks[BK * DP];
  __shared__ int kps[BK];
  __shared__ int q_lo, q_hi;

  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int part = tid % TPR;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int qi = blockIdx.x * ROWS + row;
  const bool live = qi < Sq;
  const size_t qoff = ((static_cast<size_t>(b) * Sq + (live ? qi : 0)) * Hq + h) * D;

  float4 qr[NC];
  float dr = 0.f;
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = col(part, i);
    const bool in = live && c < D;
    qr[i] = in ? scaled(Io<T>::load(q + qoff + c), scale) : make_float4(0.f, 0.f, 0.f, 0.f);
    if (in) dr = dot4(Io<T>::load(dout + qoff + c), Io<T>::load(out + qoff + c), dr);
  }
  dr = row_sum(dr);
  const int qp = live ? q_pos[qi] : 0;
  position_range(&q_lo, &q_hi, live, qp, part);
  const int lo = q_lo, hi = q_hi;

  float m = NEG_INF;
  float l = 0.f;
  bool seen = !live;
  const size_t row_stride = static_cast<size_t>(Hkv) * D;
  const T* kbase = k + (static_cast<size_t>(b) * Skv * Hkv + hk) * D;

  for (int t0 = 0; t0 < Skv; t0 += BK) {
    const int n = min(BK, Skv - t0);
    int maybe = 0;
    if (tid < n) {
      const int kp = kv_pos[t0 + tid];
      kps[tid] = kp;
      maybe = may_meet(kp, kp, lo, hi, causal, window);
    }
    const int any_maybe = __syncthreads_or(maybe);
    const int all_seen = __syncthreads_and(seen);
    if (!any_maybe && all_seen) continue;
    stage<T, DP, BK>(ks, kbase, row_stride, t0, n, D, 1.f);
    __syncthreads();
    bool any_valid = false;
    for (int j = 0; j < BK; ++j) {
      float d = 0.f;
#pragma unroll
      for (int i = 0; i < NC; ++i) d = dot4(qr[i], lds4(&ks[j * DP + col(part, i)]), d);
      d = row_sum(d);
      if (j < n) {
        const bool ok = key_valid(kps[j], qp, causal, window);
        any_valid |= ok;
        const float s = ok ? d : NEG_INF;
        if (s > m) {
          l = l * expf(m - s) + 1.f;
          m = s;
        } else {
          l += expf(s - m);
        }
      }
    }
    seen = seen || any_valid;
    __syncthreads();
  }
  if (live && part == 0) {
    const size_t idx = (static_cast<size_t>(b) * Hq + h) * Sq + qi;
    m_out[idx] = m;
    linv_out[idx] = 1.f / l;
    dr_out[idx] = dr;
  }
}

// --------------------------------------------------------------------------
// bwd_dq: dq = scale * sum_j dS_ij k_j
// --------------------------------------------------------------------------
template <typename T, int DP>
__global__ void __launch_bounds__(THREADS)
bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
       const T* __restrict__ dout, const int* __restrict__ q_pos,
       const int* __restrict__ kv_pos, const float* __restrict__ m_in,
       const float* __restrict__ linv_in, const float* __restrict__ dr_in,
       T* __restrict__ dq, int Sq, int Skv, int Hq, int Hkv, int D, int causal, int window,
       float scale) {
  constexpr int NC = DP / 16;
  constexpr int BK = (DP <= 64) ? 64 : 32;
  __shared__ __align__(16) float ks[BK * DP];
  __shared__ __align__(16) float vs[BK * DP];
  __shared__ int kps[BK];
  __shared__ int q_lo, q_hi;

  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int part = tid % TPR;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int qi = blockIdx.x * ROWS + row;
  const bool live = qi < Sq;
  const size_t qoff = ((static_cast<size_t>(b) * Sq + (live ? qi : 0)) * Hq + h) * D;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

  float4 qr[NC], dor[NC], acc[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = col(part, i);
    const bool in = live && c < D;
    qr[i] = in ? scaled(Io<T>::load(q + qoff + c), scale) : zero4;
    dor[i] = in ? Io<T>::load(dout + qoff + c) : zero4;
    acc[i] = zero4;
  }
  const size_t sidx = (static_cast<size_t>(b) * Hq + h) * Sq + (live ? qi : 0);
  const float m = live ? m_in[sidx] : 0.f;
  const float linv = live ? linv_in[sidx] : 0.f;
  const float dr = live ? dr_in[sidx] : 0.f;
  const int qp = live ? q_pos[qi] : 0;
  position_range(&q_lo, &q_hi, live, qp, part);
  const int lo = q_lo, hi = q_hi;

  const size_t row_stride = static_cast<size_t>(Hkv) * D;
  const size_t head = (static_cast<size_t>(b) * Skv * Hkv + hk) * D;

  for (int t0 = 0; t0 < Skv; t0 += BK) {
    const int n = min(BK, Skv - t0);
    int maybe = 0;
    if (tid < n) {
      const int kp = kv_pos[t0 + tid];
      kps[tid] = kp;
      maybe = may_meet(kp, kp, lo, hi, causal, window);
    }
    if (!__syncthreads_or(maybe)) continue;   // no valid score: nothing for dq
    stage<T, DP, BK>(ks, k + head, row_stride, t0, n, D, 1.f);
    stage<T, DP, BK>(vs, v + head, row_stride, t0, n, D, 1.f);
    __syncthreads();
    for (int j = 0; j < BK; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        s = dot4(qr[i], lds4(&ks[j * DP + col(part, i)]), s);
        dp = dot4(dor[i], lds4(&vs[j * DP + col(part, i)]), dp);
      }
      s = row_sum(s);
      dp = row_sum(dp);
      if (live && j < n && key_valid(kps[j], qp, causal, window)) {
        const float ds = expf(s - m) * linv * (dp - dr);
#pragma unroll
        for (int i = 0; i < NC; ++i) axpy4(ds, lds4(&ks[j * DP + col(part, i)]), acc[i]);
      }
    }
    __syncthreads();
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = col(part, i);
      if (c < D) Io<T>::store(dq + qoff + c, scaled(acc[i], scale));
    }
  }
}

// --------------------------------------------------------------------------
// bwd_dkdv: dv = sum_i P_ij dO_i and dk = sum_i dS_ij (scale q_i), over the
// G q heads of the kv head and every q tile
// --------------------------------------------------------------------------
template <typename T, int DP>
__global__ void __launch_bounds__(THREADS)
bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
         const T* __restrict__ dout, const int* __restrict__ q_pos,
         const int* __restrict__ kv_pos, const float* __restrict__ m_in,
         const float* __restrict__ linv_in, const float* __restrict__ dr_in,
         T* __restrict__ dk, T* __restrict__ dv, int Sq, int Skv, int Hq, int Hkv, int D,
         int causal, int window, float scale) {
  constexpr int NC = DP / 16;
  constexpr int TQ = (DP <= 64) ? 64 : 32;     // q rows per shared tile
  __shared__ __align__(16) float qs[TQ * DP];  // scale * q
  __shared__ __align__(16) float dos[TQ * DP];
  __shared__ float ms[TQ], ls[TQ], drs[TQ];
  __shared__ int qps[TQ];
  __shared__ int k_lo, k_hi;

  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int part = tid % TPR;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int G = Hq / Hkv;
  const int kj = blockIdx.x * ROWS + row;
  const bool live = kj < Skv;
  const size_t koff = ((static_cast<size_t>(b) * Skv + (live ? kj : 0)) * Hkv + hk) * D;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

  float4 kr[NC], vr[NC], dka[NC], dva[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = col(part, i);
    const bool in = live && c < D;
    kr[i] = in ? Io<T>::load(k + koff + c) : zero4;
    vr[i] = in ? Io<T>::load(v + koff + c) : zero4;
    dka[i] = zero4;
    dva[i] = zero4;
  }
  const int kp = live ? kv_pos[kj] : 0;
  position_range(&k_lo, &k_hi, live, kp, part);
  const int lo = k_lo, hi = k_hi;
  const size_t row_stride = static_cast<size_t>(Hq) * D;

  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const size_t head = (static_cast<size_t>(b) * Sq * Hq + h) * D;
    const size_t stats = (static_cast<size_t>(b) * Hq + h) * Sq;
    for (int t0 = 0; t0 < Sq; t0 += TQ) {
      const int nq = min(TQ, Sq - t0);
      int maybe = 0, seen = 1;
      if (tid < nq) {
        const int qp = q_pos[t0 + tid];
        const float mm = m_in[stats + t0 + tid];
        qps[tid] = qp;
        ms[tid] = mm;
        ls[tid] = linv_in[stats + t0 + tid];
        drs[tid] = dr_in[stats + t0 + tid];
        maybe = may_meet(lo, hi, qp, qp, causal, window);
        seen = mm > 0.5f * NEG_INF;
      }
      const int any_maybe = __syncthreads_or(maybe);
      const int all_seen = __syncthreads_and(seen);
      if (!any_maybe && all_seen) continue;   // every P here is exactly 0
      stage<T, DP, TQ>(qs, q + head, row_stride, t0, nq, D, scale);
      stage<T, DP, TQ>(dos, dout + head, row_stride, t0, nq, D, 1.f);
      __syncthreads();
      for (int i = 0; i < TQ; ++i) {
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          s = dot4(lds4(&qs[i * DP + col(part, c)]), kr[c], s);
          dp = dot4(lds4(&dos[i * DP + col(part, c)]), vr[c], dp);
        }
        s = row_sum(s);
        dp = row_sum(dp);
        if (!live || i >= nq) continue;
        const float w = ls[i];
        if (key_valid(kp, qps[i], causal, window)) {
          const float p = expf(s - ms[i]) * w;
          const float ds = p * (dp - drs[i]);
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            axpy4(p, lds4(&dos[i * DP + col(part, c)]), dva[c]);
            axpy4(ds, lds4(&qs[i * DP + col(part, c)]), dka[c]);
          }
        } else {
          // a masked score: P is 0 unless the row has seen no valid key
          const float p = expf(NEG_INF - ms[i]) * w;
          if (p != 0.f) {
#pragma unroll
            for (int c = 0; c < NC; ++c) axpy4(p, lds4(&dos[i * DP + col(part, c)]), dva[c]);
          }
        }
      }
      __syncthreads();
    }
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = col(part, i);
      if (c < D) {
        Io<T>::store(dk + koff + c, dka[i]);
        Io<T>::store(dv + koff + c, dva[i]);
      }
    }
  }
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, const void* out, const void* dout,
           const void* q_pos, const void* kv_pos, void* dq, void* dk, void* dv, void* m,
           void* linv, void* dr, int B, int Sq, int Skv, int Hq, int Hkv, int D, int causal,
           int window, float scale, cudaStream_t stream) {
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  const int* qp = static_cast<const int*>(q_pos);
  const int* kp = static_cast<const int*>(kv_pos);
  float* fm = static_cast<float*>(m);
  float* fl = static_cast<float*>(linv);
  float* fd = static_cast<float*>(dr);
  const dim3 qgrid((Sq + ROWS - 1) / ROWS, Hq, B);
  bwd_stats<T, DP><<<qgrid, THREADS, 0, stream>>>(tq, tk, static_cast<const T*>(out), tdo,
                                                  qp, kp, fm, fl, fd, Sq, Skv, Hq, Hkv, D,
                                                  causal, window, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 kgrid((Skv + ROWS - 1) / ROWS, Hkv, B);
  bwd_dkdv<T, DP><<<kgrid, THREADS, 0, stream>>>(tq, tk, tv, tdo, qp, kp, fm, fl, fd,
                                                 static_cast<T*>(dk), static_cast<T*>(dv),
                                                 Sq, Skv, Hq, Hkv, D, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dq<T, DP><<<qgrid, THREADS, 0, stream>>>(tq, tk, tv, tdo, qp, kp, fm, fl, fd,
                                               static_cast<T*>(dq), Sq, Skv, Hq, Hkv, D,
                                               causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* out, const void* dout,
             const void* q_pos, const void* kv_pos, void* dq, void* dk, void* dv, void* m,
             void* linv, void* dr, int B, int Sq, int Skv, int Hq, int Hkv, int D, int causal,
             int window, float scale, cudaStream_t stream) {
#define REPRO_BWD_CASE(DD)                                                              \
  case DD:                                                                              \
    return launch<T, DD>(q, k, v, out, dout, q_pos, kv_pos, dq, dk, dv, m, linv, dr, B, \
                         Sq, Skv, Hq, Hkv, D, causal, window, scale, stream);
  switch ((D + 15) / 16 * 16) {
    REPRO_BWD_CASE(16)
    REPRO_BWD_CASE(32)
    REPRO_BWD_CASE(48)
    REPRO_BWD_CASE(64)
    REPRO_BWD_CASE(80)
    REPRO_BWD_CASE(96)
    REPRO_BWD_CASE(112)
    REPRO_BWD_CASE(128)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_BWD_CASE
}

}  // namespace

extern "C" {

// Three launches on `stream`: bwd_stats, bwd_dkdv, bwd_dq.  Returns the CUDA
// error of the first launch that failed (0 on success).  dtype: 0 fp32, 1
// bf16 (q, k, v, out, dout, dq, dk, dv alike).  m, linv, dr: fp32 scratch of
// B * Hq * Sq floats each.  window < 0 means no sliding window.
int flash_attention_bwd(const void* q, const void* k, const void* v, const void* out,
                        const void* dout, const void* q_pos, const void* kv_pos, void* dq,
                        void* dk, void* dv, void* m, void* linv, void* dr, int B, int Sq,
                        int Skv, int Hq, int Hkv, int D, int causal, int window, float scale,
                        int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D < 8 || D > 128 || D % 8 != 0 || Hkv <= 0 || Hq % Hkv != 0 || B < 1 || Sq < 1 ||
      Skv < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return dispatch<float>(q, k, v, out, dout, q_pos, kv_pos, dq, dk, dv, m, linv, dr, B, Sq,
                           Skv, Hq, Hkv, D, causal, window, scale, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, out, dout, q_pos, kv_pos, dq, dk, dv, m, linv,
                                   dr, B, Sq, Skv, Hq, Hkv, D, causal, window, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
