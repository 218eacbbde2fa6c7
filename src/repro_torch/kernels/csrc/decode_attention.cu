// Decode attention for Hopper (sm_90a), written by hand: one new query token
// per sequence against a KV cache under a boolean valid mask.
//
// Replaces the TPU kernel repro/kernels/decode_attention.py::
// decode_attention_pallas (body _decode_kernel): all G = Hq / Hkv query heads
// of one kv head against each cache row, online softmax in fp32, masked
// scores at the reference's finite sentinel NEG_INF = -1e30.
//
// Design: split-K.  Two device kernels a call, both launched from the one C
// entry point.  decode_split: grid (splits, Hkv, B), 128 threads; each block
// takes one chunk of cache rows for all G q heads of its kv head, so each
// cache byte is still read once.  The chunk is walked in tiles of 32 rows:
// the K and V rows come straight from device memory as 16-byte cp.async
// copies (coalesced, in the cache's dtype), two tiles in flight, so a tile's
// loads wait once; each row's G scores are reduced over D / 8 lanes (bf16) by
// shuffles; one warp a head folds the tile into the head's running max and
// sum; then each thread takes (head, 16-byte column vector, share of the
// rows) items of P V, and the shares are summed into the fp32 accumulator in
// shared memory.  The block
// writes its partial (m, l, acc[G, D]) in fp32 to scratch that the wrapper
// allocates.  decode_combine: one block per (q head, batch) rescales the
// partials by exp(m_s - max m) and sums them; it is launched with
// programmatic dependent launch, so its launch overlaps the split kernel.  A chunk that is wholly masked
// has m = NEG_INF, l = its row count and acc = the sum of its V; its weight is
// exactly 0 once some chunk holds a valid key, and when every key is masked
// the result is the mean of V, as in the reference.  Rows past S do not exist
// (they are skipped, not masked).
//
// Row statistics (the STATS instantiation of the combine): given three fp32
// outputs, the combine writes the normalised output in fp32 and each row's
// M = max_s m_s and L = sum_s l_s e^(m_s - M) instead of the output in the
// cache's dtype, so that a caller holding only some of a cache's rows (a
// cache split over ranks) can merge its softmax with the other rows' and
// round to the cache's dtype once, at the end.  The conventions are the
// split kernel's: a row with no valid key has M = NEG_INF, L = its row count
// and the mean of its V.  Any G and any D that is a multiple of 8 up
// to 128; the shared accumulator grows with G * D (dynamic shared memory).
//
// What bounds it on the card: device-memory bytes (each cache byte is read
// once; a few FLOPs per byte).  The wrapper picks the splits so that
// B * Hkv * splits is about two blocks per SM with chunks of at least 32 rows
// (16 splits x 8 kv heads = 128 blocks at B = 1 on granite-3-2b).
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int TR = 32;               // cache rows a tile (a chunk has at least 32)
static_assert(TR == 32, "the softmax pass gives each lane of a warp one row");
constexpr int STAGES = 2;            // K / V tiles in flight
constexpr int MAX_SPLITS = 512;      // the combine's shared weights
constexpr int MAX_DEVICES = 64;
constexpr int BATCH = 16;            // partials a combine thread loads at once

// 16 bytes of a K or V row: loaded raw, converted to fp32 where used
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;        // floats in 16 bytes
  __device__ static void convert(const uint4& x, float (&f)[4]) {
    f[0] = __uint_as_float(x.x); f[1] = __uint_as_float(x.y);
    f[2] = __uint_as_float(x.z); f[3] = __uint_as_float(x.w);
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;        // bf16 in 16 bytes
  __device__ static void convert(const uint4& x, float (&f)[8]) {
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

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

// Shared memory of one split block: STAGES K and V tiles of TR rows in the
// cache's dtype, then fp32 q (G D), scores (G TR), the tile's mask (TR),
// m / l / corr (3 G), acc (G D) and the P V shares (max(G D, THREADS * VEC)).
template <typename T>
size_t split_smem_bytes(int G, int D) {
  const size_t gd = static_cast<size_t>(G) * D;
  const size_t red = gd > static_cast<size_t>(THREADS) * Vec<T>::N ? gd
                                                                   : static_cast<size_t>(THREADS) * Vec<T>::N;
  return sizeof(T) * STAGES * 2 * TR * static_cast<size_t>(D) +
         sizeof(float) * (2 * gd + static_cast<size_t>(G) * TR + TR + 3 * G + red);
}

// q: (B, Hq, D); k, v: (B, S, Hkv, D); valid: (B, S) bytes.  Partials:
// acc (B, Hq, splits, D) and ml (B, Hq, splits, 2), fp32.
template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_split(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const uint8_t* __restrict__ valid, float* __restrict__ part_acc,
             float* __restrict__ part_ml, int S, int Hq, int Hkv, int D, int chunk,
             float scale) {
  constexpr int VEC = Vec<T>::N;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  // let the combine's blocks launch now; they wait for this grid to finish
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int G = Hq / Hkv;
  const int GD = G * D;
  const int DV = D / VEC;                                // 16-byte vectors a row
  T* kvs = reinterpret_cast<T*>(smem_raw);               // [stage][K, V][TR][D]
  float* qs = reinterpret_cast<float*>(kvs + STAGES * 2 * TR * D);   // G * D, pre-scaled
  float* ss = qs + GD;                                   // G * TR scores, then p
  float* mk = ss + G * TR;                               // TR: the tile's mask
  float* mrow = mk + TR;
  float* lrow = mrow + G;
  float* crow = lrow + G;
  float* acc = crow + G;                                 // G * D
  float* red = acc + GD;                                 // P V shares

  const int split = blockIdx.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int splits = gridDim.x;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int begin = split * chunk;
  const int end = min(S, begin + chunk);
  const size_t row_stride = static_cast<size_t>(Hkv) * D;
  const T* kb = k + (static_cast<size_t>(b) * S * Hkv + hk) * D;
  const T* vb = v + (static_cast<size_t>(b) * S * Hkv + hk) * D;
  const uint8_t* mb = valid + static_cast<size_t>(b) * S;

  // the K and V rows of tile t0 into stage st (16-byte cp.async, coalesced),
  // and this thread's mask byte into a register
  auto issue = [&](int t0, int st) {
    const int n = min(TR, end - t0);
    T* ks = kvs + st * 2 * TR * D;
    T* vs = ks + TR * D;
    for (int e = tid; e < n * DV; e += THREADS) {
      const int r = e / DV;
      const int c = (e % DV) * VEC;
      const size_t off = static_cast<size_t>(t0 + r) * row_stride + c;
      cp_async16(ks + r * D + c, kb + off);
      cp_async16(vs + r * D + c, vb + off);
    }
    cp_async_commit();
    return tid < n ? static_cast<int>(mb[t0 + tid]) : 0;
  };
  int mnext = begin < end ? issue(begin, 0) : 0;

  const T* qb = q + (static_cast<size_t>(b) * Hq + static_cast<size_t>(hk) * G) * D;
  for (int e = tid; e < GD; e += THREADS) {
    qs[e] = to_float(qb[e]) * scale;
    acc[e] = 0.f;
  }
  for (int g = tid; g < G; g += THREADS) {
    mrow[g] = NEG_INF;
    lrow[g] = 0.f;
  }
  // scores: LPR lanes a row (a power of two >= DV), RPW rows a warp at once
  int lpr = 1;
  while (lpr < DV) lpr <<= 1;
  const int rpw = 32 / lpr;
  const int sub = lane / lpr;
  const int li = lane % lpr;
  // P V items: (head, vector) pairs, each summed over a share of the rows
  const int ni = G * DV;
  const int rp = ni >= THREADS ? 1 : THREADS / ni;

  int st = 0;
  for (int t0 = begin; t0 < end; t0 += TR, st ^= 1) {
    const int n = min(TR, end - t0);
    const int mcur = mnext;
    if (t0 + TR < end) {
      mnext = issue(t0 + TR, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    if (tid < TR) mk[tid] = mcur ? 1.f : 0.f;
    __syncthreads();
    const T* ks = kvs + st * 2 * TR * D;
    const T* vs = ks + TR * D;

    for (int base = warp * rpw; base < n; base += WARPS * rpw) {   // warp-uniform
      const int r = base + sub;
      float kv[VEC];
      if (r < n && li < DV) {
        Vec<T>::convert(*reinterpret_cast<const uint4*>(ks + r * D + li * VEC), kv);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) kv[e] = 0.f;
      }
      const bool ok = r < n && mk[r] != 0.f;
      for (int g = 0; g < G; ++g) {
        float d = 0.f;
        if (li < DV) {
          const float* qg = qs + g * D + li * VEC;
#pragma unroll
          for (int e = 0; e < VEC; ++e) d = fmaf(qg[e], kv[e], d);
        }
        for (int o = lpr / 2; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
        if (r < n && li == 0) ss[g * TR + r] = ok ? d : NEG_INF;
      }
    }
    __syncthreads();

    for (int g = warp; g < G; g += WARPS) {
      float* sg = ss + g * TR;
      const float x = lane < n ? sg[lane] : NEG_INF;     // TR == 32: a lane a row
      const float m_old = mrow[g];
      const float m_new = fmaxf(m_old, warp_max(x));
      const float p = lane < n ? expf(x - m_new) : 0.f;
      if (lane < n) sg[lane] = p;
      const float ps = warp_sum(p);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        crow[g] = corr;
        lrow[g] = lrow[g] * corr + ps;
        mrow[g] = m_new;
      }
    }
    __syncthreads();

    for (int item = tid; item < rp * ni; item += THREADS) {
      const int it = item % ni;
      const int share = item / ni;
      const int g = it / DV;
      const int c = (it % DV) * VEC;
      const float* pg = ss + g * TR;
      float a[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) a[e] = 0.f;
      for (int j = share; j < n; j += rp) {
        float vv[VEC];
        Vec<T>::convert(*reinterpret_cast<const uint4*>(vs + j * D + c), vv);
        const float pj = pg[j];
#pragma unroll
        for (int e = 0; e < VEC; ++e) a[e] = fmaf(pj, vv[e], a[e]);
      }
      float* out = red + static_cast<size_t>(share) * GD + g * D + c;
#pragma unroll
      for (int e = 0; e < VEC; ++e) out[e] = a[e];
    }
    __syncthreads();
    for (int e = tid; e < GD; e += THREADS) {
      float a = acc[e] * crow[e / D];
      for (int s2 = 0; s2 < rp; ++s2) a += red[static_cast<size_t>(s2) * GD + e];
      acc[e] = a;
    }
    __syncthreads();
  }

  const size_t head0 = static_cast<size_t>(b) * Hq + static_cast<size_t>(hk) * G;
  for (int e = tid; e < GD; e += THREADS) {
    const int g = e / D;
    part_acc[((head0 + g) * splits + split) * D + e % D] = acc[e];
  }
  for (int g = tid; g < G; g += THREADS) {
    part_ml[((head0 + g) * splits + split) * 2] = mrow[g];
    part_ml[((head0 + g) * splits + split) * 2 + 1] = lrow[g];
  }
}

// One block per (q head, batch), a thread a column: the partials rescaled to
// the largest running max and summed.  Launched with programmatic stream
// serialization: its blocks start while the split kernel runs and wait for
// it at griddepcontrol.wait.  The splits' weights are computed once, in
// shared memory; each thread's column loads are issued BATCH at a time.
template <typename T, bool STATS>
__global__ void __launch_bounds__(THREADS)
decode_combine(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
               T* __restrict__ out, float* __restrict__ out_f32, float* __restrict__ m_out,
               float* __restrict__ l_out, int Hq, int D, int splits) {
  __shared__ float sw[MAX_SPLITS];
  __shared__ float sl[MAX_SPLITS];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const size_t head = static_cast<size_t>(b) * Hq + h;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const float* ml = part_ml + head * splits * 2;
  const float* pa = part_acc + head * splits * D + tid;
  float x[BATCH];
#pragma unroll
  for (int u = 0; u < BATCH; ++u)
    x[u] = (u < splits && tid < D) ? pa[static_cast<size_t>(u) * D] : 0.f;
  for (int s = tid; s < splits; s += THREADS) {
    sw[s] = ml[2 * s];
    sl[s] = ml[2 * s + 1];
  }
  __syncthreads();
  float m = NEG_INF;
  for (int s = 0; s < splits; ++s) m = fmaxf(m, sw[s]);
  __syncthreads();
  for (int s = tid; s < splits; s += THREADS) sw[s] = expf(sw[s] - m);
  __syncthreads();
  if (tid >= D) return;
  float l = 0.f, a = 0.f;
  for (int s = 0; s < splits; ++s) l = fmaf(sw[s], sl[s], l);
  for (int s0 = 0; s0 < splits; s0 += BATCH) {
    if (s0 > 0) {
#pragma unroll
      for (int u = 0; u < BATCH; ++u)
        x[u] = s0 + u < splits ? pa[static_cast<size_t>(s0 + u) * D] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u)
      if (s0 + u < splits) a = fmaf(sw[s0 + u], x[u], a);
  }
  const float r = a / fmaxf(l, 1e-30f);
  if constexpr (STATS) {
    out_f32[head * D + tid] = r;
    if (tid == 0) {
      m_out[head] = m;
      l_out[head] = l;
    }
  } else {
    from_float(out + head * D + tid, r);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* valid, void* out,
           void* scratch, float* out_f32, float* m, float* l, int B, int S, int Hq, int Hkv,
           int D, int splits, float scale, cudaStream_t stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || D < 8 || D > 128 || D % 8 != 0 || splits < 1 ||
      splits > MAX_SPLITS || S < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = Hq / Hkv;
  const size_t smem = split_smem_bytes<T>(G, D);
  // dynamic shared memory the kernel may take, on each device
  static size_t allowed[MAX_DEVICES] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  if (smem > 48 * 1024 && smem > allowed[device]) {
    err = cudaFuncSetAttribute(decode_split<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed[device] = smem;
  }
  const int chunk = (S + splits - 1) / splits;
  float* part_acc = static_cast<float*>(scratch);
  float* part_ml = part_acc + static_cast<size_t>(B) * Hq * splits * D;
  decode_split<T><<<dim3(splits, Hkv, B), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(valid), part_acc, part_ml, S, Hq, Hkv, D, chunk, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(Hq, B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const float* pa = part_acc;
  const float* pm = part_ml;
  err = out_f32 != nullptr
            ? cudaLaunchKernelEx(&cfg, decode_combine<T, true>, pa, pm, static_cast<T*>(out),
                                 out_f32, m, l, Hq, D, splits)
            : cudaLaunchKernelEx(&cfg, decode_combine<T, false>, pa, pm, static_cast<T*>(out),
                                 out_f32, m, l, Hq, D, splits);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns the CUDA error of the launches (0 on success).  dtype: 0 fp32,
// 1 bf16.  scratch: B * Hq * splits * (D + 2) floats.  out_f32, m, l: null
// (serving: the output in the cache's dtype into out), or fp32 (B, Hq, D),
// (B, Hq) and (B, Hq) buffers for the normalised output and each row's max
// score and sum of exponentials (out is then not written); all three or none.
int decode_attention_fwd(const void* q, const void* k, const void* v,
                         const void* valid, void* out, void* scratch, void* out_f32,
                         void* m, void* l, int B, int S, int Hq, int Hkv, int D, int splits,
                         float scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool stats = out_f32 != nullptr;
  if (stats != (m != nullptr) || stats != (l != nullptr) || (!stats && out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  float* of = static_cast<float*>(out_f32);
  float* mf = static_cast<float*>(m);
  float* lf = static_cast<float*>(l);
  if (dtype == 0)
    return launch<float>(q, k, v, valid, out, scratch, of, mf, lf, B, S, Hq, Hkv, D, splits,
                         scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, valid, out, scratch, of, mf, lf, B, S, Hq, Hkv, D,
                                 splits, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
