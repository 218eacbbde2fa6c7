// Flash-attention forward for Hopper (sm_90a), written by hand.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention_pallas
// (body _attn_kernel): forward GQA attention with online softmax and fp32
// m / l / acc, causal and sliding-window masks over absolute int32 q_pos /
// kv_pos (so suffix-aligned prefill, Sq < Skv, works), kv head = h / G.
// Any Sq / Skv; any head dim D that is a multiple of 8 up to 128.  Masked
// scores take the reference's finite sentinel NEG_INF = -1e30 (not -inf): a
// row that has seen no valid key counts p = 1 for each masked key, exactly
// as the reference does, and never gives a NaN.  A key past Skv does not
// exist and contributes nothing.  The C entry picks one of two kernels by
// dtype; nothing tries one and falls back to the other.
//
// bf16: flash_fwd_wgmma, on the tensor cores.  A block owns a 64-row q tile
// of one q head.  At D <= 64 its two warpgroups (128 threads each) take
// alternate kv tiles of the kv head h / G, each with its own running
// (m, l, O), and the second hands its state to the first through shared
// memory at the end, so a q tile's critical path is half its kv tiles.  At
// D 128 a block has one warpgroup: 156 registers a thread leave room for two
// such blocks an SM, not for two of 256 threads.  TMA copies Q once and the
// 64-row K / V tiles, completing on mbarriers; one thread a warpgroup issues
// them, two tiles ahead of its work at D <= 64 and one at D 128.  The tensor
// maps are built on the host over the 4-D views (D, H, S, B) with 64-column
// (128-byte) boxes and the 128-byte swizzle; TMA's zero fill covers the
// ragged q tile, the ragged kv tile and the columns past D (D <= 64 loads one
// box, D <= 128 two).  S = Q K^T is wgmma m64n64k16 with both operands in
// shared memory (K-major); the scale is applied to the fp32 scores, not to
// bf16 Q.  The online softmax runs on the accumulator fragments in the log2
// domain (ex2.approx; a row's max by two quad shuffles, its sum per thread
// until the end); where all 16 keys a thread holds are valid for both its
// rows, only the scale is applied.  P, rounded to bf16, is re-packed from the
// accumulator layout into wgmma's A-fragment layout (the two agree thread for
// thread) and O += P V is wgmma m64n{64,128}k16 with P from registers and V
// from shared memory as a transposed (MN-major) B.  Before the loop the block
// finds the first and last kv tile that may hold a valid key for some row of
// its q tile (causal prefill skips the tiles above the diagonal, a window
// those below it); the tiles outside that range hold no valid key for any
// row, so they are exact zeros once a row has seen a valid key.  If some row
// has seen none by then, the block runs the remaining tiles too (the
// reference's mean over the masked keys).  Merging two states follows the
// same rule: a state that has seen no valid key has m = NEG_INF and weight
// exactly 0.
//
// fp32: flash_fwd_simt, the plain-FMA kernel of the first port.  Tensor cores
// would take fp32 as TF32, which misses the fp32 tolerance (3e-5).  One block
// per (64-row q tile, q head, batch), 256 threads, four per q row, each with
// a quarter of the (padded) head dim in float4 chunks; K/V tiles staged in
// shared memory as fp32; chunks past D are zero and never stored.
//
// What bounds it on the card: at granite's prefill (S 512, 32/8 heads, D 64)
// the bound is device memory (4.2 MB of q, k, v, out), 1.6 us; the products
// (0.7 GFLOP of unmasked pairs) take 0.7 us at the bf16 tensor-core peak.
// The bf16 kernel is bound by latency instead: all 256 blocks run in one
// wave, and the call lasts as long as the heaviest q tile's block, which
// walks 8 kv tiles (4 a warpgroup), each a chain of load, two products and
// the softmax between them.
#include <climits>
#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ bool key_valid(int kp, int qp, int causal, int window) {
  return (!causal || kp <= qp) && (window < 0 || kp > qp - window);
}

// --------------------------------------------------------------------------
// fp32: the SIMT kernel
// --------------------------------------------------------------------------

constexpr int BQ = 64;              // q rows per block
constexpr int TPR = 4;              // threads per q row
constexpr int THREADS = BQ * TPR;   // 256

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D); out: (B, Sq, Hq, D); all
// contiguous fp32.  DP is D rounded up to a multiple of 16 (the shared tiles'
// row width); chunks of four columns at or past D are zero.
template <int DP>
__global__ void __launch_bounds__(THREADS, 2)
flash_fwd_simt(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const int* __restrict__ q_pos,
               const int* __restrict__ kv_pos, float* __restrict__ out,
               int Sq, int Skv, int Hq, int Hkv, int D, int causal, int window,
               float scale) {
  constexpr int NC = DP / 16;                // float4 chunks per thread
  constexpr int BK = (DP <= 64) ? 64 : 32;   // kv rows per shared tile
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
  const int qi = blockIdx.x * BQ + row;
  const bool live = qi < Sq;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

  float4 qr[NC];
  float4 acc[NC];
  const float* qrow = q + ((static_cast<size_t>(b) * Sq + (live ? qi : 0)) * Hq + h) * D;
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = 4 * (part + TPR * i);
    const float4 x = (live && c < D) ? load4(qrow + c) : zero4;
    qr[i] = make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
    acc[i] = zero4;
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
  const float* kbase = k + (static_cast<size_t>(b) * Skv * Hkv + hk) * D;
  const float* vbase = v + (static_cast<size_t>(b) * Skv * Hkv + hk) * D;

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

    for (int e = tid; e < BK * (DP / 4); e += THREADS) {
      const int r = e / (DP / 4);
      const int c = 4 * (e % (DP / 4));
      float4 kk = zero4;
      float4 vv = zero4;
      if (r < n && c < D) {
        const size_t off = static_cast<size_t>(t0 + r) * row_stride + c;
        kk = load4(kbase + off);
        vv = load4(vbase + off);
      }
      *reinterpret_cast<float4*>(&ks[r * DP + c]) = kk;
      *reinterpret_cast<float4*>(&vs[r * DP + c]) = vv;
    }
    __syncthreads();

    float s[BK];
    float tmax = NEG_INF;
    bool any_valid = false;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float d = 0.f;
#pragma unroll
      for (int i = 0; i < NC; ++i) d = dot4(qr[i], load4(&ks[j * DP + 4 * (part + TPR * i)]), d);
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
          const float4 vv = load4(&vs[j * DP + 4 * (part + TPR * i)]);
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
    float* orow = out + ((static_cast<size_t>(b) * Sq + qi) * Hq + h) * D;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = 4 * (part + TPR * i);
      if (c < D)
        *reinterpret_cast<float4*>(orow + c) =
            make_float4(acc[i].x / denom, acc[i].y / denom, acc[i].z / denom, acc[i].w / denom);
    }
  }
}

template <int DP>
int launch_simt(const void* q, const void* k, const void* v, const void* q_pos,
                const void* kv_pos, void* out, int B, int Sq, int Skv, int Hq,
                int Hkv, int D, int causal, int window, float scale,
                cudaStream_t stream) {
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  flash_fwd_simt<DP><<<grid, THREADS, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(q_pos),
      static_cast<const int*>(kv_pos), static_cast<float*>(out), Sq, Skv, Hq,
      Hkv, D, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_simt(const void* q, const void* k, const void* v, const void* q_pos,
                  const void* kv_pos, void* out, int B, int Sq, int Skv, int Hq,
                  int Hkv, int D, int causal, int window, float scale,
                  cudaStream_t stream) {
#define REPRO_SIMT_CASE(DD)                                                      \
  case DD:                                                                       \
    return launch_simt<DD>(q, k, v, q_pos, kv_pos, out, B, Sq, Skv, Hq, Hkv, D,  \
                           causal, window, scale, stream);
  switch ((D + 15) / 16 * 16) {
    REPRO_SIMT_CASE(16)
    REPRO_SIMT_CASE(32)
    REPRO_SIMT_CASE(48)
    REPRO_SIMT_CASE(64)
    REPRO_SIMT_CASE(80)
    REPRO_SIMT_CASE(96)
    REPRO_SIMT_CASE(112)
    REPRO_SIMT_CASE(128)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_SIMT_CASE
}

// --------------------------------------------------------------------------
// bf16: the tensor-core kernel (TMA + wgmma)
// --------------------------------------------------------------------------

constexpr int MAX_DEVICES = 64;
constexpr int BM = 64;     // q rows per block (one wgmma M)
constexpr int BN = 64;     // kv rows per tile (the score wgmma's N)
constexpr int WG = 128;    // one warpgroup

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// One 4-D box (64 columns x 1 head x 64 rows x 1 batch) into shared memory,
// completing on the mbarrier.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptors for tiles of 128-byte rows under the
// 128-byte swizzle (layout type 1), 8-row groups 1024 bytes apart (SBO).
// K-major (Q, K): LBO unused.  MN-major (V as a transposed B): LBO is the
// distance between 64-column panels.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr, uint32_t lbo_bytes) {
  return static_cast<uint64_t>((saddr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// 2^x on the special-function unit (flush to zero; -inf and NEG_INF give 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// D[64 x 64] (+)= A[64 x 16] * B[16 x 64], A and B from shared memory
// (descriptors), fp32 accumulators; B K-major (trans-b 0).
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 64] += A[64 x 16] * B[16 x 64], A from registers (bf16 pairs in
// wgmma's A-fragment order), B from shared memory MN-major (trans-b 1).
__device__ __forceinline__ void wgmma_rs_n64_tb(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D[64 x 128] += A[64 x 16] * B[16 x 128], A from registers (bf16 pairs in
// wgmma's A-fragment order), B from shared memory MN-major (trans-b 1).
__device__ __forceinline__ void wgmma_rs_n128_tb(float (&d)[64], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}


template <int DP>
__device__ __forceinline__ void wgmma_pv(float (&o)[DP / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (DP == 64) {
    wgmma_rs_n64_tb(o, a, db, 1);
  } else {
    wgmma_rs_n128_tb(o, a, db, 1);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int DP>
struct Layout {
  static constexpr int PANEL_Q = BM * 128;           // one 64-column panel of Q
  static constexpr int PANEL_KV = BN * 128;          // one 64-column panel of K or V
  static constexpr int Q_BYTES = (DP / 64) * PANEL_Q;
  static constexpr int KV_BYTES = (DP / 64) * PANEL_KV;
  // Warpgroups a block, splitting the kv tiles: two at D <= 64 (125
  // registers: two blocks of 256 threads an SM, so granite's 256 blocks run
  // in one wave); one at D <= 128, where 156 registers would leave one such
  // block an SM and two waves.  K/V stages a warpgroup: its next tiles load
  // while it works, two ahead at D <= 64 (104 KB a block), one at D <= 128
  // (80 KB), so that two blocks fit on an SM either way.
  static constexpr int NWG = DP == 64 ? 2 : 1;
  static constexpr int STAGES = DP == 64 ? 3 : 2;
  static constexpr int LEAD = STAGES - 1;            // iterations issued ahead
  static constexpr int RING = NWG * STAGES;
  static constexpr int BAR = Q_BYTES + RING * 2 * KV_BYTES;
  static constexpr int SMEM = BAR + 8 * (1 + RING) + 1024;   // barriers, alignment slack
  // the second warpgroup's (m, l, O) for the merge, over the drained ring
  static_assert(NWG == 1 || WG * (DP / 2 + 4) * 4 <= RING * 2 * KV_BYTES, "merge buffer");
};

__device__ __forceinline__ void wg_sync(int wg) {   // one warpgroup's named barrier
  asm volatile("bar.sync %0, %1;\n" :: "r"(1 + wg), "r"(WG) : "memory");
}

// q: (B, Sq, Hq, D), k / v: (B, Skv, Hkv, D) through the tensor maps;
// out: (B, Sq, Hq, D) bf16.  DP = 64 or 128: D padded to the boxes.  Two
// warpgroups share the q tile and take alternate kv tiles, each with its own
// two ring stages and its own running (m, l, O); the second hands its state
// to the first through shared memory at the end.
template <int DP>
__global__ void __launch_bounds__(Layout<DP>::NWG * WG)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, const int* __restrict__ q_pos,
                const int* __restrict__ kv_pos, __nv_bfloat16* __restrict__ out,
                int Sq, int Skv, int Hq, int Hkv, int D, int causal, int window,
                float scale_log2) {
  using L = Layout<DP>;
  constexpr int NO = DP / 2;             // O accumulators per thread
  constexpr int NWG = L::NWG;
  extern __shared__ uint8_t smem_raw[];
  __shared__ int s_lo, s_hi, s_first, s_last;
  __shared__ int row_seen[BM];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t bar_q = base + L::BAR;
  const uint32_t bar_kv = bar_q + 8;     // + 8 * stage
  const CUtensorMap* map_q = &tq;
  const CUtensorMap* map_k = &tk;
  const CUtensorMap* map_v = &tv;

  const int tid = threadIdx.x;
  const int wg = tid / WG;               // this thread's warpgroup
  const int t = tid % WG;                // and its thread in it
  const int warp = t / 32;
  const int lane = t % 32;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = blockIdx.x * BM;
  const int r0 = 16 * warp + lane / 4;   // this thread's rows: r0 and r0 + 8
  const int c0 = 2 * (lane % 4);         // and columns c0, c0 + 1 of each 8
  const bool live0 = q0 + r0 < Sq;
  const bool live1 = q0 + r0 + 8 < Sq;
  const int qp0 = live0 ? q_pos[q0 + r0] : 0;
  const int qp1 = live1 ? q_pos[q0 + r0 + 8] : 0;
  const int nt = (Skv + BN - 1) / BN;

  if (tid == 0) {
    prefetch_map(map_q);
    prefetch_map(map_k);
    prefetch_map(map_v);
    mbar_init(bar_q, 1);
    for (int s = 0; s < L::RING; ++s) mbar_init(bar_kv + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    s_lo = INT_MAX;
    s_hi = INT_MIN;
    s_first = INT_MAX;
    s_last = -1;
  }
  if (tid < BM) row_seen[tid] = 0;
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, L::Q_BYTES);
    for (int p = 0; p < DP / 64; ++p) tma_load(q_s + p * L::PANEL_Q, map_q, bar_q, 64 * p, h, q0, b);
  }
  // the q tile's position range, then the kv tiles that may hold a valid key;
  // the first kv positions are loaded before the range is known
  constexpr int PRE = 4;                 // kv positions a thread loads ahead
  int kp_pre[PRE];
#pragma unroll
  for (int u = 0; u < PRE; ++u) {
    const int j = tid + u * NWG * WG;
    kp_pre[u] = j < Skv ? __ldg(kv_pos + j) : 0;
  }
  if (wg == 0) {
    const int lo = __reduce_min_sync(0xffffffffu, min(live0 ? qp0 : INT_MAX, live1 ? qp1 : INT_MAX));
    const int hi = __reduce_max_sync(0xffffffffu, max(live0 ? qp0 : INT_MIN, live1 ? qp1 : INT_MIN));
    if (lane == 0) {
      atomicMin(&s_lo, lo);
      atomicMax(&s_hi, hi);
    }
  }
  __syncthreads();
  {
    const int lo = s_lo, hi = s_hi;
    int first = INT_MAX, last = -1;
    auto scan = [&](int j, int kp) {
      if (j < Skv && (!causal || kp <= hi) && (window < 0 || kp > lo - window)) {
        first = min(first, j);
        last = j;
      }
    };
#pragma unroll
    for (int u = 0; u < PRE; ++u) scan(tid + u * NWG * WG, kp_pre[u]);
#pragma unroll 4
    for (int j = tid + PRE * NWG * WG; j < Skv; j += NWG * WG) scan(j, __ldg(kv_pos + j));
    first = __reduce_min_sync(0xffffffffu, first);
    last = __reduce_max_sync(0xffffffffu, last);
    if (lane == 0 && last >= 0) {
      atomicMin(&s_first, first);
      atomicMax(&s_last, last);
    }
  }
  __syncthreads();
  const int j_first = s_last < 0 ? 0 : s_first / BN;
  const int n_main = s_last < 0 ? 0 : s_last / BN - j_first + 1;

  // iteration i -> kv tile: the maybe-range first, then (only if a row has
  // seen no valid key) every other tile in order.  Warpgroup w takes the
  // iterations i = w, w + NWG, ...; its k-th one uses its ring stage
  // w + NWG * (k % STAGES), whose barrier completes for the (k / STAGES)-th time.
  auto tile_of = [&](int i) {
    const int m = i - n_main;
    return i < n_main ? j_first + i : (m < j_first ? m : m + n_main);
  };
  auto stage_of = [&](int i) { return wg + NWG * ((i / NWG) % L::STAGES); };
  auto issue = [&](int i) {
    const int st = stage_of(i);
    const uint32_t k_s = base + L::Q_BYTES + st * 2 * L::KV_BYTES;
    const uint32_t v_s = k_s + L::KV_BYTES;
    const uint32_t bar = bar_kv + 8 * st;
    const int k0 = tile_of(i) * BN;
    mbar_expect_tx(bar, 2 * L::KV_BYTES);
    for (int p = 0; p < DP / 64; ++p) {
      tma_load(k_s + p * L::PANEL_KV, map_k, bar, 64 * p, hk, k0, b);
      tma_load(v_s + p * L::PANEL_KV, map_v, bar, 64 * p, hk, k0, b);
    }
  };

  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF;      // running max, log2 domain, quad-uniform
  float l0 = 0.f, l1 = 0.f;              // this thread's part of the row sums

  int count = n_main;
  bool widened = false;
  if (t == 0)
    for (int k = 0; k < L::LEAD; ++k)
      if (wg + NWG * k < count) issue(wg + NWG * k);
  mbar_wait(bar_q, 0);

  for (int i = wg;; i += NWG) {
    if (i >= count) {
      if (widened) break;
      widened = true;
      // a row has seen a valid key if either warpgroup has seen one
      if (lane % 4 == 0) {
        if (m0 > 0.5f * NEG_INF) row_seen[r0] = 1;
        if (m1 > 0.5f * NEG_INF) row_seen[r0 + 8] = 1;
      }
      __syncthreads();
      const bool unseen = (live0 && !row_seen[r0]) || (live1 && !row_seen[r0 + 8]);
      if (!__syncthreads_or(unseen)) break;
      count = nt;
      if (i >= count) break;
      if (t == 0)
        for (int k = 0; k < L::LEAD; ++k)
          if (i + NWG * k < count) issue(i + NWG * k);
    }
    wg_sync(wg);   // the warpgroup is done with the stage that the next issue refills
    if (t == 0 && i + NWG * L::LEAD < count) issue(i + NWG * L::LEAD);

    const int st = stage_of(i);
    const uint32_t k_s = base + L::Q_BYTES + st * 2 * L::KV_BYTES;
    const uint32_t v_s = k_s + L::KV_BYTES;
    const int k0 = tile_of(i) * BN;
    int kp[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + 8 * j + c0 + e;
        kp[2 * j + e] = key < Skv ? __ldg(kv_pos + key) : 0;
      }
    }
    mbar_wait(bar_kv + 8 * st, (i / (NWG * L::STAGES)) & 1);

    // S = Q K^T over the padded head dim, fp32 accumulators
    float s[32];
#pragma unroll
    for (int r = 0; r < 32; ++r) s[r] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {   // columns past D are TMA's zeros
      const uint32_t off = (kk % 4) * 32;     // 16 columns a k-step
      wgmma_ss_n64(s, desc_sw128(q_s + (kk / 4) * L::PANEL_Q + off, 16),
                   desc_sw128(k_s + (kk / 4) * L::PANEL_KV + off, 16), kk > 0);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);

    // masks and the scale, in the log2 domain; a key past Skv is -inf (p = 0).
    // Where every key of this thread's 16 columns exists and is valid for both
    // of its rows (most tiles of a causal prefill), only the scale is applied.
    float mx0 = -INFINITY, mx1 = -INFINITY;
    int kmin = kp[0], kmax = kp[0];
#pragma unroll
    for (int j = 1; j < 16; ++j) {
      kmin = min(kmin, kp[j]);
      kmax = max(kmax, kp[j]);
    }
    const int qlo = min(qp0, qp1), qhi = max(qp0, qp1);
    const bool all_valid = k0 + BN <= Skv && (!causal || kmax <= qlo) &&
                           (window < 0 || kmin > qhi - window);
    if (all_valid) {
#pragma unroll
      for (int j = 0; j < 32; ++j) s[j] *= scale_log2;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool exists = k0 + 8 * j + c0 + e < Skv;
          const int kpv = kp[2 * j + e];
          float& x0 = s[4 * j + e];
          float& x1 = s[4 * j + 2 + e];
          x0 = !exists ? -INFINITY : (key_valid(kpv, qp0, causal, window) ? x0 * scale_log2 : NEG_INF);
          x1 = !exists ? -INFINITY : (key_valid(kpv, qp1, causal, window) ? x1 * scale_log2 : NEG_INF);
          mx0 = fmaxf(mx0, x0);
          mx1 = fmaxf(mx1, x1);
        }
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float n0 = fmaxf(m0, mx0);
    const float n1 = fmaxf(m1, mx1);
    const float corr0 = fast_exp2(m0 - n0);
    const float corr1 = fast_exp2(m1 - n1);
    m0 = n0;
    m1 = n1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[4 * j + e] = fast_exp2(s[4 * j + e] - n0);
        s[4 * j + 2 + e] = fast_exp2(s[4 * j + 2 + e] - n1);
        ps0 += s[4 * j + e];
        ps1 += s[4 * j + 2 + e];
      }
    }
    l0 = l0 * corr0 + ps0;
    l1 = l1 * corr1 + ps1;
#pragma unroll
    for (int j = 0; j < NO / 4; ++j) {
      o[4 * j] *= corr0;
      o[4 * j + 1] *= corr0;
      o[4 * j + 2] *= corr1;
      o[4 * j + 3] *= corr1;
    }
    // P (bf16) in wgmma's A-fragment order: k-step kk covers columns
    // 16 kk .. 16 kk + 15, i.e. accumulator chunks 2 kk and 2 kk + 1
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_pv<DP>(o, pa[kk], desc_sw128(v_s + kk * 16 * 128, L::PANEL_KV));
    wgmma_commit();
    wgmma_wait0();
    fence_regs(o);
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  // the second warpgroup's (m, l, O) to the first, thread t to thread t,
  // over the ring (every load has landed and been read: both loops are done)
  if constexpr (NWG == 2) {
    __syncthreads();
    float* merge = reinterpret_cast<float*>(smem_raw + (base - smem_u32(smem_raw)) + L::Q_BYTES);
    float* mine = merge + static_cast<size_t>(t) * (NO + 4);
    if (wg == 1) {
      mine[0] = m0;
      mine[1] = m1;
      mine[2] = l0;
      mine[3] = l1;
#pragma unroll
      for (int i = 0; i < NO; ++i) mine[4 + i] = o[i];
    }
    __syncthreads();
    if (wg == 1) return;
    const float om0 = mine[0], om1 = mine[1];
    const float a0 = fmaxf(m0, om0), a1 = fmaxf(m1, om1);
    const float w0 = fast_exp2(m0 - a0), v0 = fast_exp2(om0 - a0);
    const float w1 = fast_exp2(m1 - a1), v1 = fast_exp2(om1 - a1);
    l0 = l0 * w0 + mine[2] * v0;
    l1 = l1 * w1 + mine[3] * v1;
#pragma unroll
    for (int j = 0; j < NO / 4; ++j) {
      o[4 * j] = o[4 * j] * w0 + mine[4 + 4 * j] * v0;
      o[4 * j + 1] = o[4 * j + 1] * w0 + mine[5 + 4 * j] * v0;
      o[4 * j + 2] = o[4 * j + 2] * w1 + mine[6 + 4 * j] * v1;
      o[4 * j + 3] = o[4 * j + 3] * w1 + mine[7 + 4 * j] * v1;
    }
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
  const size_t row_stride = static_cast<size_t>(Hq) * D;
  __nv_bfloat16* o0 = out + (static_cast<size_t>(b) * Sq + q0 + r0) * row_stride + static_cast<size_t>(h) * D;
  __nv_bfloat16* o1 = o0 + 8 * row_stride;
#pragma unroll
  for (int j = 0; j < NO / 4; ++j) {
    const int col = 8 * j + c0;
    if (col < D) {
      if (live0)
        *reinterpret_cast<uint32_t*>(o0 + col) = pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0);
      if (live1)
        *reinterpret_cast<uint32_t*>(o1 + col) = pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    }
  }
}

// cuTensorMapEncodeTiled, looked up at run time (cudaGetDriverEntryPoint) so
// that the library needs no -lcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 (B, S, H, D) tensor as the 4-D view (D, H, S, B) with its real
// strides; boxes of 64 columns x 1 head x 64 rows x 1 batch, 128-byte
// swizzle, zero fill out of bounds.
bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int H, int D) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(H) * D * 2,
                                 static_cast<cuuint64_t>(S) * H * D * 2};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP>
int launch_wgmma(const void* q, const void* k, const void* v, const void* q_pos,
                 const void* kv_pos, void* out, int B, int Sq, int Skv, int Hq,
                 int Hkv, int D, int causal, int window, float scale,
                 cudaStream_t stream) {
  // the shared-memory limit is a property of the kernel on each device
  static bool configured[MAX_DEVICES] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  if (!configured[device]) {
    err = cudaFuncSetAttribute(flash_fwd_wgmma<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Layout<DP>::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured[device] = true;
  }
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, B, Sq, Hq, D) || !make_map(&tk, k, B, Skv, Hkv, D) ||
      !make_map(&tv, v, B, Skv, Hkv, D))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((Sq + BM - 1) / BM, Hq, B);
  flash_fwd_wgmma<DP><<<grid, Layout<DP>::NWG * WG, Layout<DP>::SMEM, stream>>>(
      tq, tk, tv, static_cast<const int*>(q_pos), static_cast<const int*>(kv_pos),
      static_cast<__nv_bfloat16*>(out), Sq, Skv, Hq, Hkv, D, causal, window,
      scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns the CUDA error of the launch (0 on success).  dtype: 0 fp32 (the
// SIMT kernel), 1 bf16 (the tensor-core kernel).  window < 0 means no
// sliding window.  D: a multiple of 8 from 8 to 128.
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        const void* q_pos, const void* kv_pos, void* out,
                        int B, int Sq, int Skv, int Hq, int Hkv, int D,
                        int causal, int window, float scale, int dtype,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D < 8 || D > 128 || D % 8 != 0 || Hkv <= 0 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return dispatch_simt(q, k, v, q_pos, kv_pos, out, B, Sq, Skv, Hq, Hkv, D,
                         causal, window, scale, st);
  if (dtype == 1) {
    if (D <= 64)
      return launch_wgmma<64>(q, k, v, q_pos, kv_pos, out, B, Sq, Skv, Hq, Hkv, D,
                              causal, window, scale, st);
    return launch_wgmma<128>(q, k, v, q_pos, kv_pos, out, B, Sq, Skv, Hq, Hkv, D,
                             causal, window, scale, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
