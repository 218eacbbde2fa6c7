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
// Asked for them (training: the backward in flash_attention_bwd.cu reads
// them), both kernels also write each row's max score m and 1 / l, fp32
// (B, Hq, Sq), in natural units (the bf16 kernel's log2-domain m times ln 2;
// a row with no valid key keeps m = NEG_INF exactly).  A template flag: the
// instantiations that serving launches, with no statistics, keep their code.
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

#include "flash_common.cuh"

namespace {

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
// row width); chunks of four columns at or past D are zero.  STATS: also
// write each row's max score m and 1 / l to m_out / linv_out (B, Hq, Sq).
template <int DP, bool STATS>
__global__ void __launch_bounds__(THREADS, 2)
flash_fwd_simt(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const int* __restrict__ q_pos,
               const int* __restrict__ kv_pos, float* __restrict__ out,
               float* __restrict__ m_out, float* __restrict__ linv_out,
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
    if (STATS && part == 0) {
      const size_t idx = (static_cast<size_t>(b) * Hq + h) * Sq + qi;
      m_out[idx] = m;
      linv_out[idx] = 1.f / denom;
    }
  }
}

template <int DP>
int launch_simt(const void* q, const void* k, const void* v, const void* q_pos,
                const void* kv_pos, void* out, void* m, void* linv, int B, int Sq,
                int Skv, int Hq, int Hkv, int D, int causal, int window, float scale,
                cudaStream_t stream) {
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  auto kernel = m != nullptr ? &flash_fwd_simt<DP, true> : &flash_fwd_simt<DP, false>;
  kernel<<<grid, THREADS, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(q_pos),
      static_cast<const int*>(kv_pos), static_cast<float*>(out), static_cast<float*>(m),
      static_cast<float*>(linv), Sq, Skv, Hq, Hkv, D, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_simt(const void* q, const void* k, const void* v, const void* q_pos,
                  const void* kv_pos, void* out, void* m, void* linv, int B, int Sq,
                  int Skv, int Hq, int Hkv, int D, int causal, int window, float scale,
                  cudaStream_t stream) {
#define REPRO_SIMT_CASE(DD)                                                            \
  case DD:                                                                             \
    return launch_simt<DD>(q, k, v, q_pos, kv_pos, out, m, linv, B, Sq, Skv, Hq, Hkv,  \
                           D, causal, window, scale, stream);
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

constexpr int BM = 64;     // q rows per block (one wgmma M)
constexpr int BN = 64;     // kv rows per tile (the score wgmma's N)
constexpr int WG = 128;    // one warpgroup

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
// to the first through shared memory at the end.  STATS: also write each
// row's max score m (natural units, as the fp32 kernel's; NEG_INF kept
// exactly) and 1 / l to m_out / linv_out (B, Hq, Sq).
template <int DP, bool STATS>
__global__ void __launch_bounds__(Layout<DP>::NWG * WG)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, const int* __restrict__ q_pos,
                const int* __restrict__ kv_pos, __nv_bfloat16* __restrict__ out,
                float* __restrict__ m_out, float* __restrict__ linv_out,
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
    if constexpr (STATS) {
      m0 = a0;
      m1 = a1;
    }
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
  if constexpr (STATS) {
    // m from the log2 domain back to natural units; a row that saw no valid
    // key keeps the sentinel exactly
    if (lane % 4 == 0) {
      const size_t srow = (static_cast<size_t>(b) * Hq + h) * Sq + q0 + r0;
      if (live0) {
        m_out[srow] = m0 <= 0.5f * NEG_INF ? NEG_INF : m0 * LN2;
        linv_out[srow] = inv0;
      }
      if (live1) {
        m_out[srow + 8] = m1 <= 0.5f * NEG_INF ? NEG_INF : m1 * LN2;
        linv_out[srow + 8] = inv1;
      }
    }
  }
}


template <int DP, bool STATS>
int launch_wgmma(const void* q, const void* k, const void* v, const void* q_pos,
                 const void* kv_pos, void* out, void* m, void* linv, int B, int Sq,
                 int Skv, int Hq, int Hkv, int D, int causal, int window, float scale,
                 cudaStream_t stream) {
  // the shared-memory limit is a property of the kernel on each device
  static bool configured[MAX_DEVICES] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  if (!configured[device]) {
    err = cudaFuncSetAttribute(flash_fwd_wgmma<DP, STATS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Layout<DP>::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured[device] = true;
  }
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, B, Sq, Hq, D) || !make_map(&tk, k, B, Skv, Hkv, D) ||
      !make_map(&tv, v, B, Skv, Hkv, D))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((Sq + BM - 1) / BM, Hq, B);
  flash_fwd_wgmma<DP, STATS><<<grid, Layout<DP>::NWG * WG, Layout<DP>::SMEM, stream>>>(
      tq, tk, tv, static_cast<const int*>(q_pos), static_cast<const int*>(kv_pos),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(m), static_cast<float*>(linv),
      Sq, Skv, Hq, Hkv, D, causal, window, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns the CUDA error of the launch (0 on success).  dtype: 0 fp32 (the
// SIMT kernel), 1 bf16 (the tensor-core kernel).  window < 0 means no
// sliding window.  D: a multiple of 8 from 8 to 128.  m, linv: null (serving),
// or fp32 (B, Hq, Sq) buffers for each row's max score and 1 / l (training:
// the backward reads them); both or neither.
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        const void* q_pos, const void* kv_pos, void* out, void* m,
                        void* linv, int B, int Sq, int Skv, int Hq, int Hkv, int D,
                        int causal, int window, float scale, int dtype,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D < 8 || D > 128 || D % 8 != 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      (m == nullptr) != (linv == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return dispatch_simt(q, k, v, q_pos, kv_pos, out, m, linv, B, Sq, Skv, Hq, Hkv, D,
                         causal, window, scale, st);
  if (dtype == 1) {
#define REPRO_WGMMA(DD, ST)                                                                \
  launch_wgmma<DD, ST>(q, k, v, q_pos, kv_pos, out, m, linv, B, Sq, Skv, Hq, Hkv, D, causal, \
                       window, scale, st)
    if (D <= 64) return m == nullptr ? REPRO_WGMMA(64, false) : REPRO_WGMMA(64, true);
    return m == nullptr ? REPRO_WGMMA(128, false) : REPRO_WGMMA(128, true);
#undef REPRO_WGMMA
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
