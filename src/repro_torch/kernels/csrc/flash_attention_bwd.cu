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
// The forward, asked for them, writes each q row's max score m and 1 / l (l
// the sum of exp(s - m) over the keys), in natural units, and the backward
// reads them: P = exp(s - m) / l.  The pair rather than lse = m + log l: for
// a row with no valid key m = NEG_INF and log l vanishes beside it in fp32,
// so lse could not give back the 1 / Skv weight.  Masking follows the
// forward exactly.  A masked score is the finite sentinel NEG_INF = -1e30, so
// a row that has seen no valid key weights every existing key by 1 / Skv: it
// adds dO / Skv to dv of every key and nothing to dq or dk (the gradient at a
// masked score is zero).  A key past Skv does not exist and contributes
// nothing.  dS = P (dO v^T - Dr) on valid scores, 0 on masked ones, with
// Dr = rowsum(dO * O) and O the forward's output as stored.
//
// Two kernels a call, dq first, then dk / dv:
//   dq     one block per (64-row q tile, q head, batch): Dr of its rows
//          (written for the second kernel), then over the kv tiles that may
//          hold a valid key for some row of the tile, dq = scale * sum_j
//          dS_ij k_j.  A tile holding no valid score adds nothing to dq.
//   dk/dv  one block per (64-row kv tile, kv head, batch), over the G q
//          heads of the group and the q tiles that may meet the kv tile:
//          dv = sum_i P_ij dO_i, dk = scale * sum_i dS_ij q_i.  If some q row
//          of the group saw no valid key, the block visits every q tile (P
//          is 1 / Skv on such a row's masked scores); otherwise a tile
//          outside the range holds only masked scores of rows that have seen
//          a valid key, where P is exactly 0.
// Each output row is written once: no atomics, so two calls on the same
// inputs agree bit for bit (recomputation under activation checkpointing
// relies on it).  dq recomputes S and dP, seven products a pair in all
// instead of five, the price of that.  Under a causal mask q tile i walks
// i + 1 kv tiles and kv tile j meets n - j q tiles: both grids are 1-D and
// launch the heaviest tiles first, and the blocks that finish early take
// the light ones.  (Pairing tile x with tile n - 1 - x in one block, so that
// every block has the same work, was slower on the card at granite-3-2b's
// training shape, at D 128 and at S 1024: two blocks an SM overlap better
// than one block of twice the work.)
//
// bf16: bwd_dq_wgmma and bwd_dkdv_wgmma, one warpgroup a block, on the
// tensor cores.  TMA copies 64-row tiles with the forward's tensor maps (128
// byte swizzle, zero fill past S and D; D <= 64 one box, D <= 128 two); the
// tiles that a block walks are double-buffered on mbarriers, one ahead of
// its work.  dk/dv: K and V stay in shared memory; for each visited q tile
// S^T = K Q^T and dP^T = V dO^T (wgmma, both operands in shared memory, two
// commit groups), then P^T on the accumulator fragments while dP^T is
// computed (each thread holds two keys and the q rows' {m, 1 / l, Dr,
// position} from shared memory, staged a visit ahead), re-packed as bf16 A
// fragments (the forward's re-pack of P); dV += P^T dO runs while dS^T is
// formed, then dK += dS^T Q (wgmma, A from registers, dO / Q as an MN-major
// B).  At D 128 a q tile is taken in two 32-row halves, so that S^T and
// dP^T take 16 registers each beside the 128 of dK and dV.  dq: Q and dO
// stay; per kv tile S = Q K^T and dP = dO V^T, P while dP is computed, dS,
// dQ += dS K.  Where a whole tile pair (dk / dv) or a thread's 16 keys and
// two rows (dq) hold only valid scores, the masks are skipped.  Scores are
// scaled in fp32 and taken in the log2 domain (ex2.approx).
//
// fp32: bwd_dq_simt and bwd_dkdv_simt, on the FMA units (tensor cores would
// take fp32 as TF32 and miss 1e-4): 256 threads a block, four threads a row,
// each with a quarter of the (padded) head dim in float4 chunks, tiles staged
// in shared memory as fp32.  Both compute s = (scale q) . k with the
// forward's chunk order and shuffle tree, so s, and the forward's m, are the
// same numbers in all three.
//
// What bounds it on the card: at granite-3-2b's training shape (B 8, S 256,
// 32/8 heads, D 64, causal, bf16) the bound is device memory (42 MB of q, k,
// v, o, dO, the statistics, dq, dk, dv: 0.0127 ms); the five products a pair
// that the gradient needs (5.4 GFLOP over 8.4 M unmasked pairs) take 5.4 us
// at the bf16 tensor-core peak.  The two kernels take 0.0700 ms there
// (chip_smoke.py on an H100 80GB HBM3 at 700 W; SDPA's backward 0.0813),
// 5.5x the bound, bound by latency: a block is one warpgroup, and each visit
// is a chain of a barrier, a tile's wait, the products and the exponentials
// that only partly overlap (two blocks an SM for dk / dv, four for dq at
// D <= 64).  A producer warp with consumer warpgroups and a persistent grid
// would overlap more.
#include <climits>
#include <cstdint>

#include "flash_common.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;

// whether a key at a position in [k_lo, k_hi] may be valid for a query at a
// position in [q_lo, q_hi]
__device__ __forceinline__ bool may_meet(int k_lo, int k_hi, int q_lo, int q_hi,
                                         int causal, int window) {
  return (!causal || k_lo <= q_hi) && (window < 0 || k_hi > q_lo - window);
}

// --------------------------------------------------------------------------
// fp32: the SIMT kernels
// --------------------------------------------------------------------------

constexpr int ROWS = 64;              // rows a block owns
constexpr int TPR = 4;                // threads per row
constexpr int THREADS = ROWS * TPR;   // 256

__device__ __forceinline__ float4 load4(const float* p) {
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
template <int DP, int BR>
__device__ __forceinline__ void stage(float* tile, const float* base, size_t row_stride, int t0,
                                      int n, int D, float mul) {
  for (int e = threadIdx.x; e < BR * (DP / 4); e += THREADS) {
    const int r = e / (DP / 4);
    const int c = 4 * (e % (DP / 4));
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n && c < D) x = scaled(load4(base + static_cast<size_t>(t0 + r) * row_stride + c), mul);
    *reinterpret_cast<float4*>(&tile[r * DP + c]) = x;
  }
}

// dq = scale * sum_j dS_ij k_j; Dr of each row is written for bwd_dkdv_simt
template <int DP>
__global__ void __launch_bounds__(THREADS)
bwd_dq_simt(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
            const float* __restrict__ out, const float* __restrict__ dout,
            const int* __restrict__ q_pos, const int* __restrict__ kv_pos,
            const float* __restrict__ m_in, const float* __restrict__ linv_in,
            float* __restrict__ dr_out, float* __restrict__ dq, int Sq, int Skv, int Hq,
            int Hkv, int D, int causal, int window, float scale) {
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
  float dr = 0.f;
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = col(part, i);
    const bool in = live && c < D;
    qr[i] = in ? scaled(load4(q + qoff + c), scale) : zero4;
    dor[i] = in ? load4(dout + qoff + c) : zero4;
    if (in) dr = dot4(dor[i], load4(out + qoff + c), dr);
    acc[i] = zero4;
  }
  dr = row_sum(dr);
  const size_t sidx = (static_cast<size_t>(b) * Hq + h) * Sq + (live ? qi : 0);
  const float m = live ? m_in[sidx] : 0.f;
  const float linv = live ? linv_in[sidx] : 0.f;
  if (live && part == 0) dr_out[sidx] = dr;
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
    stage<DP, BK>(ks, k + head, row_stride, t0, n, D, 1.f);
    stage<DP, BK>(vs, v + head, row_stride, t0, n, D, 1.f);
    __syncthreads();
    for (int j = 0; j < BK; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        s = dot4(qr[i], load4(&ks[j * DP + col(part, i)]), s);
        dp = dot4(dor[i], load4(&vs[j * DP + col(part, i)]), dp);
      }
      s = row_sum(s);
      dp = row_sum(dp);
      if (live && j < n && key_valid(kps[j], qp, causal, window)) {
        const float ds = expf(s - m) * linv * (dp - dr);
#pragma unroll
        for (int i = 0; i < NC; ++i) axpy4(ds, load4(&ks[j * DP + col(part, i)]), acc[i]);
      }
    }
    __syncthreads();
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = col(part, i);
      if (c < D) *reinterpret_cast<float4*>(dq + qoff + c) = scaled(acc[i], scale);
    }
  }
}

// dv = sum_i P_ij dO_i and dk = sum_i dS_ij (scale q_i), over the G q heads
// of the kv head and every q tile
template <int DP>
__global__ void __launch_bounds__(THREADS)
bwd_dkdv_simt(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const int* __restrict__ q_pos, const int* __restrict__ kv_pos,
              const float* __restrict__ m_in, const float* __restrict__ linv_in,
              const float* __restrict__ dr_in, float* __restrict__ dk, float* __restrict__ dv,
              int Sq, int Skv, int Hq, int Hkv, int D, int causal, int window, float scale) {
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
    kr[i] = in ? load4(k + koff + c) : zero4;
    vr[i] = in ? load4(v + koff + c) : zero4;
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
      stage<DP, TQ>(qs, q + head, row_stride, t0, nq, D, scale);
      stage<DP, TQ>(dos, dout + head, row_stride, t0, nq, D, 1.f);
      __syncthreads();
      for (int i = 0; i < TQ; ++i) {
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          s = dot4(load4(&qs[i * DP + col(part, c)]), kr[c], s);
          dp = dot4(load4(&dos[i * DP + col(part, c)]), vr[c], dp);
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
            axpy4(p, load4(&dos[i * DP + col(part, c)]), dva[c]);
            axpy4(ds, load4(&qs[i * DP + col(part, c)]), dka[c]);
          }
        } else {
          // a masked score: P is 0 unless the row has seen no valid key
          const float p = expf(NEG_INF - ms[i]) * w;
          if (p != 0.f) {
#pragma unroll
            for (int c = 0; c < NC; ++c) axpy4(p, load4(&dos[i * DP + col(part, c)]), dva[c]);
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
        *reinterpret_cast<float4*>(dk + koff + c) = dka[i];
        *reinterpret_cast<float4*>(dv + koff + c) = dva[i];
      }
    }
  }
}

template <int DP>
int launch_simt(const void* q, const void* k, const void* v, const void* out, const void* dout,
                const void* q_pos, const void* kv_pos, const void* m, const void* linv,
                void* dq, void* dk, void* dv, void* dr, int B, int Sq, int Skv, int Hq, int Hkv,
                int D, int causal, int window, float scale, cudaStream_t stream) {
  const float* fq = static_cast<const float*>(q);
  const float* fk = static_cast<const float*>(k);
  const float* fv = static_cast<const float*>(v);
  const float* fdo = static_cast<const float*>(dout);
  const int* qp = static_cast<const int*>(q_pos);
  const int* kp = static_cast<const int*>(kv_pos);
  const float* fm = static_cast<const float*>(m);
  const float* fl = static_cast<const float*>(linv);
  float* fd = static_cast<float*>(dr);
  const dim3 qgrid((Sq + ROWS - 1) / ROWS, Hq, B);
  bwd_dq_simt<DP><<<qgrid, THREADS, 0, stream>>>(fq, fk, fv, static_cast<const float*>(out), fdo,
                                                 qp, kp, fm, fl, fd, static_cast<float*>(dq),
                                                 Sq, Skv, Hq, Hkv, D, causal, window, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 kgrid((Skv + ROWS - 1) / ROWS, Hkv, B);
  bwd_dkdv_simt<DP><<<kgrid, THREADS, 0, stream>>>(fq, fk, fv, fdo, qp, kp, fm, fl, fd,
                                                   static_cast<float*>(dk), static_cast<float*>(dv),
                                                   Sq, Skv, Hq, Hkv, D, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_simt(const void* q, const void* k, const void* v, const void* out, const void* dout,
                  const void* q_pos, const void* kv_pos, const void* m, const void* linv,
                  void* dq, void* dk, void* dv, void* dr, int B, int Sq, int Skv, int Hq, int Hkv,
                  int D, int causal, int window, float scale, cudaStream_t stream) {
#define REPRO_BWD_CASE(DD)                                                                 \
  case DD:                                                                                 \
    return launch_simt<DD>(q, k, v, out, dout, q_pos, kv_pos, m, linv, dq, dk, dv, dr, B, \
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

// --------------------------------------------------------------------------
// bf16: the tensor-core kernels (TMA + wgmma)
// --------------------------------------------------------------------------

constexpr int BT = 64;     // rows of a q or kv tile (one wgmma M)
constexpr int WG = 128;    // one warpgroup: a block

template <int DP>
struct Tiles {
  static constexpr int PANEL = BT * 128;             // one 64-column panel of a tile
  static constexpr int TILE = (DP / 64) * PANEL;     // one tile, D padded to DP
  // q rows a dk / dv product step: a whole tile at D <= 64, half of it at D 128
  static constexpr int NQ = DP == 64 ? 64 : 32;
  // stages of the ring of walked tile pairs; LEAD of them load ahead of the work
  static constexpr int STAGES = 2;
  static constexpr int LEAD = STAGES - 1;
  // two tiles that stay, the ring, its mbarriers and the stayers', alignment slack
  static constexpr int BAR = (2 + 2 * STAGES) * TILE;
  static constexpr int SMEM = BAR + 8 * (1 + STAGES) + 1024;
};

// min over the block of lo, max of hi (one warpgroup; three barriers)
__device__ __forceinline__ void block_range(int* s, int& lo, int& hi) {
  lo = __reduce_min_sync(FULL, lo);
  hi = __reduce_max_sync(FULL, hi);
  if (threadIdx.x == 0) {
    s[0] = INT_MAX;
    s[1] = INT_MIN;
  }
  __syncthreads();
  if (threadIdx.x % 32 == 0) {
    atomicMin(&s[0], lo);
    atomicMax(&s[1], hi);
  }
  __syncthreads();
  lo = s[0];
  hi = s[1];
  __syncthreads();   // read by all before the next call resets it
}

// A row's 8-column bf16 chunks that this lane reads for Dr (the quad's four
// lanes take alternate chunks; chunks at or past D are zero), loaded early so
// that their latency hides behind the block's scans
template <int NCH>
__device__ __forceinline__ void load_chunks(uint4 (&x)[NCH], const __nv_bfloat16* row, bool live,
                                            int D, int part) {
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    const int col = 8 * part + 32 * c;
    x[c] = live && col < D ? *reinterpret_cast<const uint4*>(row + col) : make_uint4(0, 0, 0, 0);
  }
}

// this lane's part of rowsum(a * b) over its chunks
template <int NCH>
__device__ __forceinline__ float dot_chunks(const uint4 (&a)[NCH], const uint4 (&b)[NCH]) {
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    const __nv_bfloat162* xa = reinterpret_cast<const __nv_bfloat162*>(&a[c]);
    const __nv_bfloat162* ya = reinterpret_cast<const __nv_bfloat162*>(&b[c]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 fx = __bfloat1622float2(xa[e]);
      const float2 fy = __bfloat1622float2(ya[e]);
      acc = fmaf(fx.x, fy.x, acc);
      acc = fmaf(fx.y, fy.y, acc);
    }
  }
  return acc;
}

// Keep wgmma A fragments alive (unmodified, their registers not reused)
// until after the wait that retires the product reading them
template <int KS>
__device__ __forceinline__ void hold(const uint32_t (&a)[KS][4]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" :: "r"(a[kk][i]) : "memory");
}

// m in the log2 domain of the scores (scale * log2 e applied); the sentinel kept
__device__ __forceinline__ float log2_max(float m) {
  return m <= 0.5f * NEG_INF ? NEG_INF : m * LOG2E;
}

// S = A B^T over the padded head dim, both tiles K-major in shared memory;
// b_s may start at a later row of its tile (the dk / dv kernel's q half)
template <int DP, int N>
__device__ __forceinline__ void product_ss(float (&d)[N / 2], uint32_t a_s, uint32_t b_s) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {   // columns past D are TMA's zeros
    const uint32_t off = (kk / 4) * Tiles<DP>::PANEL + (kk % 4) * 32;
    if constexpr (N == 64) {
      wgmma_ss_n64(d, desc_sw128(a_s + off, 16), desc_sw128(b_s + off, 16), kk > 0);
    } else {
      wgmma_ss_n32(d, desc_sw128(a_s + off, 16), desc_sw128(b_s + off, 16), kk > 0);
    }
  }
}

// The accumulator fragments of a 64 x (16 KS) product as bf16 A fragments of
// KS k-steps (the two layouts agree thread for thread)
template <int KS>
__device__ __forceinline__ void pack_a(uint32_t (&a)[KS][4], const float (&s)[8 * KS]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    a[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    a[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    a[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    a[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// Store a 64 x DP accumulator (times mul) as bf16 rows row0 and row0 + 8 of
// a (.., S, H, D) tensor, columns below D
template <int DP>
__device__ __forceinline__ void store_rows(__nv_bfloat16* p0, __nv_bfloat16* p1, bool live0,
                                           bool live1, const float (&acc)[DP / 2], float mul,
                                           int c0, int D) {
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int c = 8 * j + c0;
    if (c < D) {
      if (live0) *reinterpret_cast<uint32_t*>(p0 + c) = pack_bf16(acc[4 * j] * mul, acc[4 * j + 1] * mul);
      if (live1)
        *reinterpret_cast<uint32_t*>(p1 + c) = pack_bf16(acc[4 * j + 2] * mul, acc[4 * j + 3] * mul);
    }
  }
}

// dq: one block per (q tile, q head, batch), on a 1-D grid whose first
// blocks take the last q tiles (under a causal mask they walk the most kv
// tiles; the many short blocks then balance as they finish).  q / k / v /
// dout through the tensor maps; out and dout also read directly for Dr.
template <int DP>
__global__ void __launch_bounds__(WG, DP == 64 ? 4 : 1)   // D <= 64: four blocks an SM
bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
             const __nv_bfloat16* __restrict__ out, const __nv_bfloat16* __restrict__ dout,
             const int* __restrict__ q_pos, const int* __restrict__ kv_pos,
             const float* __restrict__ m_in, const float* __restrict__ linv_in,
             float* __restrict__ dr_out, __nv_bfloat16* __restrict__ dq, int B, int Sq,
             int Skv, int Hq, int Hkv, int D, int causal, int window, float scale,
             float scale_log2) {
  using T = Tiles<DP>;
  constexpr int NA = DP / 2;             // dQ accumulators a thread
  extern __shared__ uint8_t smem_raw[];
  __shared__ int s_red[2];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t do_s = base + T::TILE;
  const uint32_t ring = base + 2 * T::TILE;   // stage st: K at ring + 2 st TILE, V after it
  const uint32_t bar_q = base + T::BAR;
  const uint32_t bar_kv = bar_q + 8;          // + 8 * stage

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int nqt = (Sq + BT - 1) / BT;
  const int h = blockIdx.x % Hq;
  const int b = (blockIdx.x / Hq) % B;
  const int q0 = (nqt - 1 - static_cast<int>(blockIdx.x / (Hq * B))) * BT;
  const int hk = h / (Hq / Hkv);
  const int r0 = 16 * warp + lane / 4;   // this thread's rows: r0 and r0 + 8
  const int c0 = 2 * (lane % 4);         // and columns c0, c0 + 1 of each 8
  const size_t row_stride = static_cast<size_t>(Hq) * D;

  if (tid == 0) {
    prefetch_map(&tq);
    prefetch_map(&tk);
    prefetch_map(&tv);
    prefetch_map(&tdo);
    mbar_init(bar_q, 1);
    for (int st = 0; st < T::STAGES; ++st) mbar_init(bar_kv + 8 * st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, 2 * T::TILE);
    for (int p = 0; p < DP / 64; ++p) {
      tma_load(q_s + p * T::PANEL, &tq, bar_q, 64 * p, h, q0, b);
      tma_load(do_s + p * T::PANEL, &tdo, bar_q, 64 * p, h, q0, b);
    }
  }
  {
    const int i0 = q0 + r0, i1 = i0 + 8;
    const bool live0 = i0 < Sq, live1 = i1 < Sq;
    const size_t srow = (static_cast<size_t>(b) * Hq + h) * Sq;
    // O and dO of the two rows (for Dr), their statistics and positions
    constexpr int NCH = DP / 32;
    uint4 o_raw[2][NCH], do_raw[2][NCH];
    const size_t off0 = (static_cast<size_t>(b) * Sq + (live0 ? i0 : 0)) * row_stride + static_cast<size_t>(h) * D;
    const size_t off1 = (static_cast<size_t>(b) * Sq + (live1 ? i1 : 0)) * row_stride + static_cast<size_t>(h) * D;
    load_chunks<NCH>(o_raw[0], out + off0, live0, D, lane % 4);
    load_chunks<NCH>(do_raw[0], dout + off0, live0, D, lane % 4);
    load_chunks<NCH>(o_raw[1], out + off1, live1, D, lane % 4);
    load_chunks<NCH>(do_raw[1], dout + off1, live1, D, lane % 4);
    const float m0 = live0 ? log2_max(m_in[srow + i0]) : 0.f;
    const float m1 = live1 ? log2_max(m_in[srow + i1]) : 0.f;
    const float l0 = live0 ? linv_in[srow + i0] : 0.f;
    const float l1 = live1 ? linv_in[srow + i1] : 0.f;
    const int qp0 = live0 ? q_pos[i0] : 0;
    const int qp1 = live1 ? q_pos[i1] : 0;

    // the kv tiles that may hold a valid key for some row of the tile; each
    // warp takes the tile's position range itself
    int lo = INT_MAX, hi = INT_MIN;
    for (int i = q0 + lane; i < min(q0 + BT, Sq); i += 32) {
      const int qp = __ldg(q_pos + i);
      lo = min(lo, qp);
      hi = max(hi, qp);
    }
    lo = __reduce_min_sync(FULL, lo);
    hi = __reduce_max_sync(FULL, hi);
    int first = INT_MAX, last = -1;
    for (int j = tid; j < Skv; j += WG) {
      const int kp = __ldg(kv_pos + j);
      if (may_meet(kp, kp, lo, hi, causal, window)) {
        first = min(first, j);
        last = j;
      }
    }
    block_range(s_red, first, last);
    const int kf = last < 0 ? 0 : first / BT;
    const int nkv = last < 0 ? 0 : last / BT - kf + 1;

    auto issue = [&](int v) {
      const int st = v % T::STAGES;
      const uint32_t k_st = ring + st * 2 * T::TILE;
      const uint32_t bar = bar_kv + 8 * st;
      const int k0 = (kf + v) * BT;
      mbar_expect_tx(bar, 2 * T::TILE);
      for (int p = 0; p < DP / 64; ++p) {
        tma_load(k_st + p * T::PANEL, &tk, bar, 64 * p, hk, k0, b);
        tma_load(k_st + T::TILE + p * T::PANEL, &tv, bar, 64 * p, hk, k0, b);
      }
    };

    if (tid == 0)
      for (int v = 0; v < T::LEAD && v < nkv; ++v) issue(v);
    // Dr, while the first tiles load
    float dr0 = row_sum(dot_chunks<NCH>(o_raw[0], do_raw[0]));
    float dr1 = row_sum(dot_chunks<NCH>(o_raw[1], do_raw[1]));
    if (lane % 4 == 0) {
      if (live0) dr_out[srow + i0] = dr0;
      if (live1) dr_out[srow + i1] = dr1;
    }
    float acc[NA];
#pragma unroll
    for (int i = 0; i < NA; ++i) acc[i] = 0.f;
    mbar_wait(bar_q, 0);

    for (int v = 0; v < nkv; ++v) {
      __syncthreads();   // every thread is done with the stage that issue(v + LEAD) refills
      if (tid == 0 && v + T::LEAD < nkv) issue(v + T::LEAD);
      const int st = v % T::STAGES;
      const uint32_t k_st = ring + st * 2 * T::TILE;
      const uint32_t v_st = k_st + T::TILE;
      const int k0 = (kf + v) * BT;
      int kp[16];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + 8 * j + c0 + e;
          kp[2 * j + e] = key < Skv ? __ldg(kv_pos + key) : 0;
        }
      }
      mbar_wait(bar_kv + 8 * st, (v / T::STAGES) & 1);

      // S = Q K^T and dP = dO V^T
      float s[32], dp[32];
#pragma unroll
      for (int r = 0; r < 32; ++r) s[r] = dp[r] = 0.f;
      // two commit groups, so that P is formed while dP is computed
      wgmma_fence();
      product_ss<DP, 64>(s, q_s, k_st);
      wgmma_commit();
      product_ss<DP, 64>(dp, do_s, v_st);
      wgmma_commit();

      // P on valid scores, 0 elsewhere (a key past Skv too).  Where every
      // key of this thread's 16 columns exists and is valid for both of its
      // rows (most tiles of a causal prefill), no mask is applied.
      int kmin = kp[0], kmax = kp[0];
#pragma unroll
      for (int j = 1; j < 16; ++j) {
        kmin = min(kmin, kp[j]);
        kmax = max(kmax, kp[j]);
      }
      const bool all_valid = k0 + BT <= Skv && live0 && live1 &&
                             (!causal || kmax <= min(qp0, qp1)) &&
                             (window < 0 || kmin > max(qp0, qp1) - window);
      wgmma_wait1();
      fence_regs(s);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x0 = s[4 * j + e];
          float& x1 = s[4 * j + 2 + e];
          const float p0 = fast_exp2(fmaf(x0, scale_log2, -m0)) * l0;
          const float p1 = fast_exp2(fmaf(x1, scale_log2, -m1)) * l1;
          if (all_valid) {
            x0 = p0;
            x1 = p1;
          } else {
            const bool exists = k0 + 8 * j + c0 + e < Skv;
            const int kpv = kp[2 * j + e];
            x0 = exists && live0 && key_valid(kpv, qp0, causal, window) ? p0 : 0.f;
            x1 = exists && live1 && key_valid(kpv, qp1, causal, window) ? p1 : 0.f;
          }
        }
      }
      // dS = P (dP - Dr)
      wgmma_wait0();
      fence_regs(dp);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[4 * j + e] *= dp[4 * j + e] - dr0;
          s[4 * j + 2 + e] *= dp[4 * j + 2 + e] - dr1;
        }
      }
      uint32_t a[4][4];
      pack_a<4>(a, s);
      // dQ += dS K, K as an MN-major B
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_pv<DP>(acc, a[kk], desc_sw128(k_st + kk * 16 * 128, T::PANEL));
      wgmma_commit();
      wgmma_wait0();
      fence_regs(acc);
    }
    __nv_bfloat16* d0 = dq + (static_cast<size_t>(b) * Sq + i0) * row_stride + static_cast<size_t>(h) * D;
    store_rows<DP>(d0, d0 + 8 * row_stride, live0, live1, acc, scale, c0, D);
  }
}

// dk / dv: one block per (kv tile, kv head, batch), on a 1-D grid whose
// first blocks take the first kv tiles (under a causal mask they meet the
// most q tiles)
template <int DP>
__global__ void __launch_bounds__(WG)
bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
               const int* __restrict__ q_pos, const int* __restrict__ kv_pos,
               const float* __restrict__ m_in, const float* __restrict__ linv_in,
               const float* __restrict__ dr_in, __nv_bfloat16* __restrict__ dk,
               __nv_bfloat16* __restrict__ dv, int B, int Sq, int Skv, int Hq, int Hkv,
               int D, int causal, int window, float scale, float scale_log2) {
  using T = Tiles<DP>;
  constexpr int NQ = T::NQ;
  constexpr int NS = NQ / 2;             // S^T / dP^T accumulators a thread
  constexpr int NA = DP / 2;             // dK / dV accumulators a thread
  extern __shared__ uint8_t smem_raw[];
  // a visit's q rows: {m (log2 domain), 1 / l, Dr, position}, and the
  // position range of each half of them; two buffers
  __shared__ float4 s_st[2][BT];
  __shared__ int2 s_qr[2][2];
  __shared__ int s_red[2];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t k_s = base;
  const uint32_t v_s = base + T::TILE;
  const uint32_t ring = base + 2 * T::TILE;   // stage st: Q at ring + 2 st TILE, dO after it
  const uint32_t bar_kv = base + T::BAR;
  const uint32_t bar_q = bar_kv + 8;          // + 8 * stage

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int hk = blockIdx.x % Hkv;
  const int b = (blockIdx.x / Hkv) % B;
  const int k0 = static_cast<int>(blockIdx.x / (Hkv * B)) * BT;
  const int G = Hq / Hkv;
  const int r0 = 16 * warp + lane / 4;   // this thread's keys: r0 and r0 + 8 of the tile
  const int c0 = 2 * (lane % 4);         // and q columns c0, c0 + 1 of each 8
  const int nqt = (Sq + BT - 1) / BT;

  if (tid == 0) {
    prefetch_map(&tq);
    prefetch_map(&tk);
    prefetch_map(&tv);
    prefetch_map(&tdo);
    mbar_init(bar_kv, 1);
    for (int st = 0; st < T::STAGES; ++st) mbar_init(bar_q + 8 * st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // K and V load while the block scans
    mbar_expect_tx(bar_kv, 2 * T::TILE);
    for (int p = 0; p < DP / 64; ++p) {
      tma_load(k_s + p * T::PANEL, &tk, bar_kv, 64 * p, hk, k0, b);
      tma_load(v_s + p * T::PANEL, &tv, bar_kv, 64 * p, hk, k0, b);
    }
  }
  // has some q row of the group seen no valid key?  Its P is 1 / Skv on
  // every existing key, so then every q tile is visited
  const float* mg = m_in + (static_cast<size_t>(b) * Hq + static_cast<size_t>(hk) * G) * Sq;
  int unseen = 0;
  for (int e = tid; e < G * Sq; e += WG) unseen |= __ldg(mg + e) <= 0.5f * NEG_INF;
  unseen = __syncthreads_or(unseen);

  {
    const bool live0 = k0 + r0 < Skv, live1 = k0 + r0 + 8 < Skv;
    const int kp0 = live0 ? kv_pos[k0 + r0] : 0;
    const int kp1 = live1 ? kv_pos[k0 + r0 + 8] : 0;
    int klo = min(live0 ? kp0 : INT_MAX, live1 ? kp1 : INT_MAX);
    int khi = max(live0 ? kp0 : INT_MIN, live1 ? kp1 : INT_MIN);
    block_range(s_red, klo, khi);
    // the q tiles that may meet this kv tile (all of them if a row is unseen)
    int first = INT_MAX, last = -1;
    for (int i = tid; i < Sq; i += WG) {
      const int qp = __ldg(q_pos + i);
      if (may_meet(klo, khi, qp, qp, causal, window)) {
        first = min(first, i);
        last = i;
      }
    }
    block_range(s_red, first, last);
    const int tf = unseen ? 0 : (last < 0 ? 0 : first / BT);
    const int nt = unseen ? nqt : (last < 0 ? 0 : last / BT - tf + 1);
    const int count = G * nt;                  // visits: (q head g, q tile tf + v % nt)

    auto issue = [&](int v) {
      const int st = v % T::STAGES;
      const uint32_t q_st = ring + st * 2 * T::TILE;
      const uint32_t bar = bar_q + 8 * st;
      const int h = hk * G + v / nt;
      const int q0 = (tf + v % nt) * BT;
      mbar_expect_tx(bar, 2 * T::TILE);
      for (int p = 0; p < DP / 64; ++p) {
        tma_load(q_st + p * T::PANEL, &tq, bar, 64 * p, h, q0, b);
        tma_load(q_st + T::TILE + p * T::PANEL, &tdo, bar, 64 * p, h, q0, b);
      }
    };
    // a visit's statistics, a visit ahead: thread t < 64 m and 1 / l of row t,
    // thread 64 + t Dr and the position of row t; past Sq 1 / l = 0, so P = 0
    auto fetch = [&](int v, float& sa, float& sb) {
      const int row = tid % BT;
      const int qi = (tf + v % nt) * BT + row;
      const bool live = qi < Sq;
      const size_t idx = (static_cast<size_t>(b) * Hq + hk * G + v / nt) * Sq + (live ? qi : 0);
      if (tid < BT) {
        sa = live ? log2_max(__ldg(m_in + idx)) : 0.f;
        sb = live ? __ldg(linv_in + idx) : 0.f;
      } else {
        sa = live ? __ldg(dr_in + idx) : 0.f;
        sb = __int_as_float(live ? __ldg(q_pos + qi) : 0);
      }
    };

    float dka[NA], dva[NA];
#pragma unroll
    for (int i = 0; i < NA; ++i) dka[i] = dva[i] = 0.f;
    float sa = 0.f, sb = 0.f;
    if (count > 0) fetch(0, sa, sb);
    if (tid == 0)
      for (int v = 0; v < T::LEAD && v < count; ++v) issue(v);
    mbar_wait(bar_kv, 0);

    for (int v = 0; v < count; ++v) {
      const int st = v % T::STAGES;
      const int sbuf = v % 2;
      reinterpret_cast<float2*>(&s_st[sbuf][tid % BT])[tid / BT] = make_float2(sa, sb);
      if (tid >= BT) {
        const int qp = __float_as_int(sb);
        const int qlo = __reduce_min_sync(FULL, qp), qhi = __reduce_max_sync(FULL, qp);
        if (lane == 0) s_qr[sbuf][warp - 2] = make_int2(qlo, qhi);
      }
      // the statistics are in, and every thread is done with the statistics
      // buffer of the next visit and the stage that issue(v + LEAD) refills
      __syncthreads();
      if (tid == 0 && v + T::LEAD < count) issue(v + T::LEAD);
      if (v + 1 < count) fetch(v + 1, sa, sb);
      const uint32_t q_st = ring + st * 2 * T::TILE;
      const uint32_t do_st = q_st + T::TILE;
      // every score of the visit exists and is valid (most visits of a causal
      // prefill): no mask is applied
      const int2 qr0 = s_qr[sbuf][0], qr1 = s_qr[sbuf][1];
      const bool all_valid = k0 + BT <= Skv && (tf + v % nt + 1) * BT <= Sq &&
                             (!causal || khi <= min(qr0.x, qr1.x)) &&
                             (window < 0 || klo > max(qr0.y, qr1.y) - window);
      mbar_wait(bar_q + 8 * st, (v / T::STAGES) & 1);

#pragma unroll
      for (int half = 0; half < BT / NQ; ++half) {
        // S^T = K Q^T and dP^T = V dO^T over this half's q rows
        float s[NS], dp[NS];
#pragma unroll
        for (int r = 0; r < NS; ++r) s[r] = dp[r] = 0.f;
        // two commit groups, so that P^T is formed while dP^T is computed
        wgmma_fence();
        product_ss<DP, NQ>(s, k_s, q_st + half * NQ * 128);
        wgmma_commit();
        product_ss<DP, NQ>(dp, v_s, do_st + half * NQ * 128);
        wgmma_commit();
        wgmma_wait1();
        fence_regs(s);

        // P^T: rows are this thread's keys, columns the q rows
        bool ok[NQ / 4][2];
#pragma unroll
        for (int j = 0; j < NQ / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float4 q4 = s_st[sbuf][half * NQ + 8 * j + c0 + e];   // m, 1 / l, Dr, pos
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
              const bool valid = all_valid ||
                                 key_valid(rr ? kp1 : kp0, __float_as_int(q4.w), causal, window);
              float& xs = s[4 * j + 2 * rr + e];
              xs = fast_exp2(valid ? fmaf(xs, scale_log2, -q4.x) : NEG_INF - q4.x) * q4.y;
              ok[2 * j + e][rr] = valid;
            }
          }
        }
        uint32_t pa[NQ / 16][4];
        pack_a<NQ / 16>(pa, s);
        // dV += P^T dO (dO as an MN-major B) while dS^T is formed
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < NQ / 16; ++kk)
          wgmma_pv<DP>(dva, pa[kk], desc_sw128(do_st + (half * NQ + 16 * kk) * 128, T::PANEL));
        wgmma_commit();
        wgmma_wait1();   // dP^T is in (dV may still run)
        fence_regs(dp);
#pragma unroll
        for (int j = 0; j < NQ / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float dr = s_st[sbuf][half * NQ + 8 * j + c0 + e].z;
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
              float& xd = dp[4 * j + 2 * rr + e];
              xd = ok[2 * j + e][rr] ? s[4 * j + 2 * rr + e] * (xd - dr) : 0.f;
            }
          }
        }
        uint32_t da[NQ / 16][4];
        pack_a<NQ / 16>(da, dp);
        // dK += dS^T Q, Q as an MN-major B
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < NQ / 16; ++kk)
          wgmma_pv<DP>(dka, da[kk], desc_sw128(q_st + (half * NQ + 16 * kk) * 128, T::PANEL));
        wgmma_commit();
        wgmma_wait0();
        hold<NQ / 16>(pa);
        hold<NQ / 16>(da);
        fence_regs(dva);
        fence_regs(dka);
      }
    }
    const size_t row_stride = static_cast<size_t>(Hkv) * D;
    const size_t off = (static_cast<size_t>(b) * Skv + k0 + r0) * row_stride + static_cast<size_t>(hk) * D;
    store_rows<DP>(dk + off, dk + off + 8 * row_stride, live0, live1, dka, scale, c0, D);
    store_rows<DP>(dv + off, dv + off + 8 * row_stride, live0, live1, dva, 1.f, c0, D);
  }
}

template <int DP>
int launch_wgmma(const void* q, const void* k, const void* v, const void* out, const void* dout,
                 const void* q_pos, const void* kv_pos, const void* m, const void* linv,
                 void* dq, void* dk, void* dv, void* dr, int B, int Sq, int Skv, int Hq, int Hkv,
                 int D, int causal, int window, float scale, cudaStream_t stream) {
  // the shared-memory limit is a property of each kernel on each device
  static bool configured[MAX_DEVICES] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  if (!configured[device]) {
    err = cudaFuncSetAttribute(bwd_dq_wgmma<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Tiles<DP>::SMEM);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(bwd_dkdv_wgmma<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 Tiles<DP>::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured[device] = true;
  }
  CUtensorMap tq, tk, tv, tdo;
  if (!make_map(&tq, q, B, Sq, Hq, D) || !make_map(&tk, k, B, Skv, Hkv, D) ||
      !make_map(&tv, v, B, Skv, Hkv, D) || !make_map(&tdo, dout, B, Sq, Hq, D))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nqt = (Sq + BT - 1) / BT, nkt = (Skv + BT - 1) / BT;
  const float scale_log2 = scale * LOG2E;
  const float* fm = static_cast<const float*>(m);
  const float* fl = static_cast<const float*>(linv);
  bwd_dq_wgmma<DP><<<nqt * Hq * B, WG, Tiles<DP>::SMEM, stream>>>(
      tq, tk, tv, tdo, static_cast<const __nv_bfloat16*>(out),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const int*>(q_pos),
      static_cast<const int*>(kv_pos), fm, fl, static_cast<float*>(dr),
      static_cast<__nv_bfloat16*>(dq), B, Sq, Skv, Hq, Hkv, D, causal, window, scale,
      scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dkdv_wgmma<DP><<<nkt * Hkv * B, WG, Tiles<DP>::SMEM, stream>>>(
      tq, tk, tv, tdo, static_cast<const int*>(q_pos), static_cast<const int*>(kv_pos), fm, fl,
      static_cast<const float*>(dr), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), B, Sq, Skv, Hq, Hkv, D, causal, window, scale,
      scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Two launches on `stream`: dq (which writes Dr), then dk / dv.  Returns the
// CUDA error of the first launch that failed (0 on success).  dtype: 0 fp32
// (SIMT), 1 bf16 (wgmma); q, k, v, out, dout, dq, dk, dv alike.  m, linv:
// the forward's statistics, fp32 (B, Hq, Sq); dr: fp32 scratch of the same
// size.  window < 0 means no sliding window.
int flash_attention_bwd(const void* q, const void* k, const void* v, const void* out,
                        const void* dout, const void* q_pos, const void* kv_pos, const void* m,
                        const void* linv, void* dq, void* dk, void* dv, void* dr, int B, int Sq,
                        int Skv, int Hq, int Hkv, int D, int causal, int window, float scale,
                        int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D < 8 || D > 128 || D % 8 != 0 || Hkv <= 0 || Hq % Hkv != 0 || B < 1 || Sq < 1 ||
      Skv < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return dispatch_simt(q, k, v, out, dout, q_pos, kv_pos, m, linv, dq, dk, dv, dr, B, Sq,
                         Skv, Hq, Hkv, D, causal, window, scale, st);
  if (dtype == 1) {
    if (D <= 64)
      return launch_wgmma<64>(q, k, v, out, dout, q_pos, kv_pos, m, linv, dq, dk, dv, dr, B,
                              Sq, Skv, Hq, Hkv, D, causal, window, scale, st);
    return launch_wgmma<128>(q, k, v, out, dout, q_pos, kv_pos, m, linv, dq, dk, dv, dr, B,
                             Sq, Skv, Hq, Hkv, D, causal, window, scale, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
