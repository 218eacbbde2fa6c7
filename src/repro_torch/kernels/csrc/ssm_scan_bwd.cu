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
// and write du and ddt: ~277 MB, 0.083 ms at 3.35 TB/s; the 268 M
// exponentials take 0.064 ms at the special-function units' 16 per clock per
// SM.  On an H100 80GB HBM3 at 700 W the first, simple kernel took 0.649 ms,
// 7.8x that bound; a clock64 split of its blocks (tools/ssm_bwd_split.py)
// put 47% of a chunk in the reverse walk (28 shuffles a step a thread), 26%
// in the two forward walks (each decay taken 2.75 times), 15% in staging
// that nothing overlapped and 12% in the segments' block sums and the du /
// ddt stores.  This kernel takes 0.42 ms there, 5.0x the bound.  Taking one
// part out of a copy (the same tool) saves 16% with the dB / dC butterfly,
// 8% with the du / ddt reduce-scatter, 8% with the checkpoint walk, 5% with
// the block sums and 2% with the exponentials: with 16 warps an SM (two
// blocks of 128 registers a thread, half of them the segment's states and
// decays) the walks are bound by issue and by the latency of the shuffle
// rounds, not by memory or the special-function units.
//
// Design.  The forward's geometry: a block of 64 channels of one batch row
// (32 at L 8), L lanes a channel (the power of two >= N / 4), four states a
// lane in registers, zero padded past N (a = 1, B = C = 0, h = 0: a padded
// state adds exact zeros).  Chunks of 32 steps are walked from the last to
// the first.
// - Staging: a chunk's u, dt, dy, B and C come in their own dtype through one
//   cp.async stage: chunk k - 1 is in flight while chunk k is walked.
//   Between two walks the block widens the stage into fp32 working rows,
//   one float4 (u, dt, dy, dt u) a channel and step in an XOR-swizzled slot
//   (zero past T and Din, so a padded step is an exact identity: dt = 0,
//   a = 1), and B and C in four copies (below); it writes the previous
//   chunk's du (adding dy D there) and ddt out of those rows as 16-byte
//   vectors.  Rows that are not 16-byte aligned are staged element by
//   element, synchronously.  A thread loads the next chunk's checkpoint (the
//   state entering it) into registers as its walk ends, so the load is in
//   flight over the barriers.
// - Decays: one walk from the checkpoint keeps the state entering each
//   8-step segment in shared memory (each thread its own slots); then each
//   segment, last first, is walked forward again keeping its eight states
//   and eight decays in registers, and walked back on them.  A decay is taken
//   1 + (NSEG - 1) / NSEG = 1.75 times, always as the forward takes it
//   (ex2.approx of dt * (A log2 e)), so the recomputed states are the
//   forward's.
// - dB, dC: summed over the warp's channels by a reduce-scatter.  At L <= 4
//   a lane keeps its four states in a lane-dependent order (slot s holds
//   state 4 g + (s ^ m), m from lane bits 4 and 3, with B and C read from
//   the copy in that order), so the rounds across lane bits 4 and 3 keep
//   slots 0-1, then 0, and hand on the rest with no select; the round across
//   bit 2 leaves dB on one lane and dC on the other: 4 + 2 + 1 = 7 shuffles
//   a step at L 4, and each lane holds one distinct warp sum, written with
//   the warp's others as one row of shared memory.  (L 8: the plain
//   butterfly, with selects.)  Between walks the block sums its warps' rows
//   in warp order into per-block partials (Din / cpb, Bt, T, N); a second
//   kernel sums those over the blocks in order.
// - du, ddt: each lane adds its states' terms of each step, then one
//   reduce-scatter over the channel's L lanes a group of L steps (two at
//   L 8) leaves a lane both sums of one step (the forward's y trick), at
//   L 4 2 x 3 shuffles for 4 steps, written in place over that step's u
//   and dt in the working rows, which only this channel's lanes read.  At
//   L 4 a step costs 7 + 1.5 shuffles.
// - dA and dD stay in registers over time and are written as per-batch-row
//   partials, summed by the second kernel.
// No atomics: every sum has one order, so two calls are bit-equal and a
// recompute under activation checkpointing moves no bit.
// ssm_scan.py::bwd_geometry mirrors the constants, the shared-memory size
// and the blocks an SM below.
#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int CPB = 64;              // channels a block (the forward's); half at L 8
constexpr int CHUNK = 32;            // steps between the forward's checkpoints
constexpr int SEG = 8;               // steps a segment: its states and decays in registers
constexpr int NSEG = CHUNK / SEG;
constexpr int STATES = 4;            // states a lane
constexpr int VALS = 2 * STATES;     // a lane's dB and dC terms of one step
constexpr int MAX_N = 32;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int REDUCE_THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;
constexpr int SMEM_PER_SM = 233472;  // shared memory of an SM, bytes
constexpr int SMEM_RESERVED = 1024;  // of it, reserved for each resident block

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

// eight values of T at p (16-byte aligned) as fp32
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h2[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// 16 bytes of T from fp32 values: four floats or eight bf16.
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

// A reduce-scatter: sums v over the lanes that differ in the bits LO, 2 LO,
// ..., HI / 2 of their index, the highest first.  While more than one value
// is left, a round keeps half of them (the upper half on the lane whose bit
// is set) and adds the partner's copy of that half: one shuffle a value
// kept.  Once one is left, a round adds it whole.  The lane is left with
// kept<V, LO, HI>() consecutive sums in v, the first of them the
// butterfly_base-th of the V; lanes that differ only in the bits of
// dup_bits<V, LO, HI>() keep the same ones.
template <int V, int LO, int HI>
__host__ __device__ constexpr int kept() { return V * LO / HI > 1 ? V * LO / HI : 1; }
template <int V, int LO, int HI>
__host__ __device__ constexpr int dup_bits() { return HI / V > LO ? HI / V - LO : 0; }
template <int V, int LO, int HI>
__device__ __forceinline__ void butterfly(float (&v)[V], int lane) {
#pragma unroll
  for (int o = HI / 2, half = V / 2; o >= LO; o >>= 1, half = half > 1 ? half / 2 : 0) {
    if (half > 0) {
      const bool upper = (lane & o) != 0;
#pragma unroll
      for (int i = 0; i < half; ++i) {
        const float send = upper ? v[i] : v[i + half];
        const float keep = upper ? v[i + half] : v[i];
        v[i] = keep + __shfl_xor_sync(FULL, send, o);
      }
    } else {
      v[0] += __shfl_xor_sync(FULL, v[0], o);
    }
  }
}
template <int V, int LO, int HI>
__device__ __forceinline__ int butterfly_base(int lane) {
  int base = 0;
#pragma unroll
  for (int o = HI / 2, half = V / 2; o >= LO; o >>= 1, half = half > 1 ? half / 2 : 0)
    if (half > 0 && (lane & o)) base += half;
  return base;
}

// Channels a block: 32 at L 8, so that its 256 threads, one block an SM,
// keep every value in registers.  Row stride of the working rows, in float4:
// (u, dt, dy, dt u) of a channel.
// Channel c sits in slot c ^ (c / 8 % 8): a warp's eight channels and the
// eight channels one thread moves between walks each fill all eight 16-byte
// bank groups.
template <int L>
__host__ __device__ constexpr int cpb() { return L == 8 ? CPB / 2 : CPB; }
template <int L>
__host__ __device__ constexpr int rs4() { return cpb<L>() + 1; }
__device__ __forceinline__ int slot(int c) { return c ^ ((c >> 3) & 7); }

// Shared memory of one block (ssm_scan.py::bwd_geometry mirrors it).  First
// fp32, at offsets that do not depend on N: the working rows ([CHUNK][rs4]
// float4 of u / du, dt / ddt, dy and dt u), B and C ([copies][CHUNK][NP]),
// the warps' dB / dC rows ([CHUNK][warps][2 NP]) and each thread's segment
// entry states ([NSEG - 1][threads] float4); then the raw stage: u, dt, dy,
// B and C of a chunk as they lie in device memory.
__host__ __device__ constexpr int round16(int bytes) { return (bytes + 15) / 16 * 16; }
// Copies of a chunk's B and C: four at L <= 4, one a lane's order of its
// states (see ssm_bwd_kernel), one at L 8.
__host__ __device__ constexpr int bc_copies(int L) { return L <= 4 ? 4 : 1; }
template <int L>
__host__ __device__ constexpr int work_floats() {
  return 4 * CHUNK * rs4<L>() + 2 * bc_copies(L) * CHUNK * STATES * L +
         CHUNK * (cpb<L>() * L / 32) * 2 * STATES * L + (NSEG - 1) * cpb<L>() * L * 4;
}
template <typename T, int L>
__host__ __device__ constexpr int raw_bytes(int N) {
  return 2 * CHUNK * cpb<L>() * static_cast<int>(sizeof(T)) + CHUNK * cpb<L>() * 4 +
         2 * round16(CHUNK * N * static_cast<int>(sizeof(T)));
}
template <typename T, int L>
__host__ __device__ constexpr int smem_bytes(int N) {
  return 4 * work_floats<L>() + raw_bytes<T, L>(N);
}
// Two blocks an SM (<= 128 registers a thread) where two fit the SM's shared
// memory at every N of these L lanes, else one (<= 255 registers); one at
// L 8, whose pairs of steps for du / ddt and plain butterfly need more.
template <typename T, int L>
__host__ __device__ constexpr int min_blocks() {
  return L < 8 && smem_bytes<T, L>(STATES * L) + SMEM_RESERVED <= SMEM_PER_SM / 2 ? 2 : 1;
}

// u, dy: (Bt, T, Din) T; delta: (Bt, T, Din) fp32; A: (Din, N) fp32; B, C:
// (Bt, T, N) T; D: (Din,) fp32; ckpt: (Bt, ceil(T / CHUNK), Din, N) fp32;
// dhT: (Bt, Din, N) fp32 -> du (T), ddelta (fp32), dh0 (fp32), and the
// partials dBp, dCp (ceil(Din / cpb), Bt, T, N), dAp (Bt, Din, N), dDp (Bt,
// Din).  Grid (ceil(Din / cpb), Bt), cpb * L threads.  vec: every row 16-byte
// aligned (cp.async, vector stores).
template <typename T, int L>
__global__ void __launch_bounds__(cpb<L>() * L, min_blocks<T, L>())
ssm_bwd_kernel(const T* __restrict__ u, const float* __restrict__ delta,
               const float* __restrict__ A, const T* __restrict__ B,
               const T* __restrict__ C, const float* __restrict__ D,
               const float* __restrict__ ckpt, const T* __restrict__ dy,
               const float* __restrict__ dhT, T* __restrict__ du,
               float* __restrict__ ddelta, float* __restrict__ dh0,
               float* __restrict__ dBp, float* __restrict__ dCp,
               float* __restrict__ dAp, float* __restrict__ dDp,
               int Tlen, int Din, int N, int vec) {
  constexpr int CP = cpb<L>();                 // channels a block
  constexpr int RS = rs4<L>();
  constexpr int THREADS = CP * L;
  constexpr int NP = STATES * L;               // states a channel, padded
  constexpr int W = THREADS / 32;              // warps a block
  constexpr int RW = 2 * NP;                   // a warp's dB, dC row of one step
  constexpr int GRP = L == 8 ? 2 : L;          // steps a du / ddt reduce-scatter
  constexpr bool PERM = L <= 4;                // dB, dC summed without selects (below)
  constexpr int NC = bc_copies(L);
  constexpr int PER = 16 / static_cast<int>(sizeof(T));   // elements of T in 16 bytes
  constexpr int UNITS = CHUNK * CP / 8;        // (row, 8 channels) units of a chunk
  extern __shared__ __align__(16) float sm[];
  float4* ws = reinterpret_cast<float4*>(sm);  // [CHUNK][RS] (u or du, dt or ddt, dy, dt u)
  float* bs = sm + 4 * CHUNK * RS;            // [NC][CHUNK][NP] B, zero past N and T
  float* cs = bs + NC * CHUNK * NP;            // [NC][CHUNK][NP] C
  float* wr = cs + NC * CHUNK * NP;            // [CHUNK][W][RW] warps' dB, dC sums
  float4* hb = reinterpret_cast<float4*>(wr + CHUNK * W * RW);   // [NSEG - 1][THREADS]
  T* u_raw = reinterpret_cast<T*>(sm + work_floats<L>());     // [CHUNK][CP]
  float* dt_raw = reinterpret_cast<float*>(u_raw + CHUNK * CP);   // [CHUNK][CP]
  T* dy_raw = reinterpret_cast<T*>(dt_raw + CHUNK * CP);     // [CHUNK][CP]
  T* b_raw = dy_raw + CHUNK * CP;                            // [CHUNK][N]
  T* c_raw = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(b_raw) +
                                  round16(CHUNK * N * static_cast<int>(sizeof(T))));

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int c = tid / L;                       // channel within the block
  const int cs4 = slot(c);                     // its slot in a working row
  const int g = tid % L;                       // this lane's group of states
  // The lane keeps state STATES g + (s ^ m) in its slot s.  The partner
  // across lane bit 4 has m ^ 2, across bit 3 m ^ 1, so a partner's slots 2,
  // 3 (bit 4) or 1 (bit 3) hold this lane's slots 0, 1 or 0: the butterfly
  // of dB and dC halves its values with no select.  B and C are read from
  // copy m, whose row holds them in that order.
  const int m = PERM ? ((lane >> 4) & 1) * 2 + ((lane >> 3) & 1) : 0;
  const int b = blockIdx.y, Bt = gridDim.y;
  const int d0 = blockIdx.x * CP;
  const int d = d0 + c;
  const bool dlive = d < Din;
  const size_t row = static_cast<size_t>(b) * Tlen;
  const int nchunks = (Tlen + CHUNK - 1) / CHUNK;

  // a2 = A log2 e, the forward's; the ddt terms are summed in these units and
  // taken back by ln 2 once a step
  float a2[STATES], carry[STATES], dA[STATES];
#pragma unroll
  for (int s = 0; s < STATES; ++s) {
    const int n = STATES * g + (s ^ m);
    const bool live = dlive && n < N;
    a2[s] = live ? A[static_cast<size_t>(d) * N + n] * LOG2E : 0.f;
    carry[s] = live ? dhT[(static_cast<size_t>(b) * Din + d) * N + n] : 0.f;
    dA[s] = 0.f;
  }
  const float dskip = dlive ? D[d] : 0.f;
  float dD = 0.f;

  // chunk kk of u, dt, dy, B and C into the raw stage (one cp.async group)
  auto stage = [&](int kk) {
    const int t0 = kk * CHUNK;
    const int steps = min(CHUNK, Tlen - t0);
    if (vec) {
      constexpr int SEG_U = CP / PER, SEG_D = CP / 4;
      for (int e = tid; e < steps * SEG_U; e += THREADS) {
        const int r = e / SEG_U, ch = (e % SEG_U) * PER;
        const bool ok = d0 + ch < Din;
        const size_t o = (row + t0 + r) * Din + d0 + ch;
        cp16(u_raw + r * CP + ch, ok ? u + o : u, ok);
        cp16(dy_raw + r * CP + ch, ok ? dy + o : dy, ok);
      }
      for (int e = tid; e < steps * SEG_D; e += THREADS) {
        const int r = e / SEG_D, ch = (e % SEG_D) * 4;
        const bool ok = d0 + ch < Din;
        cp16(dt_raw + r * CP + ch, ok ? delta + (row + t0 + r) * Din + d0 + ch : delta, ok);
      }
      const int segs = steps * N / PER;        // N * sizeof(T) is a multiple of 16
      const size_t off = (row + t0) * N;
      for (int e = tid; e < segs; e += THREADS) {
        cp16(b_raw + e * PER, B + off + e * PER, true);
        cp16(c_raw + e * PER, C + off + e * PER, true);
      }
    } else {
      for (int e = tid; e < steps * CP; e += THREADS) {
        const int r = e / CP, ch = e % CP;
        const bool ok = d0 + ch < Din;
        const size_t o = (row + t0 + r) * Din + d0 + ch;
        u_raw[e] = ok ? u[o] : T(0.f);
        dt_raw[e] = ok ? delta[o] : 0.f;
        dy_raw[e] = ok ? dy[o] : T(0.f);
      }
      const size_t off = (row + t0) * N;
      for (int e = tid; e < steps * N; e += THREADS) {
        b_raw[e] = B[off + e];
        c_raw[e] = C[off + e];
      }
    }
    cp_async_commit();
  };

  // Between walks: this thread's states entering chunk k into h (its
  // checkpoint, loaded first so that the rest hides the load); chunk kp =
  // k + 1's du, ddt out of the working rows and its dB, dC rows summed over
  // the warps; chunk k's stage widened into the working rows.  A thread reads
  // and then rewrites the same working elements, so no barrier is needed
  // between the two.
  auto between = [&](int k) {
    const int kp = k + 1;
    const int steps_p = kp < nchunks ? min(CHUNK, Tlen - kp * CHUNK) : 0;
    const int steps = k >= 0 ? min(CHUNK, Tlen - k * CHUNK) : 0;
    for (int e = tid; e < UNITS; e += THREADS) {
      const int r = e / (CP / 8), ch = (e % (CP / 8)) * 8;
      float4* wo = ws + r * RS + ch;          // channel ch + p in wo[p ^ (ch / 8)]
      if (r < steps_p) {
        const size_t o = (row + kp * CHUNK + r) * Din + d0 + ch;
        float uo[8], dto[8];
#pragma unroll
        for (int p = 0; p < 8; ++p) {
          const float4 x = wo[p ^ (ch >> 3)];
          uo[p] = x.x;
          dto[p] = x.y;
        }
        if (vec) {
#pragma unroll
          for (int p = 0; p < 8; p += PER)
            if (d0 + ch + p < Din) store16(du + o + p, uo + p);
#pragma unroll
          for (int p = 0; p < 8; p += 4)
            if (d0 + ch + p < Din) store16(ddelta + o + p, dto + p);
        } else {
#pragma unroll
          for (int p = 0; p < 8; ++p) {
            if (d0 + ch + p < Din) {
              from_float(du + o + p, uo[p]);
              ddelta[o + p] = dto[p];
            }
          }
        }
      }
      if (k >= 0) {
        float vu[8], vd[8], vg[8];
        if (r < steps) {
          load8(u_raw + r * CP + ch, vu);
          load8(dt_raw + r * CP + ch, vd);
          load8(dy_raw + r * CP + ch, vg);
        } else {
#pragma unroll
          for (int p = 0; p < 8; ++p) vu[p] = vd[p] = vg[p] = 0.f;
        }
#pragma unroll
        for (int p = 0; p < 8; ++p)
          wo[p ^ (ch >> 3)] = make_float4(vu[p], vd[p], vg[p], vd[p] * vu[p]);
      }
    }
    if (kp < nchunks) {
      // four states at a time: the warps' rows in warp order
      for (int e = tid; e < CHUNK * RW / 4; e += THREADS) {
        const int i = e / (RW / 4), idx = (e % (RW / 4)) * 4, n = idx % NP;
        if (i < steps_p && n < N) {
          float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int w = 0; w < W; ++w) {
            const float4 x = *reinterpret_cast<const float4*>(wr + (i * W + w) * RW + idx);
            sum.x += x.x; sum.y += x.y; sum.z += x.z; sum.w += x.w;
          }
          float* out = (idx >= NP ? dCp : dBp) +
                       ((static_cast<size_t>(blockIdx.x) * Bt + b) * Tlen + kp * CHUNK + i) * N + n;
          const float v[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (n + q < N) out[q] = v[q];
        }
      }
    }
    if (k >= 0) {
      // each (step, group of four states) once, into every copy: B, then C
#pragma unroll
      for (int which = 0; which < 2; ++which) {
        const T* src = which ? c_raw : b_raw;
        float* dst = which ? cs : bs;
        for (int e = tid; e < CHUNK * L; e += THREADS) {
          const int r = e / L, n0 = (e % L) * STATES;
          float x[STATES];
#pragma unroll
          for (int s = 0; s < STATES; ++s)
            x[s] = r < steps && n0 + s < N ? to_float(src[r * N + n0 + s]) : 0.f;
#pragma unroll
          for (int q = 0; q < NC; ++q)         // copy q: state n0 + (s ^ q) in place s
            *reinterpret_cast<float4*>(dst + (q * CHUNK + r) * NP + n0) =
                make_float4(x[q], x[1 ^ q], x[2 ^ q], x[3 ^ q]);
        }
      }
    }
  };

  const int bc_off = m * CHUNK * NP + STATES * g;   // this lane's B, C in a row of its copy
  // this thread's checkpoint: the states entering chunk kk
  auto load_ck = [&](int kk, float (&h)[STATES]) {
    const float* ck = ckpt + ((static_cast<size_t>(b) * nchunks + kk) * Din + d) * N;
#pragma unroll
    for (int s = 0; s < STATES; ++s) {
      const int n = STATES * g + (s ^ m);
      h[s] = dlive && n < N ? ck[n] : 0.f;
    }
  };

  // one forward step at chunk step tt, the forward kernel's arithmetic;
  // a[s] = the step's decays
  auto advance = [&](float (&h)[STATES], float (&a)[STATES], int tt) {
    const float4 w = ws[tt * RS + cs4];
    const float dv = w.y, dvu = w.w;
    const float4 bv = *reinterpret_cast<const float4*>(bs + bc_off + tt * NP);
    const float bb[STATES] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int s = 0; s < STATES; ++s) {
      a[s] = ex2(dv * a2[s]);
      h[s] = a[s] * h[s] + dvu * bb[s];
    }
  };

  // where this lane's warp sums of dB, dC land in a step's row, and which
  // step of a du / ddt group it writes.  L <= 4: after the two select-free
  // rounds the lane's slot 0 holds state STATES g + m summed over the
  // channels that differ in lane bits 3, 4; a reduce-scatter across bit 2
  // leaves its dB on the lane without that bit, its dC on the lane with it,
  // and rounds across the channel bits below add them whole.
  constexpr int KB = PERM ? 1 : kept<VALS, L, 32>();
  float* const wrow = wr + warp * RW;
  const bool hi = (lane & 4) != 0;
  const int bidx = butterfly_base<VALS, L, 32>(lane);
  int wcol[KB];
#pragma unroll
  for (int kk = 0; kk < KB; ++kk)
    wcol[kk] = PERM ? (hi ? NP : 0) + STATES * g + m
                    : ((bidx + kk) / STATES) * NP + STATES * g + (bidx + kk) % STATES;
  const bool wwrite = (lane & (PERM ? 3 & ~(L - 1) : dup_bits<VALS, L, 32>())) == 0;
  const int gstep = butterfly_base<GRP, 1, L>(g);   // this lane's step in a du / ddt group
  const bool gwrite = (g & dup_bits<GRP, 1, L>()) == 0;

  float h[STATES];
  load_ck(nchunks - 1, h);
  stage(nchunks - 1);
  for (int k = nchunks - 1;; --k) {
    cp_async_wait0();                          // chunk k has landed (this thread's copies)
    __syncthreads();                           // ... everyone's; the walk of chunk k + 1 is done
    between(k);
    if (k < 0) break;
    __syncthreads();                           // the working rows are chunk k's; the stage is free
    if (k > 0) stage(k - 1);

    const int steps = min(CHUNK, Tlen - k * CHUNK);
    const int nseg = (steps + SEG - 1) / SEG;
    // the state entering each segment, from the chunk's checkpoint
#pragma unroll 1
    for (int j = 0; j + 1 < nseg; ++j) {
      hb[j * THREADS + tid] = make_float4(h[0], h[1], h[2], h[3]);
      float a[STATES];
#pragma unroll
      for (int i = 0; i < SEG; ++i) advance(h, a, j * SEG + i);
    }
    // each segment, last first: walked forward keeping its states and
    // decays, then back
#pragma unroll 1
    for (int j = nseg - 1; j >= 0; --j) {
      const int s0 = j * SEG;
      if (j + 1 < nseg) {
        const float4 v = hb[j * THREADS + tid];
        h[0] = v.x; h[1] = v.y; h[2] = v.z; h[3] = v.w;
      }
      float hist[SEG][STATES], av[SEG][STATES];
#pragma unroll
      for (int i = 0; i < SEG; ++i) {
        advance(h, av[i], s0 + i);
#pragma unroll
        for (int s = 0; s < STATES; ++s) hist[i][s] = h[s];
      }
      float pdu[GRP], pdd[GRP];                // this lane's du, ddt terms of a group of steps
#pragma unroll
      for (int i = SEG - 1; i >= 0; --i) {
        const int tt = s0 + i;
        const float4 w = ws[tt * RS + cs4];
        const float uv = w.x, dv = w.y, gy = w.z, dvu = w.w;
        const float4 bv = *reinterpret_cast<const float4*>(bs + bc_off + tt * NP);
        const float4 cv = *reinterpret_cast<const float4*>(cs + bc_off + tt * NP);
        const float bb[STATES] = {bv.x, bv.y, bv.z, bv.w};
        const float cc[STATES] = {cv.x, cv.y, cv.z, cv.w};
        float pu = 0.f, pd = 0.f, v[VALS];
#pragma unroll
        for (int s = 0; s < STATES; ++s) {
          const float G = gy * cc[s] + carry[s];
          carry[s] = av[i][s] * G;
          // G a_t h_{t-1}; at the segment's first step a_t h_{t-1} is taken
          // back from h_t (the entry state is not kept)
          const float gah = i > 0 ? carry[s] * hist[i > 0 ? i - 1 : 0][s]
                                  : G * (hist[0][s] - dvu * bb[s]);
          pu += G * bb[s];
          pd += a2[s] * gah;
          dA[s] += dv * gah;
          v[s] = G * dvu;
          v[STATES + s] = gy * hist[i][s];
        }
        const int q = i % GRP;                 // the step's place in its group
        pdu[q] = pu;
        pdd[q] = pd * LN2 + uv * pu;
        dD += gy * uv;
        if constexpr (PERM) {
          // v: dB of slots 0-3, then dC
#pragma unroll
          for (int s = 0; s < 2; ++s) {
            v[s] += __shfl_xor_sync(FULL, v[s + 2], 16);
            v[STATES + s] += __shfl_xor_sync(FULL, v[STATES + s + 2], 16);
          }
          v[0] += __shfl_xor_sync(FULL, v[1], 8);
          v[STATES] += __shfl_xor_sync(FULL, v[STATES + 1], 8);
          const float send = hi ? v[0] : v[STATES];
          float keep = hi ? v[STATES] : v[0];
          keep += __shfl_xor_sync(FULL, send, 4);
#pragma unroll
          for (int o = 2; o >= L; o >>= 1) keep += __shfl_xor_sync(FULL, keep, o);
          if (wwrite) wrow[tt * W * RW + wcol[0]] = keep;
        } else {
          butterfly<VALS, L, 32>(v, lane);
          if (wwrite) {
#pragma unroll
            for (int kk = 0; kk < KB; ++kk) wrow[tt * W * RW + wcol[kk]] = v[kk];
          }
        }
        if (q == 0) {
          // steps tt .. tt + GRP - 1 summed over the channel's lanes: this
          // lane writes step tt + gstep over its u and dt (read by now: the
          // warp has passed the shuffles)
          butterfly<GRP, 1, L>(pdu, g);
          butterfly<GRP, 1, L>(pdd, g);
          float4* wo = ws + (tt + gstep) * RS + cs4;
          const float4 wg = *wo;
          __syncwarp();
          if (gwrite)
            *reinterpret_cast<float2*>(wo) = make_float2(pdu[0] * wg.y + wg.z * dskip, pdd[0]);
        }
      }
    }
    if (k > 0) load_ck(k - 1, h);              // in flight over the barriers and between()
  }
#pragma unroll
  for (int s = 0; s < STATES; ++s) {
    const int n = STATES * g + (s ^ m);
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
  const int smem = smem_bytes<T, L>(N);
  cudaError_t err = cudaFuncSetAttribute(ssm_bwd_kernel<T, L>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(ssm_bwd_kernel<T, L>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(u) | reinterpret_cast<uintptr_t>(delta) |
                         reinterpret_cast<uintptr_t>(B) | reinterpret_cast<uintptr_t>(C) |
                         reinterpret_cast<uintptr_t>(dy) |
                         reinterpret_cast<uintptr_t>(du) | reinterpret_cast<uintptr_t>(ddelta);
  const int es = static_cast<int>(sizeof(T));
  const int vec = (ptrs & 15u) == 0 && (Din * es) % 16 == 0 && (Din * 4) % 16 == 0 &&
                  (N * es) % 16 == 0;
  const int nblk = (Din + cpb<L>() - 1) / cpb<L>();
  const size_t nbc = static_cast<size_t>(Bt) * Tlen * N;
  float* dBp = static_cast<float*>(work);
  float* dCp = dBp + nblk * nbc;
  float* dAp = dCp + nblk * nbc;
  float* dDp = dAp + static_cast<size_t>(Bt) * Din * N;
  ssm_bwd_kernel<T, L><<<dim3(nblk, Bt), cpb<L>() * L, smem, stream>>>(
      static_cast<const T*>(u), static_cast<const float*>(delta),
      static_cast<const float*>(A), static_cast<const T*>(B), static_cast<const T*>(C),
      static_cast<const float*>(D), static_cast<const float*>(ckpt),
      static_cast<const T*>(dy), static_cast<const float*>(dhT), static_cast<T*>(du),
      static_cast<float*>(ddelta), static_cast<float*>(dh0), dBp, dCp, dAp, dDp,
      Tlen, Din, N, vec);
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
// of 2 ceil(Din / cpb) Bt T N + Bt Din N + Bt Din elements (cpb: 64, 32 at
// N > 16).
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
