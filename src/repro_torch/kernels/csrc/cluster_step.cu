// Batch cold-start cluster simulator for Hopper (sm_90a), written by hand:
// every sweep cell through all T fixed-dt cohort steps in one launch.
//
// Replaces the TPU kernel src/repro/kernels/cluster_step.py::
// cluster_sim_pallas (body _cluster_kernel, step _kernel_step).  There the
// cell axis is a parallel grid axis and time runs as a sequential grid axis
// of 128-step chunks, with the cohort state nw / fs / free / agg held in
// VMEM scratch from one chunk to the next.  The semantics of one step are
// those of repro_torch/kernels/ref.py::cluster_step_full (the torch copy of
// the reference oracle): a K-edge expiry walk, a spawn sized by
// max(conc, Little's law) placed by first-fit with proportional scale-back
// on over-committed workers, serving with partial-cohort promotion and
// exponential surplus decay, and per-tier idle GB-s billing.
//
// What bounds it on the card: the T-step dependency chain of each cell, not
// bytes and not arithmetic.  At batch_dense64 (C 64, F 20, W 4, T 1280) the
// launch reads about 13 MB (4 us at 3.35 TB/s); a step is a chain of
// dependent latencies (cross-function sums of F terms in index order, the
// ceil / floor of near-integer counts) issued by one warp.  The first,
// simple kernel (one thread a function, state in shared memory, block
// barriers, arrivals loaded from device memory each step) took 3.2 us a
// step; a clock64 trace put the time in every phase alike (loads 0.26 us,
// the expiry check 0.46, spawn 0.70, scale-back 0.56, serve 0.65, footprint
// pass 0.34, idle 0.20).
// This kernel takes about 1.3 us a step: the step is a long, branchy
// instruction stream that one warp issues, with no other warp on the SM to
// fill its stalls.
//
// Design (cluster_warp_kernel, one warp a cell; every registered batch grid
// fits it: F <= 64, W <= 8, K <= 8):
//   * Lane l owns functions l and l + 32.  Its FS scalars, FP columns,
//     promote row, dwell / ntier rows, nw row and row sum n stay in
//     registers; loops over W, K and the lane's functions are unrolled to
//     compile-time bounds (4 or 8) with zero padding.  n is carried from one
//     step to the next (it is the same index-order sum the plain version
//     recomputes).
//   * The free vector lives in registers, the same copy in every lane.  A
//     sum across functions (the free updates, used_w, the scale-back) goes
//     through a shared-memory transpose: each lane writes its rows as 16-byte
//     vectors, then every lane adds the F rows in index order, W columns at
//     once, from broadcast loads.  The order is the plain version's
//     (ref._ordered_sum), so kernel and plain version agree bit for bit in a
//     contended step.  No block barrier: __any_sync and __syncwarp only.
//     With no worker over-committed every scale is 1 and the second
//     scale-back sum equals the first bit for bit, so it is skipped.
//   * A division by a power of two (mem 1024 MB, dt 0.5 s in every
//     registered grid) is a multiplication by its exact reciprocal, the same
//     IEEE quotient; a full step (dt_eff == dt) reuses its per-cell and
//     per-function quotients.  Every other division is IEEE.
//   * arrivals / conc come through a two-stage ring of 128-step chunks in
//     shared memory: chunk k + 1 is in flight while chunk k runs.  A chunk
//     whose rows are 16-byte aligned (F a multiple of 4) is one bulk copy
//     (cp.async.bulk, completing on an mbarrier); any other is 4-byte
//     cp.async by every lane.  Steps past the horizon queue their arrivals
//     from the ring.
//   * Chain floor, counted from this code, of the shortest active step (no
//     expiry edge fires, nothing is taken): about 86 dependent ALU operations
//     (step time 5, fire test 3, Little's law and the first-fit caps 20,
//     serve 25 with one division, the footprint sum F + 4, the row sum 4 and
//     idle billing), 2 shared-memory round trips and 3 warp votes: ~470
//     cycles, 0.24 us at 1.98 GHz, so 0.28 ms over batch_dense64's 1200
//     active steps (F 40: ~550 cycles, 0.33 ms).
// Tables beyond that layout (a wide random table, F 256 x W 64) take
// cluster_block_kernel, the first design: one block a cell, thread f owns
// function f, nw in shared memory, thread w sums over f in the same index
// order.  repro_torch/kernels/cluster_step.py::layout picks by shape.
//
// The RL keep-alive gym (repro_torch/learn/gym.py) advances the grid one
// epoch a launch: a step offset t_begin puts step t of the launch at
// now = float(t_begin + t) * dt (integers below 2^24 are exact in fp32, so
// this is the reference gym's (e * E + t) * dt), and an optional output of
// per-function extras (C, 2, F) holds cold starts and idle GB-s, each summed
// over the launch's steps in time order from zero, as the reference gym sums
// cluster_step_full's extras.  Cold is the running AG_COLD sum of a function;
// idle has an accumulator of its own (the per-tier sums round in another
// order).  Kernels with and without extras are separate instantiations
// (template flag EX), so the sweep's kernel is the same code as before.
//
// Both kernels are built with -fmad=false and IEEE division (no
// --use_fast_math): the plain version rounds every product and quotient, and
// near-integer values feed ceil / floor (Little's law, floor(free / mem),
// the capacity), where one contracted FMA can flip a count and compound over
// a thousand steps.  agg is a per-function running sum over t, reduced over
// f once at the end (the reference sums over f before t; both are float32
// and agree within the reference's rtol 1e-4, atol 1e-2).
#include <cstdint>

#include <cuda_runtime.h>

namespace {

// layout constants: repro_torch/kernels/ref.py
constexpr int FS_TIER = 0, FS_EDGE = 1, FS_DEADLINE = 2, FS_QUEUED = 3,
              FS_HAS_SNAP = 4, FS_IMG = 5, FS_N = 6;
constexpr int FP_MEM_MB = 0, FP_EXEC_S = 1, FP_EXEC_GB = 2, FP_SVC = 3,
              FP_MEM_GB = 4, FP_N = 5;
constexpr int SC_DT = 0, SC_HORIZON = 1, SC_IMG_CACHE = 2, SC_SNAPSHOT = 3,
              SC_SANITIZE_S = 4, SC_N = 5;
constexpr int AG_REQUESTS = 0, AG_COLD = 1, AG_WARM = 2, AG_LAUNCHED = 3,
              AG_PROMOTIONS = 4, AG_DEMOTIONS = 5, AG_LAT_SUM = 6,
              AG_QWAIT_SUM = 7, AG_EXEC_GB_S = 8, AG_IDLE_WARM = 9,
              AG_IDLE_PAUSED = 10, AG_IDLE_SNAP = 11, AG_N = 12;
constexpr int N_TIERS = 5;
constexpr float T_DEAD = 0.f, T_IMG = 1.f, T_SNAP = 2.f, T_PAUSED = 3.f,
                T_WARM = 4.f;
constexpr float BIG_TIME = 1e30f;
constexpr int MAX_THREADS = 512;   // block kernel: 128 registers a thread, no spills
constexpr int CHUNK = 128;         // warp kernel: steps a ring stage holds
constexpr int WARP_MAX_F = 64, WARP_MAX_W = 8, WARP_MAX_K = 8;
constexpr unsigned FULL = 0xffffffffu;

// table[idx] for an integral idx in [0, 5), else 0: the reference's one-hot
// select (_tier_select / _frac_at / _pick) over a row held in registers.
__device__ __forceinline__ float select5(const float (&row)[N_TIERS], float idx) {
  float out = 0.f;
#pragma unroll
  for (int t = 0; t < N_TIERS; ++t) out = (idx == static_cast<float>(t)) ? row[t] : out;
  return out;
}

// The same select over a zero-padded row of KM registers; idx is clamped to
// [0, K - 1] by the caller, so a padded entry is never picked.
template <int KM>
__device__ __forceinline__ float select_k(const float (&row)[KM], float idx) {
  float out = 0.f;
#pragma unroll
  for (int k = 0; k < KM; ++k) out = (idx == static_cast<float>(k)) ? row[k] : out;
  return out;
}

// The same select over a row of K entries in device memory.
__device__ __forceinline__ float select_row(const float* __restrict__ row, int k, float idx) {
  if (idx >= 0.f && idx < static_cast<float>(k) && idx == floorf(idx))
    return __ldg(row + static_cast<int>(idx));
  return 0.f;
}

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

// bytes (a multiple of 16) from 16-byte aligned device memory into shared
// memory, completing on the mbarrier
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// 1 / y where y is a normal power of two (then x * (1 / y) is the IEEE
// quotient x / y exactly: 1 / y is exact and one rounding of the same real
// number follows), else 0.
__device__ __forceinline__ float exact_recip(float y) {
  const uint32_t b = __float_as_uint(y);
  const uint32_t e = (b >> 23) & 0xffu;
  return ((b & 0x007fffffu) == 0 && e != 0 && e != 0xffu) ? 1.f / y : 0.f;
}

// x / y, IEEE; r = exact_recip(y) turns it into one multiplication.
__device__ __forceinline__ float div_by(float x, float y, float r) {
  return r != 0.f ? x * r : x / y;
}

// A sum across functions, over the F rows of WM floats at xs, in index
// order over f from 0 (s[w] = ((t[0][w] + t[1][w]) + t[2][w]) + ...), every
// column at once, the same in every lane (16-byte broadcast loads).  The
// term is MODE 0: x[f][w]; 1: x[f][w] * mem[f]; 2: (x[f][w] * scale[w]) * mem[f].
// A rolled loop unrolled 8 times measured faster on the card than deeper
// unrolling or loading the next rows ahead (the step is one warp's chain).
constexpr int ROW_UNROLL = 8;
template <int MODE, int WM>
__device__ __forceinline__ void row_pass(const float* __restrict__ xs,
                                         const float* __restrict__ mem_s, int F,
                                         const float (&scale)[WM], float (&s)[WM]) {
#pragma unroll
  for (int w = 0; w < WM; ++w) s[w] = 0.f;
#pragma unroll ROW_UNROLL
  for (int f = 0; f < F; ++f) {
    const float m = MODE ? mem_s[f] : 0.f;
#pragma unroll
    for (int q = 0; q < WM / 4; ++q) {
      const float4 v = reinterpret_cast<const float4*>(xs + f * WM)[q];
      const float r[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float t = r[i];
        if (MODE == 2) t = t * scale[4 * q + i];
        if (MODE) t = t * m;
        s[4 * q + i] += t;
      }
    }
  }
}

// Row x[f][0..WM) as 16-byte vectors.
template <int WM>
__device__ __forceinline__ void store_row(float* __restrict__ xs, int f, const float (&r)[WM]) {
#pragma unroll
  for (int q = 0; q < WM / 4; ++q)
    reinterpret_cast<float4*>(xs + f * WM)[q] =
        make_float4(r[4 * q], r[4 * q + 1], r[4 * q + 2], r[4 * q + 3]);
}

// Shared memory of the warp kernel: two mbarriers, the ring of two stages
// of (arrivals, conc) x CHUNK x F, the transpose rows F x WM, mem[F] and the
// final AG_N x F reduction.
__host__ __device__ constexpr int warp_row(int W) { return W <= 4 ? 4 : 8; }
long long warp_smem_bytes(int F, int W) {
  return 16LL + 4LL * (4LL * CHUNK * F + static_cast<long long>(F) * warp_row(W) + F +
                       static_cast<long long>(AG_N) * F);
}

// One warp advances one cell through all T steps.  FPL functions a lane
// (F <= 32 * FPL), WM >= W workers and KM >= K schedule edges, zero padded.
// EX: also write the per-function extras (cold, idle GB-s) of the launch.
template <int FPL, int WM, int KM, bool EX>
__global__ void __launch_bounds__(32)
cluster_warp_kernel(const float* __restrict__ nw0, const float* __restrict__ fs0,
                    const float* __restrict__ free0, const float* __restrict__ arrivals,
                    const float* __restrict__ conc, const float* __restrict__ fparam,
                    const float* __restrict__ promote, const float* __restrict__ dwell,
                    const float* __restrict__ ntier, const float* __restrict__ frac,
                    const float* __restrict__ scal, float* __restrict__ nw_out,
                    float* __restrict__ fs_out, float* __restrict__ free_out,
                    float* __restrict__ agg_out, float* __restrict__ extras_out,
                    int F, int W, int K, int T, int t_begin) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t bar0 = smem_u32(smem_raw);             // mbarrier of stage s at bar0 + 8 s
  float* ring = reinterpret_cast<float*>(smem_raw + 16);  // [2][arrivals, conc][CHUNK * F]
  float* xs = ring + 4 * CHUNK * F;                       // [F][WM] transpose rows
  float* mem_s = xs + F * WM;                             // [F] memory per container, MB
  float* red = mem_s + F;                                 // [AG_N][F] final reduction

  const int c = blockIdx.x;
  const int lane = threadIdx.x;
  const float* sc = scal + static_cast<size_t>(c) * SC_N;
  const float dt = sc[SC_DT];
  const float horizon = sc[SC_HORIZON];
  const float img_cache = sc[SC_IMG_CACHE];
  const float snapshot = sc[SC_SNAPSHOT];
  const float sanitize = sc[SC_SANITIZE_S];
  float fr[N_TIERS];
#pragma unroll
  for (int t = 0; t < N_TIERS; ++t) fr[t] = frac[c * N_TIERS + t];

  bool live[FPL];
  float tier[FPL], edge[FPL], deadline[FPL], queued[FPL], has_snap[FPL], img[FPL];
  float mem[FPL], mem1[FPL], exec_s[FPL], exec_gb[FPL], svc[FPL], mem_gb[FPL], d0[FPL];
  float rmem[FPL], rdecay_full[FPL];   // exact_recip(mem1); the decay factor of a full step
  float pr[FPL][N_TIERS], dw[FPL][KM], nt[FPL][KM], nw[FPL][WM], n[FPL], acc[FPL][AG_N];
  // idle GB-s summed over the launch's steps in time order (EX only): not
  // the sum of the three per-tier sums, which round in another order
  float idle_sum[FPL];
#pragma unroll
  for (int j = 0; j < FPL; ++j) {
    const int f = lane + 32 * j;
    idle_sum[j] = 0.f;
    live[j] = f < F;
    const size_t cf = static_cast<size_t>(c) * F + (live[j] ? f : 0);
    tier[j] = edge[j] = deadline[j] = queued[j] = has_snap[j] = img[j] = 0.f;
    mem[j] = exec_s[j] = svc[j] = 1.f;
    exec_gb[j] = mem_gb[j] = 0.f;
#pragma unroll
    for (int t = 0; t < N_TIERS; ++t) pr[j][t] = 0.f;
#pragma unroll
    for (int k = 0; k < KM; ++k) dw[j][k] = nt[j][k] = 0.f;
#pragma unroll
    for (int w = 0; w < WM; ++w) nw[j][w] = 0.f;
#pragma unroll
    for (int a = 0; a < AG_N; ++a) acc[j][a] = 0.f;
    if (live[j]) {
      const float* s = fs0 + cf * FS_N;
      tier[j] = s[FS_TIER];
      edge[j] = s[FS_EDGE];
      deadline[j] = s[FS_DEADLINE];
      queued[j] = s[FS_QUEUED];
      has_snap[j] = s[FS_HAS_SNAP];
      img[j] = s[FS_IMG];
      const float* p = fparam + cf * FP_N;
      mem[j] = p[FP_MEM_MB];
      exec_s[j] = p[FP_EXEC_S];
      exec_gb[j] = p[FP_EXEC_GB];
      svc[j] = p[FP_SVC];
      mem_gb[j] = p[FP_MEM_GB];
#pragma unroll
      for (int t = 0; t < N_TIERS; ++t) pr[j][t] = promote[cf * N_TIERS + t];
#pragma unroll
      for (int k = 0; k < KM; ++k)
        if (k < K) {
          dw[j][k] = dwell[cf * K + k];
          nt[j][k] = ntier[cf * K + k];
        }
#pragma unroll
      for (int w = 0; w < WM; ++w)
        if (w < W) nw[j][w] = nw0[cf * W + w];
      mem_s[f] = mem[j];
    }
    mem1[j] = fmaxf(mem[j], 1.f);
    rmem[j] = exact_recip(mem1[j]);
    d0[j] = dw[j][0];
    rdecay_full[j] = fminf(dt / fmaxf(d0[j], 1e-9f), 1.f);
    n[j] = 0.f;
#pragma unroll
    for (int w = 0; w < WM; ++w) n[j] += nw[j][w];
  }
  float freev[WM];                     // the free vector, the same in every lane
#pragma unroll
  for (int w = 0; w < WM; ++w) freev[w] = w < W ? free0[static_cast<size_t>(c) * W + w] : 0.f;

  if (lane == 0) {
    mbar_init(bar0, 1);
    mbar_init(bar0 + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();

  const float rdt_full = exact_recip(fmaxf(dt, 1e-9f));
  const float* arr_c = arrivals + static_cast<size_t>(c) * T * F;
  const float* conc_c = conc + static_cast<size_t>(c) * T * F;
  const int nchunks = (T + CHUNK - 1) / CHUNK;
  bool bulk0 = false, bulk1 = false;   // was stage s's chunk one bulk copy?
  uint32_t parity = 0;                 // bit s: the next phase of stage s's mbarrier

  // chunk kk of arrivals / conc into stage kk & 1; one cp.async group a chunk
  // (empty for a bulk copy), so that wait_group counts chunks
  auto issue = [&](int kk) {
    const int st = kk & 1;
    const int steps = min(CHUNK, T - kk * CHUNK);
    float* da = ring + st * 2 * CHUNK * F;
    float* dc = da + CHUNK * F;
    const float* sa = arr_c + static_cast<size_t>(kk) * CHUNK * F;
    const float* scn = conc_c + static_cast<size_t>(kk) * CHUNK * F;
    const uint32_t bytes = static_cast<uint32_t>(steps * F) * 4u;
    const bool bulk = (((reinterpret_cast<uintptr_t>(sa) | reinterpret_cast<uintptr_t>(scn)) & 15u) == 0)
        && (bytes & 15u) == 0;
    if (bulk) {
      if (lane == 0) {
        const uint32_t bar = bar0 + 8 * st;
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_expect_tx(bar, 2 * bytes);
        bulk_load(smem_u32(da), sa, bytes, bar);
        bulk_load(smem_u32(dc), scn, bytes, bar);
      }
    } else {
      for (int e = lane; e < steps * F; e += 32) {
        cp_async4(smem_u32(da + e), sa + e);
        cp_async4(smem_u32(dc + e), scn + e);
      }
    }
    cp_async_commit();
    if (st) bulk1 = bulk; else bulk0 = bulk;
  };

  if (nchunks > 0) issue(0);
  for (int kc = 0; kc < nchunks; ++kc) {
    const int st = kc & 1;
    const int t0 = kc * CHUNK;
    const int steps = min(CHUNK, T - t0);
    const bool more = kc + 1 < nchunks;
    __syncwarp();                      // every lane is done with chunk kc - 1's stage
    if (more) issue(kc + 1);
    if (more) cp_async_wait<1>(); else cp_async_wait<0>();
    if (st ? bulk1 : bulk0) {
      mbar_wait(bar0 + 8 * st, (parity >> st) & 1u);
      parity ^= 1u << st;
    }
    __syncwarp();                      // the other lanes' cp.async data are visible
    const float* a_s = ring + st * 2 * CHUNK * F;
    const float* c_s = a_s + CHUNK * F;

    for (int tt = 0; tt < steps; ++tt) {
      const float now = static_cast<float>(t_begin + t0 + tt) * dt;
      const float dt_eff = fminf(fmaxf(horizon - now, 0.f), dt);
      float a_t[FPL];
#pragma unroll
      for (int j = 0; j < FPL; ++j) {  // a clamped index, no branch: dead lanes read a live entry
        const float v = a_s[tt * F + min(lane + 32 * j, F - 1)];
        a_t[j] = live[j] ? v : 0.f;
      }
      if (!(dt_eff > 0.f)) {           // past the horizon: arrivals only queue
#pragma unroll
        for (int j = 0; j < FPL; ++j) queued[j] = queued[j] + a_t[j];
        continue;
      }
      // a full step (dt_eff == dt, every step but the last inside the
      // horizon) reuses its quotients: dt_eff / dt is exactly 1
      const bool full = dt_eff == dt;
      float c_t[FPL], rdecay[FPL];
#pragma unroll
      for (int j = 0; j < FPL; ++j) {
        const float v = c_s[tt * F + min(lane + 32 * j, F - 1)];
        c_t[j] = live[j] ? v : 0.f;
        rdecay[j] = full ? rdecay_full[j] : fminf(dt_eff / fmaxf(d0[j], 1e-9f), 1.f);
      }
      const float ratio = full ? 1.f : (dt > 0.f ? dt_eff / dt : 0.f);
      const float dt_pos = fmaxf(dt_eff, 1e-9f);
      const float rdt = full ? rdt_full : exact_recip(dt_pos);

      // ---- 1. expiry walk ---- //
      for (int e = 0; e < K; ++e) {
        bool fire[FPL], anyf = false;
#pragma unroll
        for (int j = 0; j < FPL; ++j) {
          fire[j] = (n[j] > 0.f) && (deadline[j] <= now);
          anyf |= fire[j];
        }
        if (!__any_sync(FULL, anyf)) break;
        bool died[FPL];
        __syncwarp();
#pragma unroll
        for (int j = 0; j < FPL; ++j) {
          const float tgt = select_k(nt[j], fminf(fmaxf(edge[j], 0.f), static_cast<float>(K - 1)));
          died[j] = fire[j] && (tgt == T_DEAD);
          const bool demoted = fire[j] && !died[j];
          const float old_res = mem[j] * select5(fr, tier[j]);
          const float new_res = died[j] ? 0.f : mem[j] * select5(fr, tgt);
          const float v = fire[j] ? new_res - old_res : 0.f;
          if (demoted) acc[j][AG_DEMOTIONS] += n[j];
          const float nxt = select_k(dw[j], fminf(fmaxf(edge[j] + 1.f, 0.f), static_cast<float>(K - 1)));
          deadline[j] = demoted ? now + nxt : (died[j] ? BIG_TIME : deadline[j]);
          tier[j] = demoted ? tgt : tier[j];
          has_snap[j] = fmaxf(has_snap[j], (demoted && tgt == T_SNAP) ? 1.f : 0.f);
          edge[j] = fire[j] ? edge[j] + 1.f : edge[j];
          if (live[j]) {
            float prod[WM];
#pragma unroll
            for (int w = 0; w < WM; ++w) prod[w] = nw[j][w] * v;
            store_row(xs, lane + 32 * j, prod);
          }
        }
        __syncwarp();
        float s[WM];
        row_pass<0>(xs, mem_s, F, freev, s);
#pragma unroll
        for (int w = 0; w < WM; ++w) freev[w] = freev[w] - s[w];
#pragma unroll
        for (int j = 0; j < FPL; ++j)
          if (died[j]) {
#pragma unroll
            for (int w = 0; w < WM; ++w) nw[j][w] = 0.f;
            n[j] = 0.f;
          }
      }

      // ---- 2. spawn: first-fit against the current free vector ---- //
      float demand[FPL], spawn_cost[FPL], tk[FPL][WM];
      bool any_take = false;
#pragma unroll
      for (int j = 0; j < FPL; ++j) {
        demand[j] = queued[j] + a_t[j];
        const float required = fmaxf(ceilf(div_by(demand[j] * exec_s[j], dt_pos, rdt)), c_t[j]);
        const float need = fminf(fmaxf(required - n[j], 0.f), demand[j]);
        const float spawn_tier = has_snap[j] > 0.f ? T_SNAP
            : ((img_cache > 0.f && img[j] > 0.f) ? T_IMG : T_DEAD);
        spawn_cost[j] = select5(pr[j], spawn_tier);
        float cum = 0.f;
#pragma unroll
        for (int w = 0; w < WM; ++w) {
          const float cap = fmaxf(floorf(div_by(freev[w], mem1[j], rmem[j])), 0.f);
          cum = cum + cap;
          tk[j][w] = fminf(fmaxf(need - (cum - cap), 0.f), cap);
          any_take |= tk[j][w] > 0.f;
        }
      }
      float granted[FPL];
#pragma unroll
      for (int j = 0; j < FPL; ++j) granted[j] = 0.f;
      if (__any_sync(FULL, any_take)) {  // proportional scale-back per worker
        __syncwarp();
#pragma unroll
        for (int j = 0; j < FPL; ++j)
          if (live[j]) store_row(xs, lane + 32 * j, tk[j]);
        __syncwarp();
        float used[WM], scale[WM], s[WM];
        row_pass<1>(xs, mem_s, F, freev, used);
        bool over = false;             // an over-committed worker
#pragma unroll
        for (int w = 0; w < WM; ++w) {
          scale[w] = 1.f;
          if (used[w] > freev[w]) {
            scale[w] = freev[w] / fmaxf(used[w], 1e-9f);
            over = true;
          }
        }
        // with every scale 1, (take * 1) * mem is take * mem: the second
        // sum is the first, bit for bit
        if (over) {
          row_pass<2>(xs, mem_s, F, scale, s);
        } else {
#pragma unroll
          for (int w = 0; w < WM; ++w) s[w] = used[w];
        }
#pragma unroll
        for (int w = 0; w < WM; ++w) freev[w] = freev[w] - s[w];
#pragma unroll
        for (int j = 0; j < FPL; ++j)
#pragma unroll
          for (int w = 0; w < WM; ++w) {
            tk[j][w] = tk[j][w] * scale[w];
            granted[j] += tk[j][w];
          }
      }

      // ---- 3. serve queued + fresh demand ---- //
      bool any_delta = false;
      float v[FPL], nonidle[FPL];
#pragma unroll
      for (int j = 0; j < FPL; ++j) {
        has_snap[j] = fmaxf(has_snap[j], (granted[j] > 0.f ? 1.f : 0.f) * snapshot);
        img[j] = fmaxf(img[j], granted[j] > 0.f ? 1.f : 0.f);
        const float capacity = floorf((n[j] + granted[j]) * svc[j] * ratio);
        const float served = fminf(demand[j], capacity);
        const bool cohort_demoted = (tier[j] < T_WARM) && (n[j] > 0.f);
        const float used = fminf(fmaxf(fmaxf(ceilf(div_by(served * exec_s[j], dt_pos, rdt)),
                                             c_t[j]), 1.f),
                                 fmaxf(n[j], 1.f));
        const float promoted = cohort_demoted ? fminf(served, used) : 0.f;
        const float cold_spawn = fminf(granted[j], served - promoted);
        const float warm = served - promoted - cold_spawn;
        const float prom_cost = select5(pr[j], tier[j]);
        const bool restore = cohort_demoted && (served > 0.f);
        const float res_now = mem[j] * select5(fr, tier[j]);
        const bool decaying = !cohort_demoted && (served > 0.f) && (n[j] > 0.f);
        const float surplus = fmaxf(n[j] - used, 0.f);
        const float decay = surplus * rdecay[j];
        const float n1 = fmaxf(n[j], 1.f);
        const bool promote_part = restore && n[j] > 0.f;
        float keep = 1.f;              // one division, and none when nothing changes
        if (promote_part || decaying) {
          const float q = (promote_part ? used : decay) / n1;
          keep = promote_part ? q : 1.f - q;
        }
        v[j] = (restore ? keep * (mem[j] - res_now) : 0.f) - (1.f - keep) * res_now;
        any_delta |= v[j] != 0.f;
        const float drop = 1.f - keep;
#pragma unroll
        for (int w = 0; w < WM; ++w) tk[j][w] = (nw[j][w] + tk[j][w]) - nw[j][w] * drop;
        tier[j] = restore ? T_WARM : tier[j];

        const float leftover = demand[j] - served;
        const float busy_warm = warm * (exec_s[j] + sanitize);
        const float wait = leftover * dt_eff;
        acc[j][AG_PROMOTIONS] += promoted;
        acc[j][AG_REQUESTS] += served;
        acc[j][AG_COLD] += promoted + cold_spawn;
        acc[j][AG_WARM] += warm;
        acc[j][AG_LAUNCHED] += granted[j];
        acc[j][AG_LAT_SUM] += busy_warm + promoted * (prom_cost + exec_s[j])
            + cold_spawn * (spawn_cost[j] + exec_s[j]);
        acc[j][AG_QWAIT_SUM] += wait;
        acc[j][AG_LAT_SUM] += wait;
        acc[j][AG_EXEC_GB_S] += (busy_warm + (promoted + cold_spawn) * exec_s[j]) * exec_gb[j];

        // any activity re-arms the cohort at the top of its schedule
        const bool hit = (served + granted[j]) > 0.f;
        edge[j] = hit ? 0.f : edge[j];
        deadline[j] = hit ? now + exec_s[j] + d0[j] : deadline[j];
        tier[j] = hit ? T_WARM : tier[j];
        queued[j] = leftover;
        nonidle[j] = busy_warm + promoted * (exec_s[j] + prom_cost)
            + cold_spawn * (exec_s[j] + spawn_cost[j]);
      }
      if (__any_sync(FULL, any_delta)) {   // footprint of promoted / retired containers
        __syncwarp();
#pragma unroll
        for (int j = 0; j < FPL; ++j)
          if (live[j]) {
            float prod[WM];
#pragma unroll
            for (int w = 0; w < WM; ++w) prod[w] = nw[j][w] * v[j];
            store_row(xs, lane + 32 * j, prod);
          }
        __syncwarp();
        float s[WM];
        row_pass<0>(xs, mem_s, F, freev, s);
#pragma unroll
        for (int w = 0; w < WM; ++w) freev[w] = freev[w] - s[w];
      }

      // ---- 4. idle GB-s at the cohort's tier footprint ---- //
#pragma unroll
      for (int j = 0; j < FPL; ++j) {
        n[j] = 0.f;
#pragma unroll
        for (int w = 0; w < WM; ++w) {
          nw[j][w] = tk[j][w];
          n[j] += nw[j][w];
        }
        const float idle_gb = fmaxf(n[j] * dt_eff - nonidle[j], 0.f) * mem_gb[j] * select5(fr, tier[j]);
        if (EX) idle_sum[j] += idle_gb;
        if (tier[j] == T_WARM) acc[j][AG_IDLE_WARM] += idle_gb;
        else if (tier[j] == T_PAUSED) acc[j][AG_IDLE_PAUSED] += idle_gb;
        else if (tier[j] == T_SNAP) acc[j][AG_IDLE_SNAP] += idle_gb;
      }
    }
  }

#pragma unroll
  for (int j = 0; j < FPL; ++j)
    if (live[j]) {
      const size_t cf = static_cast<size_t>(c) * F + lane + 32 * j;
#pragma unroll
      for (int w = 0; w < WM; ++w)
        if (w < W) nw_out[cf * W + w] = nw[j][w];
      float* s = fs_out + cf * FS_N;
      s[FS_TIER] = tier[j];
      s[FS_EDGE] = edge[j];
      s[FS_DEADLINE] = deadline[j];
      s[FS_QUEUED] = queued[j];
      s[FS_HAS_SNAP] = has_snap[j];
      s[FS_IMG] = img[j];
#pragma unroll
      for (int a = 0; a < AG_N; ++a) red[a * F + lane + 32 * j] = acc[j][a];
      if (EX) {   // cold is the running per-function AG_COLD sum
        extras_out[(static_cast<size_t>(c) * 2 + 0) * F + lane + 32 * j] = acc[j][AG_COLD];
        extras_out[(static_cast<size_t>(c) * 2 + 1) * F + lane + 32 * j] = idle_sum[j];
      }
    }
#pragma unroll
  for (int w = 0; w < WM; ++w)
    if (w == lane && w < W) free_out[static_cast<size_t>(c) * W + w] = freev[w];
  __syncwarp();
  if (lane < AG_N) {
    float s = 0.f;
    for (int f = 0; f < F; ++f) s += red[lane * F + f];
    agg_out[static_cast<size_t>(c) * AG_N + lane] = s;
  }
}

// The first layout, for tables beyond the warp kernel's bounds: one block a
// cell, thread f owns function f (registers), nw[F, W] and free[W] in shared
// memory, thread w sums over f in index order (the warp kernel's order).
// EX as in the warp kernel.
template <bool EX>
__global__ void __launch_bounds__(MAX_THREADS)
cluster_block_kernel(const float* __restrict__ nw0, const float* __restrict__ fs0,
               const float* __restrict__ free0, const float* __restrict__ arrivals,
               const float* __restrict__ conc, const float* __restrict__ fparam,
               const float* __restrict__ promote, const float* __restrict__ dwell,
               const float* __restrict__ ntier, const float* __restrict__ frac,
               const float* __restrict__ scal, float* __restrict__ nw_out,
               float* __restrict__ fs_out, float* __restrict__ free_out,
               float* __restrict__ agg_out, float* __restrict__ extras_out,
               int F, int W, int K, int T, int t_begin) {
  extern __shared__ __align__(16) float smem[];
  const int WS = W | 1;                // odd row stride
  float* nw = smem;                    // F * WS resident counts
  float* tk = nw + F * WS;             // F * WS takes, then the new counts
  float* free_s = tk + F * WS;         // W free MB per worker
  float* scale_s = free_s + W;         // W scale-back per worker
  float* vec = scale_s + W;            // F per-function deltas for worker passes
  float* mem_s = vec + F;              // F memory per container, MB
  float* red = mem_s + F;              // AG_N * F final reduction

  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const bool is_f = tid < F;
  const bool is_w = tid < W;

  const float* sc = scal + static_cast<size_t>(c) * SC_N;
  const float dt = sc[SC_DT];
  const float horizon = sc[SC_HORIZON];
  const float img_cache = sc[SC_IMG_CACHE];
  const float snapshot = sc[SC_SNAPSHOT];
  const float sanitize = sc[SC_SANITIZE_S];
  float fr[N_TIERS];
#pragma unroll
  for (int t = 0; t < N_TIERS; ++t) fr[t] = frac[c * N_TIERS + t];

  // thread f's function
  const int fi = is_f ? tid : 0;
  const size_t cf = static_cast<size_t>(c) * F + fi;
  float tier = 0.f, edge = 0.f, deadline = 0.f, queued = 0.f, has_snap = 0.f, img = 0.f;
  float mem = 1.f, exec_s = 1.f, exec_gb = 0.f, svc = 1.f, mem_gb = 0.f, d0 = 0.f;
  float pr[N_TIERS] = {0.f, 0.f, 0.f, 0.f, 0.f};
  const float* dw_row = dwell + cf * K;
  const float* nt_row = ntier + cf * K;
  float* my = nw + fi * WS;
  float* my_tk = tk + fi * WS;
  if (is_f) {
    const float* s = fs0 + cf * FS_N;
    tier = s[FS_TIER];
    edge = s[FS_EDGE];
    deadline = s[FS_DEADLINE];
    queued = s[FS_QUEUED];
    has_snap = s[FS_HAS_SNAP];
    img = s[FS_IMG];
    const float* p = fparam + cf * FP_N;
    mem = p[FP_MEM_MB];
    exec_s = p[FP_EXEC_S];
    exec_gb = p[FP_EXEC_GB];
    svc = p[FP_SVC];
    mem_gb = p[FP_MEM_GB];
#pragma unroll
    for (int t = 0; t < N_TIERS; ++t) pr[t] = promote[cf * N_TIERS + t];
    d0 = dw_row[0];
    for (int w = 0; w < W; ++w) my[w] = nw0[cf * W + w];
    mem_s[tid] = mem;
  }
  if (is_w) free_s[tid] = free0[static_cast<size_t>(c) * W + tid];
  float acc[AG_N];
#pragma unroll
  for (int a = 0; a < AG_N; ++a) acc[a] = 0.f;
  float idle_sum = 0.f;                // EX: idle GB-s in time order
  __syncthreads();

  const float* arr_c = arrivals + static_cast<size_t>(c) * T * F;
  const float* conc_c = conc + static_cast<size_t>(c) * T * F;
  const float mem1 = fmaxf(mem, 1.f);

  for (int t = 0; t < T; ++t) {
    const float now = static_cast<float>(t_begin + t) * dt;
    const float dt_eff = fminf(fmaxf(horizon - now, 0.f), dt);
    const float a_t = is_f ? arr_c[static_cast<size_t>(t) * F + tid] : 0.f;
    if (!(dt_eff > 0.f)) {             // past the horizon: arrivals only queue
      queued = queued + a_t;
      continue;
    }
    const float c_t = is_f ? conc_c[static_cast<size_t>(t) * F + tid] : 0.f;

    // ---- 1. expiry walk ---- //
    for (int e = 0; e < K; ++e) {
      bool fire = false, died = false;
      if (is_f) {
        float n = 0.f;
        for (int w = 0; w < W; ++w) n += my[w];
        const float tgt = select_row(nt_row, K, fminf(fmaxf(edge, 0.f), static_cast<float>(K - 1)));
        fire = (n > 0.f) && (deadline <= now);
        died = fire && (tgt == T_DEAD);
        const bool demoted = fire && !died;
        const float old_res = mem * select5(fr, tier);
        const float new_res = died ? 0.f : mem * select5(fr, tgt);
        vec[tid] = fire ? new_res - old_res : 0.f;
        if (demoted) acc[AG_DEMOTIONS] += n;
        const float nxt = select_row(dw_row, K, fminf(fmaxf(edge + 1.f, 0.f), static_cast<float>(K - 1)));
        deadline = demoted ? now + nxt : (died ? BIG_TIME : deadline);
        tier = demoted ? tgt : tier;
        has_snap = fmaxf(has_snap, (demoted && tgt == T_SNAP) ? 1.f : 0.f);
        edge = fire ? edge + 1.f : edge;
      }
      if (!__syncthreads_or(fire)) break;
      if (is_w) {
        float s = 0.f;
        for (int f = 0; f < F; ++f) s += nw[f * WS + tid] * vec[f];
        free_s[tid] = free_s[tid] - s;
      }
      __syncthreads();
      if (died)
        for (int w = 0; w < W; ++w) my[w] = 0.f;
    }

    // ---- 2. spawn: first-fit against the current free vector ---- //
    const float dt_pos = fmaxf(dt_eff, 1e-9f);
    float demand = 0.f, n = 0.f, spawn_cost = 0.f;
    bool any_take = false;
    if (is_f) {
      demand = queued + a_t;
      for (int w = 0; w < W; ++w) n += my[w];
      const float required = fmaxf(ceilf(demand * exec_s / dt_pos), c_t);
      const float need = fminf(fmaxf(required - n, 0.f), demand);
      const float spawn_tier = has_snap > 0.f ? T_SNAP
          : ((img_cache > 0.f && img > 0.f) ? T_IMG : T_DEAD);
      spawn_cost = select5(pr, spawn_tier);
      float cum = 0.f;
      for (int w = 0; w < W; ++w) {
        const float cap = fmaxf(floorf(free_s[w] / mem1), 0.f);
        cum = cum + cap;
        const float take = fminf(fmaxf(need - (cum - cap), 0.f), cap);
        my_tk[w] = take;
        any_take |= take > 0.f;
      }
    }
    float granted = 0.f;
    if (__syncthreads_or(any_take)) {
      if (is_w) {                      // proportional scale-back per worker
        float used = 0.f;
        for (int f = 0; f < F; ++f) used += tk[f * WS + tid] * mem_s[f];
        const float fw = free_s[tid];
        const float scale = used > fw ? fw / fmaxf(used, 1e-9f) : 1.f;
        float s = 0.f;
        for (int f = 0; f < F; ++f) s += (tk[f * WS + tid] * scale) * mem_s[f];
        scale_s[tid] = scale;
        free_s[tid] = fw - s;
      }
      __syncthreads();
      if (is_f)
        for (int w = 0; w < W; ++w) {
          my_tk[w] = my_tk[w] * scale_s[w];
          granted += my_tk[w];
        }
    }

    // ---- 3. serve queued + fresh demand ---- //
    bool any_delta = false;
    float nonidle = 0.f;
    if (is_f) {
      has_snap = fmaxf(has_snap, (granted > 0.f ? 1.f : 0.f) * snapshot);
      img = fmaxf(img, granted > 0.f ? 1.f : 0.f);
      const float ratio = dt > 0.f ? dt_eff / dt : 0.f;
      const float capacity = floorf((n + granted) * svc * ratio);
      const float served = fminf(demand, capacity);
      const bool cohort_demoted = (tier < T_WARM) && (n > 0.f);
      const float used = fminf(fmaxf(fmaxf(ceilf(served * exec_s / dt_pos), c_t), 1.f),
                               fmaxf(n, 1.f));
      const float promoted = cohort_demoted ? fminf(served, used) : 0.f;
      const float cold_spawn = fminf(granted, served - promoted);
      const float warm = served - promoted - cold_spawn;
      const float prom_cost = select5(pr, tier);
      const bool restore = cohort_demoted && (served > 0.f);
      const float res_now = mem * select5(fr, tier);
      const bool decaying = !cohort_demoted && (served > 0.f) && (n > 0.f);
      const float surplus = fmaxf(n - used, 0.f);
      const float decay = surplus * fminf(dt_eff / fmaxf(d0, 1e-9f), 1.f);
      const float n1 = fmaxf(n, 1.f);
      const float keep = (restore && n > 0.f) ? used / n1
          : (decaying ? 1.f - decay / n1 : 1.f);
      const float delta = (restore ? keep * (mem - res_now) : 0.f) - (1.f - keep) * res_now;
      vec[tid] = delta;
      any_delta = delta != 0.f;
      const float drop = 1.f - keep;
      for (int w = 0; w < W; ++w) my_tk[w] = (my[w] + my_tk[w]) - my[w] * drop;
      tier = restore ? T_WARM : tier;

      const float leftover = demand - served;
      const float busy_warm = warm * (exec_s + sanitize);
      const float wait = leftover * dt_eff;
      acc[AG_PROMOTIONS] += promoted;
      acc[AG_REQUESTS] += served;
      acc[AG_COLD] += promoted + cold_spawn;
      acc[AG_WARM] += warm;
      acc[AG_LAUNCHED] += granted;
      acc[AG_LAT_SUM] += busy_warm + promoted * (prom_cost + exec_s)
          + cold_spawn * (spawn_cost + exec_s);
      acc[AG_QWAIT_SUM] += wait;
      acc[AG_LAT_SUM] += wait;
      acc[AG_EXEC_GB_S] += (busy_warm + (promoted + cold_spawn) * exec_s) * exec_gb;

      // any activity re-arms the cohort at the top of its schedule
      const bool hit = (served + granted) > 0.f;
      edge = hit ? 0.f : edge;
      deadline = hit ? now + exec_s + d0 : deadline;
      tier = hit ? T_WARM : tier;
      queued = leftover;
      nonidle = busy_warm + promoted * (exec_s + prom_cost) + cold_spawn * (exec_s + spawn_cost);
    }
    if (__syncthreads_or(any_delta)) {
      if (is_w) {                      // footprint change of promoted / retired containers
        float s = 0.f;
        for (int f = 0; f < F; ++f) s += nw[f * WS + tid] * vec[f];
        free_s[tid] = free_s[tid] - s;
      }
      __syncthreads();
    }

    // ---- 4. idle GB-s at the cohort's tier footprint ---- //
    if (is_f) {
      float n_new = 0.f;
      for (int w = 0; w < W; ++w) {
        my[w] = my_tk[w];
        n_new += my[w];
      }
      const float idle_gb = fmaxf(n_new * dt_eff - nonidle, 0.f) * mem_gb * select5(fr, tier);
      if (EX) idle_sum += idle_gb;
      if (tier == T_WARM) acc[AG_IDLE_WARM] += idle_gb;
      else if (tier == T_PAUSED) acc[AG_IDLE_PAUSED] += idle_gb;
      else if (tier == T_SNAP) acc[AG_IDLE_SNAP] += idle_gb;
    }
  }

  __syncthreads();
  if (is_f) {
    for (int w = 0; w < W; ++w) nw_out[cf * W + w] = my[w];
    float* s = fs_out + cf * FS_N;
    s[FS_TIER] = tier;
    s[FS_EDGE] = edge;
    s[FS_DEADLINE] = deadline;
    s[FS_QUEUED] = queued;
    s[FS_HAS_SNAP] = has_snap;
    s[FS_IMG] = img;
#pragma unroll
    for (int a = 0; a < AG_N; ++a) red[a * F + tid] = acc[a];
    if (EX) {
      extras_out[(static_cast<size_t>(c) * 2 + 0) * F + tid] = acc[AG_COLD];
      extras_out[(static_cast<size_t>(c) * 2 + 1) * F + tid] = idle_sum;
    }
  }
  if (is_w) free_out[static_cast<size_t>(c) * W + tid] = free_s[tid];
  __syncthreads();
  if (tid < AG_N) {
    float s = 0.f;
    for (int f = 0; f < F; ++f) s += red[tid * F + f];
    agg_out[static_cast<size_t>(c) * AG_N + tid] = s;
  }
}

// Dynamic shared memory of the block kernel for F functions and W workers.
long long block_smem_bytes(int F, int W) {
  const long long ws = W | 1;
  return static_cast<long long>(sizeof(float)) *
         (2 * static_cast<long long>(F) * ws + 2LL * W + 2LL * F + static_cast<long long>(AG_N) * F);
}

struct Args {
  const float *nw, *fs, *free_mb, *arrivals, *conc, *fparam, *promote, *dwell, *ntier, *frac, *scal;
  float *nw_out, *fs_out, *free_out, *agg_out, *extras_out;
  int t_begin;
};

template <int FPL, int WM, int KM, bool EX>
int launch_warp(const Args& a, int C, int F, int W, int K, int T, cudaStream_t stream) {
  const long long smem = warp_smem_bytes(F, W);
  cudaError_t err = cudaFuncSetAttribute(cluster_warp_kernel<FPL, WM, KM, EX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cluster_warp_kernel<FPL, WM, KM, EX><<<C, 32, static_cast<size_t>(smem), stream>>>(
      a.nw, a.fs, a.free_mb, a.arrivals, a.conc, a.fparam, a.promote, a.dwell, a.ntier,
      a.frac, a.scal, a.nw_out, a.fs_out, a.free_out, a.agg_out, a.extras_out, F, W, K, T,
      a.t_begin);
  return static_cast<int>(cudaGetLastError());
}

// the extras-free kernels (the sweep's) are separate instantiations, so the
// extras cost the sweep nothing
template <int FPL, int WM, int KM>
int launch_warp_x(const Args& a, int C, int F, int W, int K, int T, cudaStream_t stream) {
  return a.extras_out ? launch_warp<FPL, WM, KM, true>(a, C, F, W, K, T, stream)
                      : launch_warp<FPL, WM, KM, false>(a, C, F, W, K, T, stream);
}

template <int FPL, int WM>
int launch_warp_k(const Args& a, int C, int F, int W, int K, int T, cudaStream_t stream) {
  return K <= 4 ? launch_warp_x<FPL, WM, 4>(a, C, F, W, K, T, stream)
                : launch_warp_x<FPL, WM, 8>(a, C, F, W, K, T, stream);
}

template <int FPL>
int launch_warp_w(const Args& a, int C, int F, int W, int K, int T, cudaStream_t stream) {
  return W <= 4 ? launch_warp_k<FPL, 4>(a, C, F, W, K, T, stream)
                : launch_warp_k<FPL, 8>(a, C, F, W, K, T, stream);
}

template <bool EX>
int launch_block(const Args& a, int C, int F, int W, int K, int T, cudaStream_t stream) {
  int threads = F > W ? F : W;
  threads = threads > AG_N ? threads : AG_N;
  threads = (threads + 31) / 32 * 32;
  if (threads > MAX_THREADS) return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = block_smem_bytes(F, W);
  cudaError_t err = cudaFuncSetAttribute(
      cluster_block_kernel<EX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cluster_block_kernel<EX><<<C, threads, static_cast<size_t>(smem), stream>>>(
      a.nw, a.fs, a.free_mb, a.arrivals, a.conc, a.fparam, a.promote, a.dwell, a.ntier,
      a.frac, a.scal, a.nw_out, a.fs_out, a.free_out, a.agg_out, a.extras_out, F, W, K, T,
      a.t_begin);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns the CUDA error of the launch (0 on success).  All arrays float32,
// contiguous: nw (C,F,W), fs (C,F,6), free (C,W), arrivals / conc (C,T,F),
// fparam / promote (C,F,5), dwell / ntier (C,F,K), frac (C,5), scal (C,5);
// outputs nw_out (C,F,W), fs_out (C,F,6), free_out (C,W), agg_out (C,12) and,
// unless extras_out is null, extras_out (C,2,F): per function, cold starts
// and idle GB-s summed over the launch's steps.  Step t of the launch runs at
// now = float(t_begin + t) * dt.  layout 0: the warp kernel (F <= 64, W <= 8,
// K <= 8); 1: the block kernel (repro_torch/kernels/cluster_step.py::layout
// picks).
int cluster_step_fwd(const void* nw, const void* fs, const void* free_mb,
                     const void* arrivals, const void* conc, const void* fparam,
                     const void* promote, const void* dwell, const void* ntier,
                     const void* frac, const void* scal, void* nw_out,
                     void* fs_out, void* free_out, void* agg_out, void* extras_out,
                     int C, int F, int W, int K, int T, int t_begin, int layout,
                     void* stream) {
  if (C < 1 || F < 1 || W < 1 || K < 1 || T < 0 || t_begin < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(nw), static_cast<const float*>(fs),
               static_cast<const float*>(free_mb), static_cast<const float*>(arrivals),
               static_cast<const float*>(conc), static_cast<const float*>(fparam),
               static_cast<const float*>(promote), static_cast<const float*>(dwell),
               static_cast<const float*>(ntier), static_cast<const float*>(frac),
               static_cast<const float*>(scal), static_cast<float*>(nw_out),
               static_cast<float*>(fs_out), static_cast<float*>(free_out),
               static_cast<float*>(agg_out), static_cast<float*>(extras_out), t_begin};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (layout == 1)
    return extras_out ? launch_block<true>(a, C, F, W, K, T, st)
                      : launch_block<false>(a, C, F, W, K, T, st);
  if (layout != 0 || F > WARP_MAX_F || W > WARP_MAX_W || K > WARP_MAX_K)
    return static_cast<int>(cudaErrorInvalidValue);
  return F <= 32 ? launch_warp_w<1>(a, C, F, W, K, T, st)
                 : launch_warp_w<2>(a, C, F, W, K, T, st);
}

const char* cluster_step_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
