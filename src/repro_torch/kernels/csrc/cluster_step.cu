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
// Design.  One block per cell runs the whole T loop; the chunk axis of the
// TPU kernel becomes that loop.  Thread f owns function f: its six FS
// scalars, its FP columns and its promote row stay in registers, and its
// dwell / ntier rows are read through the read-only cache.  nw[F, W] (odd
// row stride, so that thread f walking its row is free of bank conflicts)
// and free[W] live in dynamic shared memory for the whole run.
//   * Sums within a row (nw.sum over w, the cumsum of cap_w, granted) are
//     taken by thread f over w in index order.
//   * Sums across functions (the free updates, used_w, scale) are taken by
//     thread w over f in index order.  The order is fixed: no atomics.
//   * agg is a per-thread running sum over t, reduced over f once at the
//     end.  This sums over t before f, where the reference sums over f
//     before t; both are float32 and agree within the reference's own
//     tolerance (rtol 1e-4, atol 1e-2).
//   * A worker pass is skipped when no function has anything for it (no
//     edge fired, nothing taken, no footprint change): the pass would
//     subtract exact zeros.  An expiry walk stops at the first edge where
//     nothing fires, since every later edge would be the identity too.
//   * Steps past the horizon (dt_eff == 0) only queue their arrivals, as
//     the reference's arithmetic does there; they need no barrier.
//   * arrivals / conc of step t: thread f reads its own entry, coalesced
//     across f.
// Built with -fmad=false and IEEE division (no --use_fast_math): the plain
// version rounds every product and quotient, and near-integer values feed
// ceil / floor (Little's law, floor(free / mem), the capacity), where one
// contracted FMA can flip a count and compound over a thousand steps.
//
// What bounds it on the card: the T-step dependency chain, i.e. latency and
// __syncthreads, not bytes.  At batch_dense64 (C 64, F 20, W 4, T 1280) it
// reads about 13 MB of arrivals and conc, which is about 4 us at 3.35 TB/s,
// and runs 64 blocks on 132 SMs with one warp each.  A later step: prefetch
// the arrivals and conc of the next steps with cp.async or TMA so that no
// step waits on a global load, and, when C is small, put several cells on
// one SM or split F across warps.
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
constexpr int MAX_THREADS = 512;   // 128 registers a thread: no spills

// table[idx] for an integral idx in [0, 5), else 0: the reference's one-hot
// select (_tier_select / _frac_at / _pick) over a row held in registers.
__device__ __forceinline__ float select5(const float (&row)[N_TIERS], float idx) {
  float out = 0.f;
#pragma unroll
  for (int t = 0; t < N_TIERS; ++t) out = (idx == static_cast<float>(t)) ? row[t] : out;
  return out;
}

// The same select over a row of K entries in device memory.
__device__ __forceinline__ float select_row(const float* __restrict__ row, int k, float idx) {
  if (idx >= 0.f && idx < static_cast<float>(k) && idx == floorf(idx))
    return __ldg(row + static_cast<int>(idx));
  return 0.f;
}

__global__ void __launch_bounds__(MAX_THREADS)
cluster_kernel(const float* __restrict__ nw0, const float* __restrict__ fs0,
               const float* __restrict__ free0, const float* __restrict__ arrivals,
               const float* __restrict__ conc, const float* __restrict__ fparam,
               const float* __restrict__ promote, const float* __restrict__ dwell,
               const float* __restrict__ ntier, const float* __restrict__ frac,
               const float* __restrict__ scal, float* __restrict__ nw_out,
               float* __restrict__ fs_out, float* __restrict__ free_out,
               float* __restrict__ agg_out, int F, int W, int K, int T) {
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
  __syncthreads();

  const float* arr_c = arrivals + static_cast<size_t>(c) * T * F;
  const float* conc_c = conc + static_cast<size_t>(c) * T * F;
  const float mem1 = fmaxf(mem, 1.f);

  for (int t = 0; t < T; ++t) {
    const float now = static_cast<float>(t) * dt;
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
  }
  if (is_w) free_out[static_cast<size_t>(c) * W + tid] = free_s[tid];
  __syncthreads();
  if (tid < AG_N) {
    float s = 0.f;
    for (int f = 0; f < F; ++f) s += red[tid * F + f];
    agg_out[static_cast<size_t>(c) * AG_N + tid] = s;
  }
}

// Dynamic shared memory one block needs for F functions and W workers
// (repro_torch/kernels/cluster_step.py::smem_bytes checks it before a launch).
long long smem_bytes(int F, int W) {
  const long long ws = W | 1;
  return static_cast<long long>(sizeof(float)) *
         (2 * static_cast<long long>(F) * ws + 2LL * W + 2LL * F + static_cast<long long>(AG_N) * F);
}

}  // namespace

extern "C" {

// Returns the CUDA error of the launch (0 on success).  All arrays float32,
// contiguous: nw (C,F,W), fs (C,F,6), free (C,W), arrivals / conc (C,T,F),
// fparam / promote (C,F,5), dwell / ntier (C,F,K), frac (C,5), scal (C,5);
// outputs nw_out (C,F,W), fs_out (C,F,6), free_out (C,W), agg_out (C,12).
int cluster_step_fwd(const void* nw, const void* fs, const void* free_mb,
                     const void* arrivals, const void* conc, const void* fparam,
                     const void* promote, const void* dwell, const void* ntier,
                     const void* frac, const void* scal, void* nw_out,
                     void* fs_out, void* free_out, void* agg_out, int C, int F,
                     int W, int K, int T, void* stream) {
  if (C < 1 || F < 1 || W < 1 || K < 1 || T < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int threads = F > W ? F : W;
  threads = threads > AG_N ? threads : AG_N;
  threads = (threads + 31) / 32 * 32;
  if (threads > MAX_THREADS) return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = smem_bytes(F, W);
  cudaError_t err = cudaFuncSetAttribute(
      cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cluster_kernel<<<C, threads, static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(nw), static_cast<const float*>(fs),
      static_cast<const float*>(free_mb), static_cast<const float*>(arrivals),
      static_cast<const float*>(conc), static_cast<const float*>(fparam),
      static_cast<const float*>(promote), static_cast<const float*>(dwell),
      static_cast<const float*>(ntier), static_cast<const float*>(frac),
      static_cast<const float*>(scal), static_cast<float*>(nw_out),
      static_cast<float*>(fs_out), static_cast<float*>(free_out),
      static_cast<float*>(agg_out), F, W, K, T);
  return static_cast<int>(cudaGetLastError());
}

const char* cluster_step_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
