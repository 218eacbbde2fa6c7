"""Naive torch oracles for the hand kernels (the port of
``repro.kernels.ref``: attention, the cluster step and the selective scan).

Deliberately naive (O(S^2) score materialisation, repeated kv heads, a
one-hot select per table lookup, a step-by-step scan): they are the
correctness reference that the plain versions and the hand kernels are held
against.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def _gqa_expand(k, num_q_heads):
    """(B, S, Hkv, D) -> (B, S, Hq, D) by repeating kv heads."""
    rep = num_q_heads // k.shape[2]
    return torch.repeat_interleave(k, rep, dim=2)


def attention_mask(q_pos, kv_pos, *, causal: bool, window: Optional[int]):
    """(Sq, Skv) boolean mask from absolute positions."""
    m = torch.ones((q_pos.shape[0], kv_pos.shape[0]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= kv_pos[None, :] <= q_pos[:, None]
    if window is not None:
        m &= kv_pos[None, :] > (q_pos[:, None] - window)
    return m


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None,
                        q_pos=None, kv_pos=None):
    """Naive attention oracle.

    q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D) with Hq % Hkv == 0.
    Returns (B, Sq, Hq, D) in q.dtype; softmax in fp32.
    """
    b, sq, hq, d = q.shape
    skv = k.shape[1]
    if q_pos is None:
        q_pos = torch.arange(sq, device=q.device) + (skv - sq)
    if kv_pos is None:
        kv_pos = torch.arange(skv, device=q.device)
    k = _gqa_expand(k, hq)
    v = _gqa_expand(v, hq)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(d)
    mask = attention_mask(q_pos, kv_pos, causal=causal, window=window)
    scores = torch.where(mask[None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype)


def decode_attention_ref(q, k_cache, v_cache, valid_mask, *, stats: bool = False):
    """Single-token decode oracle.

    q: (B, Hq, D); caches: (B, S, Hkv, D); valid_mask: (B, S) bool.
    Returns (B, Hq, D); with ``stats`` the fp32 output, each row's max score
    and its sum of exponentials, as ``decode_attention_plain`` gives them.
    """
    b, hq, d = q.shape
    k = _gqa_expand(k_cache, hq)
    v = _gqa_expand(v_cache, hq)
    scores = torch.einsum("bhd,bshd->bhs", q.float(), k.float()) / math.sqrt(d)
    scores = torch.where(valid_mask[:, None, :], scores, NEG_INF)
    if stats:
        m = scores.amax(dim=-1, keepdim=True)
        p = torch.exp(scores - m)
        l = p.sum(dim=-1)
        return torch.einsum("bhs,bshd->bhd", p, v.float()) / l[..., None], m[..., 0], l
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhs,bshd->bhd", probs, v.float())
    return out.to(q.dtype)


# --------------------------------------------------------------------------- #
# batched cold-start cluster step (the batch simulator's physics)
# --------------------------------------------------------------------------- #
# Array-form mirror of one ``ClusterState`` cell for the fixed-timestep
# batch driver (``repro_torch.core.batchsim``).  Containers of one function
# are collapsed into a *cohort*: one count per (function, worker), one warmth
# tier / schedule edge / demotion deadline per function.  All layout
# constants live here so the hand kernel (``kernels/csrc/cluster_step.cu``),
# the table builder, and the tests agree on column meanings.
#
# state (per cell, float32 throughout — tiers/edges are small exact ints):
#   nw   [F, W]   resident containers of function f on worker w
#   fs   [F, 6]   per-function cohort scalars (FS_* columns)
#   free [W]      free memory per worker, MB
# static tables (per cell):
#   fparam  [F, 5]   FP_* columns (mem MB, exec s, GB billed per
#                    execution-second, requests servable per container
#                    per dt, mem GB)
#   promote [F, 5]   seconds to bring a container to serving from tier t
#   dwell   [F, K]   demotion-schedule dwell seconds (inf-padded)
#   ntier   [F, K]   demotion-schedule target tier (DEAD-padded)
#   frac    [5]      resident-footprint fraction per tier
#   scal    [SC_N]   cell scalars (SC_* columns)
# aggregates (one [AG_N] vector per cell, summed over steps):
#   counts + QoS sums that reconstruct into a ledger summary
#
# Unlike the reference, which writes one cell and vmaps it, the torch step
# below carries a leading cell axis [C] on every argument.

FS_TIER, FS_EDGE, FS_DEADLINE, FS_QUEUED, FS_HAS_SNAP, FS_IMG = range(6)
FS_N = 6
FP_MEM_MB, FP_EXEC_S, FP_EXEC_GB, FP_SVC, FP_MEM_GB = range(5)
FP_N = 5
SC_DT, SC_HORIZON, SC_IMG_CACHE, SC_SNAPSHOT, SC_SANITIZE_S = range(5)
SC_N = 5
(AG_REQUESTS, AG_COLD, AG_WARM, AG_LAUNCHED, AG_PROMOTIONS, AG_DEMOTIONS,
 AG_LAT_SUM, AG_QWAIT_SUM, AG_EXEC_GB_S, AG_IDLE_WARM, AG_IDLE_PAUSED,
 AG_IDLE_SNAP) = range(12)
AG_N = 12

# WarmthTier ordinals as floats (DEAD < IMG_CACHED < SNAPSHOT_READY <
# PAUSED < WARM_IDLE, matching repro_torch.core.lifecycle.WarmthTier)
T_DEAD, T_IMG, T_SNAP, T_PAUSED, T_WARM = 0.0, 1.0, 2.0, 3.0, 4.0
N_TIERS = 5
BIG_TIME = 1e30               # "never" deadline (inf-like, finite for f32)


def _tier_select(table, tier):
    """``table[c, f, tier[c, f]]``; an index that is out of range or not
    integral selects 0, as the reference's one-hot select does (whose sum
    of the picked entry and zeros is that entry exactly)."""
    idx = torch.clamp(tier, 0.0, float(table.shape[-1] - 1)).long()
    ok = idx.to(tier.dtype) == tier          # in range and integral
    picked = torch.gather(table, -1, idx[..., None])[..., 0]
    return torch.where(ok, picked, 0.0)


def _clip(x, lo, hi):
    """``jnp.clip``: ``minimum(maximum(x, lo), hi)``."""
    return torch.minimum(torch.maximum(x, torch.as_tensor(lo, dtype=x.dtype,
                                                          device=x.device)),
                         torch.as_tensor(hi, dtype=x.dtype, device=x.device))


def _ordered_sum(x, dim):
    """Sum along ``dim`` one slice at a time, in index order.

    The hand kernel takes every sum of the state this way (thread f over its
    row, thread w over the functions).  The plain version rounds as it does,
    so the two agree bit for bit in a contended step, where a different
    order can flip the floor of a near-integer free-memory quotient and the
    flip compounds over the following steps."""
    out = torch.zeros_like(x.select(dim, 0))
    for i in range(x.shape[dim]):
        out.add_(x.select(dim, i))
    return out


def _floor0(x):
    """``jnp.clip(x, 0.0, None)``."""
    return torch.clamp_min(x, 0.0)


def cluster_step_full(nw, fs, free, arrivals, conc, now, fparam, promote,
                      dwell, ntier, frac, scal):
    """One fixed-dt step of the batched cluster cohort model, every cell.

    nw (C, F, W); fs (C, F, FS_N); free (C, W); arrivals and conc (C, F);
    ``now`` a float or a (C,) tensor; fparam/promote (C, F, 5);
    dwell/ntier (C, F, K); frac (C, 5); scal (C, SC_N); all float32.

    Semantics per step, in order (mirroring the scalar simulator's
    dispatch; see docs/batchsim.md for the divergences):

      1. expiry walk — cohorts whose demotion deadline passed slide down
         their schedule (up to K edges per step), freeing/charging the
         per-tier footprint; DEAD edges destroy the cohort.
      2. spawn — a container serves one request at a time, so the cohort
         grows to cover this step's peak concurrency: ``conc`` (the
         host-precomputed max number of arrivals inside one exec window,
         exact from event timestamps) or the Little's-law floor
         ``demand * exec_s / dt``, whichever is larger.  New containers
         place first-fit across workers.
      3. serve — queued + new arrivals consume cohort capacity
         (``n * svc`` requests per step); demoted cohorts promote back to
         WARM_IDLE, their requests billed the promote latency and counted
         cold (matching the scalar ledger, where resumes are cold=True);
         leftovers stay queued and accrue wait.
      4. idle accounting — container-seconds not spent serving are billed
         GB-s at the cohort tier's footprint fraction.

    Returns ``(nw, fs, free, agg_delta[C, AG_N], extras)`` where ``extras``
    is a ``(cold[C, F], idle_gb[C, F])`` pair of *per-function* step
    deltas — the reward channels the RL gym consumes before they are summed
    into the cell aggregate.
    """
    f32 = torch.float32
    C, F, W = nw.shape
    K = dwell.shape[2]
    dev = nw.device
    now = torch.as_tensor(now, dtype=f32, device=dev).expand(C)[:, None]
    dt = scal[:, SC_DT][:, None]                                 # (C, 1)
    dt_eff = _clip(scal[:, SC_HORIZON][:, None] - now, 0.0, dt)  # (C, 1)
    active = dt_eff > 0.0
    frac_f = frac[:, None, :].expand(C, F, N_TIERS)

    tier = fs[..., FS_TIER]
    edge = fs[..., FS_EDGE]
    deadline = fs[..., FS_DEADLINE]
    queued = fs[..., FS_QUEUED]
    has_snap = fs[..., FS_HAS_SNAP]
    img = fs[..., FS_IMG]
    mem = fparam[..., FP_MEM_MB]
    exec_s = fparam[..., FP_EXEC_S]
    exec_gb = fparam[..., FP_EXEC_GB]
    svc = fparam[..., FP_SVC]
    mem_gb = fparam[..., FP_MEM_GB]
    agg = [torch.zeros(C, dtype=f32, device=dev) for _ in range(AG_N)]
    zero = torch.zeros((), dtype=f32, device=dev)

    # ---- 1. expiry walk (K unrolled edges; a zero dwell can cascade) ---- #
    # an edge where nothing fires leaves every array as it is, and so does
    # every later edge: the walk stops there, as the hand kernel's does
    for _ in range(K):
        n = _ordered_sum(nw, 2)
        edge_c = _clip(edge, 0.0, float(K - 1))
        tgt = _tier_select(ntier, edge_c)
        fire = (n > 0) & (deadline <= now) & active
        if not bool(fire.any()):
            break
        died = fire & (tgt == T_DEAD)
        demoted = fire & ~died
        old_res = mem * _tier_select(frac_f, tier)
        new_res = torch.where(died, zero, mem * _tier_select(frac_f, tgt))
        delta_mb = torch.where(fire, new_res - old_res, zero)
        free = free - _ordered_sum(nw * delta_mb[..., None], 1)
        agg[AG_DEMOTIONS] = agg[AG_DEMOTIONS] + (demoted * n).sum(dim=1)
        nw = torch.where(died[..., None], zero, nw)
        next_edge = _clip(edge + 1.0, 0.0, float(K - 1))
        nxt_dwell = _tier_select(dwell, next_edge)
        deadline = torch.where(demoted, now + nxt_dwell,
                               torch.where(died, torch.full_like(
                                   deadline, BIG_TIME), deadline))
        tier = torch.where(demoted, tgt, tier)
        has_snap = torch.maximum(has_snap,
                                 (demoted & (tgt == T_SNAP)).to(f32))
        edge = torch.where(fire, edge + 1.0, edge)

    # ---- 2. spawn to cover within-step concurrency ---- #
    # a container serves requests sequentially, so ``demand`` requests of
    # ``exec_s`` each need ~demand*exec_s/dt concurrent containers
    # (Little's law over the step) — the scalar sim spawns one container
    # per overlapping request; this is its fixed-dt analogue
    demand = queued + arrivals
    n = _ordered_sum(nw, 2)
    dt_pos = torch.clamp_min(dt_eff, 1e-9)
    required = torch.maximum(torch.ceil(demand * exec_s / dt_pos), conc)
    spawn_want = _clip(required - n, 0.0, demand)
    img_cache = (scal[:, SC_IMG_CACHE] > 0)[:, None]
    spawn_tier = torch.where(
        has_snap > 0, torch.full_like(tier, T_SNAP),
        torch.where(img_cache & (img > 0), torch.full_like(tier, T_IMG),
                    torch.full_like(tier, T_DEAD)))
    spawn_cost = _tier_select(promote, spawn_tier)

    # vectorized first-fit: every function packs against the CURRENT free
    # vector in parallel (exact whenever one function spawns per step —
    # the dominant case); if simultaneous spawners over-commit a worker,
    # their takes scale back proportionally so free never goes negative
    need = (spawn_want * active.to(f32))[..., None]              # (C, F, 1)
    cap_w = torch.clamp_min(torch.floor(
        free[:, None, :] / torch.clamp_min(mem, 1.0)[..., None]), 0.0)
    prior = torch.cumsum(cap_w, dim=2) - cap_w
    take = _clip(need - prior, 0.0, cap_w)                       # (C, F, W)
    used_w = _ordered_sum(take * mem[..., None], 1)              # (C, W)
    scale = torch.where(used_w > free,
                        free / torch.clamp_min(used_w, 1e-9),
                        torch.ones_like(free))
    take = take * scale[:, None, :]
    nw_pre = nw                       # resident counts before this spawn
    free = free - _ordered_sum(take * mem[..., None], 1)
    nw = nw + take
    granted = _ordered_sum(take, 2)
    has_snap = torch.maximum(has_snap,
                             (granted > 0) * scal[:, SC_SNAPSHOT][:, None])
    img = torch.maximum(img, (granted > 0).to(f32))

    # ---- 3. serve queued + fresh demand ---- #
    ratio = torch.where(dt > 0, dt_eff / dt, zero)
    capacity = torch.floor((n + granted) * svc * ratio)
    served = torch.minimum(demand, capacity)
    cohort_demoted = (tier < T_WARM) & (n > 0)
    # only as many containers promote as the step's concurrency needs;
    # the scalar leaves the rest at the demoted tier on their stale
    # deadlines (SPES-style short dwells then kill them before the next
    # burst), so the surplus retires here rather than re-arming
    used = _clip(torch.maximum(torch.ceil(served * exec_s / dt_pos), conc),
                 1.0, torch.clamp_min(n, 1.0))
    promoted_req = torch.where(cohort_demoted,
                               torch.minimum(served, used), zero)
    cold_spawn = torch.minimum(granted, served - promoted_req)
    warm_served = served - promoted_req - cold_spawn
    prom_cost = _tier_select(promote, tier)
    restore = cohort_demoted & (served > 0)
    res_now = mem * _tier_select(frac_f, tier)
    # serving re-arms the shared cohort deadline, which the per-container
    # scalar sim does only for the container that served: its surplus
    # siblings keep their own TTL clocks and die ~one warm dwell after
    # their last personal use.  Mimic that with an exponential retirement
    # of the surplus (n - used) at rate dt/warm_dwell whenever a warm
    # cohort serves
    d0 = dwell[..., 0]
    decaying = (~cohort_demoted) & (served > 0) & (n > 0)
    surplus = _floor0(n - used)
    decay = surplus * torch.clamp_max(dt_eff / torch.clamp_min(d0, 1e-9),
                                      1.0)
    n1 = torch.clamp_min(n, 1.0)
    keep = torch.where(restore & (n > 0), used / n1,
                       torch.where(decaying, 1.0 - decay / n1,
                                   torch.ones_like(n)))
    # promoted part re-inflates to full memory, surplus frees its
    # demoted footprint (spawns were already charged at placement)
    delta = torch.where(restore, keep * (mem - res_now), zero) \
        - (1.0 - keep) * res_now
    free = free - _ordered_sum(nw_pre * delta[..., None], 1)
    nw = nw - nw_pre * (1.0 - keep)[..., None]
    tier = torch.where(restore, torch.full_like(tier, T_WARM), tier)
    agg[AG_PROMOTIONS] = agg[AG_PROMOTIONS] + promoted_req.sum(dim=1)

    leftover = demand - served
    cold = promoted_req + cold_spawn
    sanitize = scal[:, SC_SANITIZE_S][:, None]
    agg[AG_REQUESTS] = agg[AG_REQUESTS] + served.sum(dim=1)
    agg[AG_COLD] = agg[AG_COLD] + cold.sum(dim=1)
    agg[AG_WARM] = agg[AG_WARM] + warm_served.sum(dim=1)
    agg[AG_LAUNCHED] = agg[AG_LAUNCHED] + granted.sum(dim=1)
    agg[AG_LAT_SUM] = agg[AG_LAT_SUM] + (
        warm_served * (exec_s + sanitize)
        + promoted_req * (prom_cost + exec_s)
        + cold_spawn * (spawn_cost + exec_s)).sum(dim=1)
    wait = leftover.sum(dim=1) * dt_eff[:, 0]
    agg[AG_QWAIT_SUM] = agg[AG_QWAIT_SUM] + wait
    agg[AG_LAT_SUM] = agg[AG_LAT_SUM] + wait
    agg[AG_EXEC_GB_S] = agg[AG_EXEC_GB_S] + (
        (warm_served * (exec_s + sanitize)
         + (promoted_req + cold_spawn) * exec_s) * exec_gb).sum(dim=1)

    # any activity re-arms the cohort at the top of its schedule
    active_f = (served + granted) > 0
    edge = torch.where(active_f, zero, edge)
    deadline = torch.where(active_f, now + exec_s + d0, deadline)
    tier = torch.where(active_f, torch.full_like(tier, T_WARM), tier)
    queued = leftover

    # ---- 4. idle GB-s at the cohort's tier footprint ---- #
    n = _ordered_sum(nw, 2)
    nonidle_s = (warm_served * (exec_s + sanitize)
                 + promoted_req * (exec_s + prom_cost)
                 + cold_spawn * (exec_s + spawn_cost))
    idle_cs = _floor0(n * dt_eff - nonidle_s)
    fr = _tier_select(frac_f, tier)
    idle_gb = idle_cs * mem_gb * fr
    agg[AG_IDLE_WARM] = agg[AG_IDLE_WARM] + (idle_gb * (tier == T_WARM)).sum(dim=1)
    agg[AG_IDLE_PAUSED] = agg[AG_IDLE_PAUSED] + (idle_gb * (tier == T_PAUSED)).sum(dim=1)
    agg[AG_IDLE_SNAP] = agg[AG_IDLE_SNAP] + (idle_gb * (tier == T_SNAP)).sum(dim=1)

    fs = torch.stack([tier, edge, deadline, queued, has_snap, img], dim=2)
    return nw, fs, free, torch.stack(agg, dim=1), (cold, idle_gb)


def cluster_step_ref(nw, fs, free, arrivals, conc, now, fparam, promote,
                     dwell, ntier, frac, scal):
    """Aggregate-only view of :func:`cluster_step_full` — the signature the
    batch driver and the hand kernel are parity-tested against."""
    nw, fs, free, agg, _ = cluster_step_full(
        nw, fs, free, arrivals, conc, now, fparam, promote, dwell, ntier,
        frac, scal)
    return nw, fs, free, agg


def ssm_scan_ref(u, delta, A, B, C, D, h0):
    """Mamba-1 selective-scan oracle (sequential over time, fp32 state).

    u, delta: (Batch, T, Din); A: (Din, N); B, C: (Batch, T, N); D: (Din,);
    h0: (Batch, Din, N).  Returns (y (Batch, T, Din) in u's dtype, hT fp32).
    Discretisation: h_t = exp(delta_t * A) * h_{t-1} + delta_t * B_t * u_t.
    """
    uf, df, Af, Bf, Cf = (x.float() for x in (u, delta, A, B, C))
    h = h0.float()
    ys = []
    for t in range(u.shape[1]):
        d_t = df[:, t]
        decay = torch.exp(d_t[..., None] * Af[None])           # (Bt, Din, N)
        h = decay * h + (d_t * uf[:, t])[..., None] * Bf[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, Cf[:, t]))
    y = torch.stack(ys, dim=1) + uf * D.float()[None, None]
    return y.to(u.dtype), h
