"""The batch simulator as a vectorized RL environment for keep-alive
(port of ``repro.learn.gym``).

``BatchSimGym`` wraps a list of batch-supported scenarios (one *cell*
each) into a gym the DQN agent (``repro_torch.learn.agent``) steps in
epochs:

* **state** — the batch driver's array-state ``(nw, fs, free)`` plus the
  agent-side observables (time since last arrival, EMA inter-arrival
  gap), advanced ``epoch_steps`` fixed-``dt`` cluster steps per
  environment step.  On the card an epoch is ONE launch of the hand
  cluster-step kernel (``kernels/cluster_step.py``, ``t_begin`` the
  epoch's first step, ``extras=True`` for the reward channels); on the
  CPU it is the kernel's plain version, the same contract;
* **action** — a per-(cell, function) warm dwell in seconds, written
  into schedule slot 0 (``dwell[:, :, 0]``) for the epoch; the trained
  policy quantises to :data:`~repro_torch.core.predictors.rl.ACTIONS` but
  the gym accepts any dwell, which is how exported schedules are
  evaluated;
* **reward** — per (cell, function), summed over the epoch::

      r = -(cold_penalty * cold_starts + idle_cost_per_gb_s * idle_gb_s)

  read from the per-function extras of the epoch's launch.  With the
  defaults (1.0 / 0.05) a 1 GB function breaks even at a ~20 s gap.

Observations (``OBS_DIM`` per function): ``log1p`` time since last
arrival, ``log1p`` EMA gap, warmth tier / 4, ``log1p`` queued, and the
sin/cos wall-clock phase over :data:`PHASE_PERIOD_S`.  The time since the
last arrival, the EMA gap and the phase depend on the trace and the clock
only, never on state or action, so they are computed once, at
construction, in fp32 in the reference's order (``0.7 * ema + 0.3 * gap``,
updated where an arrival follows an earlier one) for every epoch boundary;
the tier and queue channels come from the state on the device.

Padded function rows (cells with fewer functions than the grid max)
never see arrivals and earn exactly zero reward; :attr:`valid_mask`
marks the real rows so the agent can drop the padding transitions.
"""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core.batchsim import DEFAULT_DT, build_tables
from repro_torch.core.predictors.rl import ACTIONS
from repro_torch.device import resolve_device
from repro_torch.kernels import ref as R
from repro_torch.kernels.cluster_step import cluster_sim_hopper

OBS_DIM = 6
PHASE_PERIOD_S = 3600.0
DEFAULT_COLD_PENALTY = 1.0
DEFAULT_IDLE_COST = 0.05          # per GB-s; break-even gap ~20 s at 1 GB


def training_scenarios(*, seeds: Sequence[int] = (1, 2, 3, 4),
                       num_functions: int = 12, horizon: float = 600.0):
    """The default training grid: azure_like cells under ``tiered_fixed``
    (batch-supported, full ladder shape) differing only by trace seed."""
    from repro_torch.experiments.spec import Scenario, WorkloadSpec
    return [
        Scenario(
            name=f"learn/gym/s{seed}",
            workload=WorkloadSpec("azure_like",
                                  {"horizon": horizon,
                                   "num_functions": num_functions},
                                  seed=seed),
            policy="tiered_fixed",
            description="RL keep-alive gym training cell")
        for seed in seeds]


class GymState(NamedTuple):
    """The environment state, all tensors: the cohort state on the gym's
    device, the epoch a CPU int64 scalar."""

    nw: torch.Tensor        # [C, F, W] resident containers
    fs: torch.Tensor        # [C, F, FS_N] cohort scalars
    free: torch.Tensor      # [C, W] free MB
    epoch: torch.Tensor     # scalar int64 (CPU)
    last_arr: torch.Tensor  # [C, F] last arrival time (-1 = never)
    ema_gap: torch.Tensor   # [C, F] EMA inter-arrival gap (0 = unknown)


def _trace_observables(arrivals: np.ndarray, dt: float, epoch_steps: int):
    """(last_arr, ema_gap, obs channels 0, 1, 4, 5) at every epoch boundary,
    (num_epochs + 1, C, F[, 4]), fp32, stepping the reference gym's update
    through every step of the padded ``arrivals`` (C, T, F)."""
    f32 = np.float32
    C, T, F = arrivals.shape
    E = epoch_steps
    dt32 = f32(dt)
    last = np.full((C, F), -1.0, f32)
    ema = np.zeros((C, F), f32)
    lasts, emas = [last.copy()], [ema.copy()]
    for t in range(T):
        now = f32(t) * dt32
        arrived = arrivals[:, t] > 0
        gap = now - last
        upd = np.where(ema > 0, f32(0.7) * ema + f32(0.3) * gap, gap)
        ema = np.where(arrived & (last >= 0), upd, ema).astype(f32)
        last = np.where(arrived, now, last).astype(f32)
        if (t + 1) % E == 0:
            lasts.append(last.copy())
            emas.append(ema.copy())
    lasts, emas = np.stack(lasts), np.stack(emas)
    nows = np.array([f32(e) * f32(E) * dt32 for e in range(len(lasts))], f32)
    now = nows[:, None, None]
    tsl = np.where(lasts >= 0, now - lasts, f32(1e6)).astype(f32)
    ph = (f32(2.0 * np.pi) * nows / f32(PHASE_PERIOD_S)).astype(f32)
    one = np.ones_like(tsl)
    chans = np.stack([np.log1p(np.clip(tsl, f32(0), f32(1e6))),
                      np.log1p(np.clip(emas, f32(0), f32(1e6))),
                      np.sin(ph)[:, None, None] * one,
                      np.cos(ph)[:, None, None] * one], axis=-1).astype(f32)
    return lasts, emas, chans


class BatchSimGym:
    def __init__(self, scenarios: Sequence, *, dt: float = DEFAULT_DT,
                 epoch_steps: int = 60,
                 cold_penalty: float = DEFAULT_COLD_PENALTY,
                 idle_cost_per_gb_s: float = DEFAULT_IDLE_COST,
                 actions: Sequence[float] = ACTIONS, device="cuda"):
        self.device = resolve_device(device)
        self.scenarios = list(scenarios)
        self.dt = dt
        self.epoch_steps = epoch_steps
        self.cold_penalty = cold_penalty
        self.idle_cost_per_gb_s = idle_cost_per_gb_s
        self.actions = tuple(float(a) for a in actions)

        cache: Dict[str, object] = {}

        def trace_fn(sc):
            if sc.name not in cache:
                cache[sc.name] = sc.trace()
            return cache[sc.name]

        self.tables = build_tables(self.scenarios, dt=dt, trace_fn=trace_fn,
                                   device=self.device)
        # build_tables collapses names to row indices; the exportable
        # schedule needs them back
        self.function_names: List[List[str]] = [
            list(trace_fn(sc).functions) for sc in self.scenarios]
        C, F, _ = self.tables.nw.shape
        self.C, self.F = C, F
        self.valid_mask = np.zeros((C, F), bool)
        for ci, names in enumerate(self.function_names):
            self.valid_mask[ci, :len(names)] = True

        # pad the time axis to whole epochs; trailing steps are past every
        # horizon and no-op inside the kernel (dt_eff == 0)
        T = self.tables.arrivals.shape[1]
        E = epoch_steps
        Tp = int(math.ceil(T / E)) * E
        arr, cnc = self.tables.arrivals, self.tables.conc
        if Tp > T:
            pad = ((0, 0), (0, Tp - T), (0, 0))
            arr, cnc = np.pad(arr, pad), np.pad(cnc, pad)
        self.num_epochs = Tp // E
        dev = self.device

        def epochs(a):
            """(C, Tp, F) -> (num_epochs, C, E, F): each epoch's window is a
            contiguous tensor, as the kernel takes it"""
            a = a.reshape(C, self.num_epochs, E, F).transpose(1, 0, 2, 3)
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        self._arrivals, self._conc = epochs(arr), epochs(cnc)

        def on(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        tb = self.tables
        self._static = [on(a) for a in (tb.fparam, tb.promote)]
        self._dwell0 = on(tb.dwell)
        self._tail = [on(a) for a in (tb.ntier, tb.frac, tb.scal)]
        self._init = [on(a) for a in (tb.nw, tb.fs, tb.free)]
        lasts, emas, chans = _trace_observables(arr, dt, E)
        self._last, self._ema = on(lasts), on(emas)
        self._obs_chans = on(chans)

    # ------------------------------------------------------------------ #
    def _obs(self, fs: torch.Tensor, e: int) -> torch.Tensor:
        ch = self._obs_chans[e]
        return torch.stack([ch[..., 0], ch[..., 1],
                            fs[:, :, R.FS_TIER] / 4.0,
                            torch.log1p(fs[:, :, R.FS_QUEUED]),
                            ch[..., 2], ch[..., 3]], dim=-1)

    def reset(self):
        """-> (state, obs[C, F, OBS_DIM])."""
        nw, fs, free = self._init
        state = GymState(nw, fs, free, torch.tensor(0, dtype=torch.int64),
                         self._last[0], self._ema[0])
        return state, self._obs(fs, 0)

    def launch_args(self, state: GymState, warm_s):
        """The cluster step's arguments for the epoch ``state`` is at (the
        kernel's order; the dwell a fresh tensor with slot 0 set to
        ``warm_s``) and the epoch's first step, ``t_begin``."""
        e = int(state.epoch)
        if not 0 <= e < self.num_epochs:
            raise ValueError(f"epoch {e} is outside the episode's {self.num_epochs}")
        dwell = self._dwell0.clone()
        dwell[:, :, 0] = torch.as_tensor(warm_s, dtype=torch.float32,
                                         device=self.device)
        args = (state.nw, state.fs, state.free, self._arrivals[e], self._conc[e],
                *self._static, dwell, *self._tail)
        return args, e * self.epoch_steps

    def step(self, state: GymState, warm_s):
        """Advance one epoch (one cluster-step launch on the card);
        ``warm_s`` is [C, F] dwell seconds.

        -> (state, obs, reward[C, F], (cold[C, F], idle_gb[C, F]))."""
        args, t_begin = self.launch_args(state, warm_s)
        nw, fs, free, _, ex = cluster_sim_hopper(*args, t_begin=t_begin, extras=True)
        cold, idle = ex[:, 0], ex[:, 1]
        reward = -(self.cold_penalty * cold + self.idle_cost_per_gb_s * idle)
        e1 = int(state.epoch) + 1
        state = GymState(nw, fs, free, torch.tensor(e1, dtype=torch.int64),
                         self._last[e1], self._ema[e1])
        return state, self._obs(fs, e1), reward, (cold, idle)

    def done(self, state: GymState) -> bool:
        return int(state.epoch) >= self.num_epochs

    # ------------------------------------------------------------------ #
    def warm_grid(self, warm_s: Dict[str, float],
                  default_s: float) -> np.ndarray:
        """Per-function schedule map -> the [C, F] dwell-seconds array the
        stepper consumes (padded rows get ``default_s``; harmless — they
        never see arrivals)."""
        out = np.full((self.C, self.F), float(default_s), np.float32)
        for ci, names in enumerate(self.function_names):
            for fi, name in enumerate(names):
                out[ci, fi] = float(warm_s.get(name, default_s))
        return out

    def evaluate(self, warm_s_grid: np.ndarray) -> Dict[str, float]:
        """Total episode return of a *fixed* dwell grid — the yardstick for
        exported schedules and fixed-TTL baselines alike.  Returns the
        summed reward plus its cold / idle components (valid rows only).
        The epochs run back to back on the device; their per-epoch arrays
        come to the host once, and are summed there in the reference's
        order."""
        grid = torch.as_tensor(np.asarray(warm_s_grid, np.float32),
                               device=self.device)
        mask = np.asarray(self.valid_mask, np.float32)
        state, _ = self.reset()
        per_epoch = []
        for _ in range(self.num_epochs):
            state, _, r, (c, g) = self.step(state, grid)
            per_epoch.append(torch.stack([r, c, g]))
        rcg = torch.stack(per_epoch).cpu().numpy()
        reward = cold = idle = 0.0
        for r, c, g in rcg:
            reward += float((r * mask).sum())
            cold += float((c * mask).sum())
            idle += float((g * mask).sum())
        return {"reward": reward, "cold_starts": cold, "idle_gb_s": idle}

    def baseline_rewards(self) -> Dict[float, Dict[str, float]]:
        """Every fixed action as a flat schedule — the table the DRL gate
        compares the exported schedule against."""
        return {a: self.evaluate(np.full((self.C, self.F), a, np.float32))
                for a in self.actions}
