"""Tabular Q-learning keep-alive agent (Agarwal et al. CCGrid'21 /
Vahidinia et al. IoT-J'22 lineage: RL decides how long to keep containers
warm, trading idle cost against cold-start cost).

State: discretised time-since-last-invocation bucket for the function.
Action: keep-warm duration from a small menu (0 = release now).
Reward: -(idle GB-s cost) - (cold-start penalty if the next invocation
misses the warm window).  Updated online by the simulator when outcomes
resolve.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

ACTIONS = (0.0, 30.0, 120.0, 600.0, 1800.0)


class QKeepAliveAgent:
    name = "q_keepalive"

    def __init__(self, *, lr: float = 0.2, gamma: float = 0.0,
                 eps: float = 0.15, idle_cost_per_s: float = 1.0,
                 cold_penalty: float = 100.0, seed: int = 0):
        self.lr, self.gamma, self.eps = lr, gamma, eps
        self.idle_cost_per_s = idle_cost_per_s
        self.cold_penalty = cold_penalty
        self.q: Dict[Tuple[int, int], float] = {}
        self.rng = np.random.default_rng(seed)
        self.buckets = np.array([1.0, 10.0, 60.0, 300.0, 1800.0])

    def _state(self, mean_gap: Optional[float]) -> int:
        if mean_gap is None:
            return len(self.buckets)
        return int(np.searchsorted(self.buckets, mean_gap))

    def choose_ttl(self, mean_gap: Optional[float]) -> Tuple[float, Tuple[int, int]]:
        s = self._state(mean_gap)
        if self.rng.random() < self.eps:
            a = int(self.rng.integers(len(ACTIONS)))
        else:
            vals = [self.q.get((s, i), 0.0) for i in range(len(ACTIONS))]
            a = int(np.argmax(vals))
        return ACTIONS[a], (s, a)

    def update(self, key: Tuple[int, int], *, idle_s: float, missed: bool):
        r = -self.idle_cost_per_s * idle_s - (self.cold_penalty if missed else 0.0)
        old = self.q.get(key, 0.0)
        self.q[key] = old + self.lr * (r - old)
