"""Markov-chain inter-arrival predictor (HotC: exponential smoothing +
Markov chain over discretised gap buckets)."""
from __future__ import annotations

from typing import Optional

import numpy as np


class MarkovPredictor:
    name = "markov"

    def __init__(self, num_buckets: int = 32, t_min: float = 0.05,
                 t_max: float = 3600.0):
        self.edges = np.geomspace(t_min, t_max, num_buckets - 1)
        self.n = num_buckets
        self.counts = np.full((num_buckets, num_buckets), 0.1)  # weak prior
        self.last_bucket: Optional[int] = None
        self.last_t: Optional[float] = None
        self.centers = np.concatenate([
            [t_min / 2],
            np.sqrt(self.edges[:-1] * self.edges[1:]),
            [t_max],
        ])

    def _bucket(self, gap: float) -> int:
        return int(np.searchsorted(self.edges, gap))

    def observe(self, t: float) -> None:
        if self.last_t is not None:
            b = self._bucket(t - self.last_t)
            if self.last_bucket is not None:
                self.counts[self.last_bucket, b] += 1
            self.last_bucket = b
        self.last_t = t

    def predict_next(self) -> Optional[float]:
        if self.last_bucket is None or self.last_t is None:
            return None
        # modal bucket (the mean is hopeless here: even a weak prior spread
        # over log-spaced buckets puts mass on hour-scale centers)
        row = self.counts[self.last_bucket]
        return self.last_t + float(self.centers[int(np.argmax(row))])

    def uncertainty(self) -> float:
        if self.last_bucket is None:
            return float("inf")
        row = self.counts[self.last_bucket]
        probs = row / row.sum()
        mean = probs @ self.centers
        var = probs @ (self.centers - mean) ** 2
        return float(var ** 0.5)
