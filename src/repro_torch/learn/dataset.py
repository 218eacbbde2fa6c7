"""Batched training data for the gap forecaster.

``training_traces`` builds the default training mix straight from the
workload generators (cron_spikes regimes the eval cells draw from —
*different* seeds — plus azure_like and rare for generalization), every
seed derived from one master via ``derive_seed`` so the whole dataset is
a pure function of ``(master_seed, cfg)``.  ``build_examples`` windows
each function's arrival series (cohort-level padding + masking happens
inside :func:`repro_torch.learn.features.encode_window`); ``batches`` is the
deterministic infinite iterator ``training/train_loop.py`` consumes.
"""
from __future__ import annotations

from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.core.workload import ALL_GENERATORS, Trace
from repro_torch.experiments.spec import derive_seed
from repro_torch.learn.features import FeatureConfig, function_examples

# (label, generator, params) — seeds are derived per-label from the master
TRAIN_MIX: Tuple[Tuple[str, str, dict], ...] = (
    ("cron_mid_a", "cron_spikes", dict(horizon=18_000.0, num_functions=10,
                                       base_gap_s=240.0, spike_gap_s=75.0,
                                       spike_period_s=7200.0, jitter=0.04)),
    ("cron_mid_b", "cron_spikes", dict(horizon=18_000.0, num_functions=10,
                                       base_gap_s=240.0, spike_gap_s=75.0,
                                       spike_period_s=7200.0, jitter=0.06)),
    ("cron_sparse_a", "cron_spikes", dict(horizon=36_000.0, num_functions=8,
                                          base_gap_s=400.0, spike_gap_s=90.0,
                                          spike_period_s=14_400.0,
                                          jitter=0.04)),
    ("cron_sparse_b", "cron_spikes", dict(horizon=36_000.0, num_functions=8,
                                          base_gap_s=400.0, spike_gap_s=90.0,
                                          spike_period_s=14_400.0,
                                          jitter=0.06)),
    ("cron_fast", "cron_spikes", dict(horizon=9000.0, num_functions=8,
                                      base_gap_s=120.0, spike_gap_s=70.0,
                                      spike_period_s=3600.0, jitter=0.05)),
    ("azure_a", "azure_like", dict(horizon=900.0, num_functions=30)),
    ("azure_b", "azure_like", dict(horizon=900.0, num_functions=30)),
    ("rare_a", "rare", dict(inter_arrival=150.0, horizon=9000.0,
                            jitter=0.25, num_functions=6)),
    ("rare_b", "rare", dict(inter_arrival=400.0, horizon=24_000.0,
                            jitter=0.15, num_functions=6)),
)


def training_traces(master_seed: int = 7,
                    mix: Iterable[Tuple[str, str, dict]] = TRAIN_MIX
                    ) -> List[Trace]:
    return [ALL_GENERATORS[gen](seed=derive_seed(master_seed,
                                                 f"learn:{label}"), **params)
            for label, gen, params in mix]


def build_examples(traces: Iterable[Trace], cfg: FeatureConfig,
                   *, master_seed: int = 7) -> Dict[str, np.ndarray]:
    """Window every function of every trace and shuffle deterministically
    (one permutation derived from the master seed, so two builds from the
    same inputs are bit-identical)."""
    xs, ys = [], []
    for trace in traces:
        for fn in trace.functions:
            X, y = function_examples(trace.times_for(fn), cfg)
            if len(y):
                xs.append(X)
                ys.append(y)
    if not xs:
        return {"x": np.zeros((0, cfg.window, cfg.n_features), np.float32),
                "y": np.zeros((0,), np.float32)}
    x = np.concatenate(xs)
    y = np.concatenate(ys)
    perm = np.random.default_rng(
        derive_seed(master_seed, "learn:dataset")).permutation(len(y))
    return {"x": x[perm], "y": y[perm]}


def batches(examples: Dict[str, np.ndarray], batch_size: int,
            *, master_seed: int = 7,
            steps: Optional[int] = None) -> Iterator[Dict[str, np.ndarray]]:
    """Deterministic (infinite unless ``steps``) minibatch iterator."""
    n = len(examples["y"])
    if n == 0:
        raise ValueError("empty example set")
    rng = np.random.default_rng(derive_seed(master_seed, "learn:batches"))
    done = 0
    while steps is None or done < steps:
        idx = rng.integers(0, n, size=batch_size)
        yield {"x": examples["x"][idx], "y": examples["y"][idx]}
        done += 1
