"""Serving side of the trained transformer gap forecaster (port of
``repro.core.predictors.transformer``).

``TransformerPredictor`` speaks the same protocol as
:class:`~repro_torch.core.predictors.histogram.HistogramPredictor`
(``observe`` / ``predict_next`` / ``window`` / ``uncertainty``) but reads
its (q05, q50, q95) next-gap quantiles from a forecaster checkpoint, so
every policy that consumes the histogram — ``PredictivePrewarm``,
``PredictiveLadder`` — can swap in the learned forecaster unchanged.

Two properties matter for simulator throughput:

* **one model per checkpoint and device** — params are cached
  module-wide, so thousands of per-function predictor instances share one
  set of weights;
* **lazy inference** — the forward runs at most once per *observation*
  (predictions are cached until the next arrival), never per policy tick.

On the card a prediction is one eager (1, window, features) forward: the
two layers' attention are two launches of the hand flash kernel, the rest
is plain torch; the reference's ``jax.jit`` of that forward has no
counterpart here.
"""
from __future__ import annotations

import warnings
from collections import deque
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device

# (path, device) -> (params, ModelConfig, FeatureConfig); shared by every
# predictor instance so the weights load once a device
_MODEL_CACHE: Dict[Tuple[str, str], tuple] = {}
_WARNED_FALLBACK = False


def _load(path: str, device: torch.device):
    key = (path, str(device))
    if key not in _MODEL_CACHE:
        from repro_torch.learn.forecaster import load_forecaster
        params, cfg, feat, _ = load_forecaster(path, device=device)
        _MODEL_CACHE[key] = (params, cfg, feat)
    return _MODEL_CACHE[key]


class TransformerPredictor:
    name = "transformer"

    def __init__(self, checkpoint: Optional[str] = None, *, device="cuda"):
        from repro_torch.learn.forecaster import resolve_checkpoint
        self.device = resolve_device(device)
        path = resolve_checkpoint(checkpoint)
        if path is None:
            raise FileNotFoundError(
                "no trained forecaster checkpoint (looked for "
                f"{checkpoint!r}, $REPRO_FORECASTER_CKPT, "
                "checkpoints/forecaster.npz)")
        self._params, self._cfg, self._feat = _load(path, self.device)
        W = self._feat.window
        self.gaps: deque = deque(maxlen=W)
        self.ends: deque = deque(maxlen=W)
        self.last_t: Optional[float] = None
        self._cached: Optional[Tuple[float, float, float]] = None

    def observe(self, t: float) -> None:
        if self.last_t is not None and t > self.last_t:
            self.gaps.append(t - self.last_t)
            self.ends.append(t)
            self._cached = None
        self.last_t = t

    # ------------------------------------------------------------------ #
    def _predict(self) -> Optional[Tuple[float, float, float]]:
        """(q05, q50, q95) *gap* quantiles in seconds, cached per arrival."""
        if self._cached is None:
            if not self.gaps:
                return None
            from repro_torch.learn.features import encode_window
            from repro_torch.learn.forecaster import apply_forecaster
            x = encode_window(list(self.gaps), list(self.ends), self._feat)[None]
            with torch.no_grad():
                q = apply_forecaster(self._params,
                                     torch.from_numpy(x).to(self.device),
                                     self._cfg)[0].cpu().numpy()
            g = np.expm1(np.clip(q, 0.0, self._feat.log_clip))
            g50 = max(float(g[1]), 1e-3)
            self._cached = (min(max(float(g[0]), 1e-3), g50), g50,
                            max(float(g[2]), g50))
        return self._cached

    def window(self) -> Optional[Tuple[float, float]]:
        """(prewarm_at, release_at) absolute times, or None."""
        p = self._predict()
        if p is None or self.last_t is None:
            return None
        return self.last_t + p[0], self.last_t + p[2]

    def predict_next(self) -> Optional[float]:
        p = self._predict()
        if p is None or self.last_t is None:
            return None
        return self.last_t + p[1]

    def uncertainty(self) -> float:
        p = self._predict()
        if p is None:
            return float("inf")
        return p[2] - p[0]


def transformer_or_fallback(checkpoint: Optional[str] = None, *,
                            device="cuda") -> Callable:
    """Predictor factory for the policy catalog: the trained forecaster on
    ``device`` when a checkpoint resolves, else ``HistogramPredictor`` with
    a one-time warning, so ``suite("prewarm_transformer")`` stays
    constructible (and CATALOG iterable) without a checkpoint."""
    from repro_torch.learn.forecaster import resolve_checkpoint
    path = resolve_checkpoint(checkpoint)
    if path is None:
        global _WARNED_FALLBACK
        if not _WARNED_FALLBACK:
            warnings.warn(
                "no trained forecaster checkpoint found; transformer "
                "suites fall back to HistogramPredictor")
            _WARNED_FALLBACK = True
        from repro_torch.core.predictors.histogram import HistogramPredictor
        return HistogramPredictor

    def factory():
        return TransformerPredictor(checkpoint=path, device=device)
    factory.name = TransformerPredictor.name
    return factory
