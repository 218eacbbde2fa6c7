"""Time-series predictors backing the AI/ML prewarm policies (§5.3.2,
ATOM/MASTER/Fifer/FaaStest/HotC lineage).

``LSTMPredictor`` and ``TransformerPredictor`` (the learned family, torch
on a device) are resolved lazily — importing this package stays light."""
from repro_torch.core.predictors.ewma import EWMAPredictor, ExpSmoothingPredictor
from repro_torch.core.predictors.markov import MarkovPredictor
from repro_torch.core.predictors.histogram import HistogramPredictor

__all__ = ["EWMAPredictor", "ExpSmoothingPredictor", "MarkovPredictor",
           "HistogramPredictor", "LSTMPredictor", "TransformerPredictor"]


def __getattr__(name):
    if name == "LSTMPredictor":
        from repro_torch.core.predictors.lstm import LSTMPredictor
        return LSTMPredictor
    if name == "TransformerPredictor":
        from repro_torch.core.predictors.transformer import TransformerPredictor
        return TransformerPredictor
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
