"""Time-series predictors backing the AI/ML prewarm policies (§5.3.2,
ATOM/MASTER/Fifer/FaaStest/HotC lineage).

``LSTMPredictor`` and ``TransformerPredictor`` (the learned family) come
with the learned-predictor slice of the port (ROADMAP A4); asking for
either raises ``NotImplementedError`` until then."""
from repro_torch.core.predictors.ewma import EWMAPredictor, ExpSmoothingPredictor
from repro_torch.core.predictors.markov import MarkovPredictor
from repro_torch.core.predictors.histogram import HistogramPredictor


def learned_not_ported(what: str) -> str:
    """Why a learned predictor is refused: it is not ported yet."""
    return (f"{what} needs the learned predictors, which the PyTorch port "
            "does not have yet (ROADMAP A4); run this suite with the JAX "
            "package or pick a classical suite")


__all__ = ["EWMAPredictor", "ExpSmoothingPredictor", "MarkovPredictor",
           "HistogramPredictor"]


def __getattr__(name):
    if name in ("LSTMPredictor", "TransformerPredictor"):
        raise NotImplementedError(learned_not_ported(name))
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
