"""repro_torch.learn — the ML-based cold-start mitigations on the port's
PyTorch stack (port of ``repro.learn``):

* a **transformer next-invocation-gap forecaster** (arXiv 2504.11338
  lineage): :mod:`features`/:mod:`dataset` window traces into batched
  examples, :mod:`forecaster` runs a small ``models/transformer.py`` stack
  (its attention through the hand flash kernel on the card) to predict gap
  quantiles, and ``core/predictors/transformer.py`` serves a checkpoint
  behind the same protocol as the histogram/LSTM predictors;
  ``forecaster.train_forecaster`` trains it through ``training/``;
* an **off-policy DQN keep-alive agent** (arXiv 2308.07541 lineage):
  :mod:`gym` exposes the batch simulator's cluster step as a vectorized
  [cells, functions] environment (one hand-kernel launch an epoch on the
  card) and :mod:`agent` trains a Q-network whose greedy policy exports to
  the static per-function schedules ``batchsim.static_schedules`` replays.
"""
from repro_torch.learn.features import FeatureConfig, encode_window, function_examples
from repro_torch.learn.dataset import batches, build_examples, training_traces

__all__ = ["FeatureConfig", "encode_window", "function_examples",
           "batches", "build_examples", "training_traces",
           "BatchSimGym", "training_scenarios", "train_agent",
           "export_schedule", "train_forecaster"]

_LAZY = {
    # torch-heavy modules stay off the package-import fast path
    "BatchSimGym": "repro_torch.learn.gym",
    "training_scenarios": "repro_torch.learn.gym",
    "train_agent": "repro_torch.learn.agent",
    "export_schedule": "repro_torch.learn.agent",
    "train_forecaster": "repro_torch.learn.forecaster",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module 'repro_torch.learn' has no attribute {name!r}")
