"""H2O-Danube3-4B [arXiv:2401.16818] — dense llama/mistral mix with SWA.

24L d_model=3840 32H (kv=8) d_ff=10240 vocab=32000, sliding-window
attention (mistral-style, window 4096) which makes long_500k feasible.
"""
from repro_torch.config import ModelConfig, reduced

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    source="arXiv:2401.16818",
    num_layers=24,
    d_model=3840,
    num_heads=32,
    num_kv_heads=8,
    d_ff=10240,
    vocab_size=32000,
    sliding_window=4096,
)
SMOKE = reduced(CONFIG)
