"""StarCoder2-15B [arXiv:2402.19173] — dense, GQA(kv=4), RoPE.

40L d_model=6144 48H (kv=4) d_ff=24576 vocab=49152. StarCoder2 uses
LayerNorm + GELU MLP and learned+rope positions; we follow the paper's
GQA/RoPE description.
"""
from repro_torch.config import ModelConfig, reduced

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    source="arXiv:2402.19173",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=4,
    d_ff=24576,
    vocab_size=49152,
    norm="layernorm",
    act="gelu",
    rope_theta=100_000.0,
)
SMOKE = reduced(CONFIG)
