"""Qwen2.5-14B [hf:Qwen/Qwen2.5-0.5B family] — dense, GQA(kv=8), QKV bias.

48L d_model=5120 40H (kv=8) d_ff=13824 vocab=152064.
"""
from repro_torch.config import ModelConfig, reduced

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    family="dense",
    source="hf:Qwen/Qwen2.5-0.5B (model card family)",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=13824,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
)
SMOKE = reduced(CONFIG)
