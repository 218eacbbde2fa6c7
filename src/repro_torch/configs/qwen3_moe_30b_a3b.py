"""Qwen3-30B-A3B [hf:Qwen/Qwen3-30B-A3B] — MoE, 128 experts top-8.

48L d_model=2048 32H (kv=4, head_dim=128) expert_ff=768 vocab=151936.
Every layer is MoE (no shared dense FFN).
"""
from repro_torch.config import ModelConfig, MoEConfig, reduced

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    source="hf:Qwen/Qwen3-30B-A3B",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=0,           # FFN is always routed
    vocab_size=151936,
    rope_theta=1_000_000.0,
    moe=MoEConfig(num_experts=128, top_k=8, expert_ff=768, every_n_layers=1),
)
SMOKE = reduced(CONFIG)
