"""Jamba-v0.1 (52B total) [arXiv:2403.19887] — hybrid Mamba+attention, MoE.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536; MoE 16 experts
top-2 on every other layer; attention : mamba = 1 : 7 (one attention layer
per 8-layer block). At the long_500k shape the attention layers run with a
4096 sliding window (standard Jamba long-context serving); this is applied
by the shape plumbing, not here.
"""
from repro_torch.config import ModelConfig, MoEConfig, SSMConfig, reduced

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    source="arXiv:2403.19887",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    # 8-layer Jamba block: attention at index 4 of each period, mamba elsewhere
    block_pattern="MMMMAMMM",
    moe=MoEConfig(num_experts=16, top_k=2, expert_ff=14336, every_n_layers=2),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
)
SMOKE = reduced(CONFIG)
