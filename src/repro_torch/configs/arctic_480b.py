"""Snowflake Arctic (480B) [hf:Snowflake/snowflake-arctic-base] — MoE,
128 experts top-2 PLUS a dense residual FFN branch (dense-MoE hybrid).

35L d_model=7168 56H (kv=8) expert_ff=4864 vocab=32000.
"""
from repro_torch.config import ModelConfig, MoEConfig, reduced

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    source="hf:Snowflake/snowflake-arctic-base",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    moe=MoEConfig(num_experts=128, top_k=2, expert_ff=4864, every_n_layers=1,
                  dense_residual=True, dense_residual_ff=4864),
)
SMOKE = reduced(CONFIG)
