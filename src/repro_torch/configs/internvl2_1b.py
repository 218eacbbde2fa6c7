"""InternVL2-1B [arXiv:2404.16821] — VLM: InternViT (stub) + Qwen2-0.5B LM.

LM backbone: 24L d_model=896 14H (kv=2) d_ff=4864 vocab=151655. The vision
encoder + MLP projector is a STUB per the assignment: ``input_specs()``
provides precomputed patch embeddings of shape (batch, 256, 896).
"""
from repro_torch.config import ModelConfig, VisionConfig, reduced

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    source="arXiv:2404.16821",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    vision=VisionConfig(num_image_tokens=256, d_embed=896),
)
SMOKE = reduced(CONFIG)
