"""Whisper-large-v3 [arXiv:2212.04356] — encoder-decoder audio model.

32L decoder (and 32L encoder) d_model=1280 20H (kv=20 == MHA) d_ff=5120
vocab=51866.  The mel-spectrogram + conv feature extractor is a STUB per the
assignment: ``input_specs()`` provides (batch, 1500, 1280) frame embeddings.
"""
from repro_torch.config import ModelConfig, EncoderConfig, reduced

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    source="arXiv:2212.04356",
    num_layers=32,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    norm="layernorm",
    act="gelu",
    encoder=EncoderConfig(num_layers=32, num_frames=1500, d_model=1280,
                          num_heads=20, d_ff=5120),
)
SMOKE = reduced(CONFIG)
