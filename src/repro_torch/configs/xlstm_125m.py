"""xLSTM-125M [arXiv:2405.04517] — recurrent sLSTM + mLSTM block stack.

12L d_model=768 4H d_ff=0 (blocks carry their own up/down projection)
vocab=50304. Pattern alternates mLSTM ('L') and sLSTM ('S').
"""
from repro_torch.config import ModelConfig, XLSTMConfig, reduced

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    source="arXiv:2405.04517",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    block_pattern="LS",
    xlstm=XLSTMConfig(slstm_every=2, proj_factor=2.0, num_heads=4),
)
SMOKE = reduced(CONFIG)
