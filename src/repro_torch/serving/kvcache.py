"""KV-cache accounting (port of ``repro.serving.kvcache``).

The cache tensors themselves live in the model bundles (ring buffers for SWA
archs, recurrent states for SSM/xLSTM, whisper's fixed cross-attention
caches — see models/attention.py and models/encdec.py); this module provides
the capacity math the autoscaler and the RQ2 'memory' factor study need,
and the caches themselves as meta tensors (:func:`caches_spec`: shapes and
dtypes, no storage), whose bytes :func:`cache_bytes` counts and whose
partition specs ``launch.specs.caches_shardings`` gives.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.config import InputShape, ModelConfig
from repro_torch.models import registry
from repro_torch.models.registry import resolve_window


def cache_bytes(cfg: ModelConfig, batch: int, seq_len: int,
                shape: Optional[InputShape] = None) -> int:
    """Decode-state bytes per replica (KV cache or recurrent state)."""
    window = resolve_window(cfg, shape)
    itemsize = 2 if cfg.dtype == "bfloat16" else 4
    total = 0
    pat = cfg.layer_pattern
    for kind in pat:
        if kind == "A":
            s = min(window, seq_len) if window else seq_len
            total += 2 * batch * s * cfg.num_kv_heads * cfg.head_dim * itemsize
        elif kind == "M":
            ssm = cfg.ssm
            d_in = ssm.expand * cfg.d_model
            total += batch * d_in * ssm.d_state * 4          # fp32 h
            total += batch * (ssm.d_conv - 1) * d_in * itemsize
        elif kind in ("L", "S"):
            x = cfg.xlstm
            d_in = int(x.proj_factor * cfg.d_model)
            dh = d_in // x.num_heads
            if kind == "L":
                total += batch * x.num_heads * dh * dh * 4   # matrix memory C
                total += batch * x.num_heads * (dh + 1) * 4
            else:
                total += batch * d_in * 4 * 4
    if cfg.encoder is not None:
        total += (cfg.num_layers * 2 * batch * cfg.encoder.num_frames
                  * cfg.num_kv_heads * cfg.head_dim * itemsize)
    return total


def caches_spec(cfg: ModelConfig, batch: int, seq_len: int,
                shape: Optional[InputShape] = None):
    """The decode caches :func:`cache_bytes` counts, as meta tensors in the
    models' layout (one entry a layer)."""
    return registry._init_caches(cfg, batch, seq_len, resolve_window(cfg, shape),
                                 device="meta")


def param_bytes(cfg: ModelConfig) -> int:
    itemsize = 2 if cfg.param_dtype == "bfloat16" else 4
    return cfg.param_count() * itemsize


def replica_memory_gb(cfg: ModelConfig, shape: InputShape) -> float:
    """Total warm-replica footprint (params + decode state) in GB."""
    b = shape.global_batch if shape.kind == "decode" else 1
    return (param_bytes(cfg) + cache_bytes(cfg, b, shape.seq_len, shape)) / 2**30


def fits_hbm(cfg: ModelConfig, shape: InputShape, *, chips: int,
             hbm_gb_per_chip: float = 80.0, headroom: float = 0.85) -> bool:
    """Whether a warm replica fits ``chips`` cards (default: one H100's 80 GB)."""
    return replica_memory_gb(cfg, shape) <= chips * hbm_gb_per_chip * headroom
