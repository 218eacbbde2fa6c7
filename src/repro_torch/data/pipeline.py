"""Deterministic synthetic LM data pipeline (a numpy copy of
``repro.data.pipeline``: the same batches bit for bit for the same
``(cfg, shape, seed)``).

Generates Zipf-distributed token streams with a planted bigram structure
(so the loss genuinely falls during training — a pure-uniform stream would
plateau at ln V), packs them into (tokens, labels) next-token batches, and
adds the per-family extras (audio frames, image patch embeddings).
Batches are host-side numpy; the trainer moves each to the device once.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.config import InputShape, ModelConfig


@dataclasses.dataclass
class DataConfig:
    vocab_size: int
    batch: int
    seq_len: int
    zipf_a: float = 1.3
    bigram_jump: int = 7          # planted structure: P(next = cur+jump) high
    bigram_p: float = 0.65
    seed: int = 0


def _stream(cfg: DataConfig) -> Iterator[np.ndarray]:
    rng = np.random.default_rng(cfg.seed)
    v = cfg.vocab_size
    ranks = np.arange(1, v + 1, dtype=np.float64) ** -cfg.zipf_a
    probs = ranks / ranks.sum()
    while True:
        base = rng.choice(v, size=(cfg.batch, cfg.seq_len + 1), p=probs)
        # plant deterministic bigram transitions
        follow = rng.random((cfg.batch, cfg.seq_len)) < cfg.bigram_p
        for t in range(1, cfg.seq_len + 1):
            nxt = (base[:, t - 1] + cfg.bigram_jump) % v
            base[:, t] = np.where(follow[:, t - 1], nxt, base[:, t])
        yield base.astype(np.int32)


def batches(model_cfg: ModelConfig, shape: InputShape, *, seed: int = 0,
            batch_override: Optional[int] = None,
            seq_override: Optional[int] = None) -> Iterator[Dict[str, np.ndarray]]:
    b = batch_override or shape.global_batch
    s = seq_override or shape.seq_len
    dc = DataConfig(vocab_size=model_cfg.vocab_size, batch=b, seq_len=s,
                    seed=seed)
    rng = np.random.default_rng(seed + 1)
    dtype = np.float32          # extras are fp32 whatever the model computes in
    for chunk in _stream(dc):
        out: Dict[str, np.ndarray] = {
            "tokens": chunk[:, :-1],
            "labels": chunk[:, 1:],
        }
        if model_cfg.encoder is not None:
            e = model_cfg.encoder
            out["frames"] = rng.standard_normal(
                (b, e.num_frames, e.d_model)).astype(dtype)
        if model_cfg.vision is not None:
            vz = model_cfg.vision
            out["image_embeds"] = rng.standard_normal(
                (b, vz.num_image_tokens, vz.d_embed)).astype(dtype)
        yield out


def prompt_batch(model_cfg: ModelConfig, *, batch: int, seq_len: int,
                 seed: int = 0) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, model_cfg.vocab_size,
                                  (batch, seq_len)).astype(np.int32)}
    if model_cfg.encoder is not None:
        e = model_cfg.encoder
        out["frames"] = rng.standard_normal(
            (batch, e.num_frames, e.d_model)).astype(np.float32)
    if model_cfg.vision is not None:
        vz = model_cfg.vision
        out["image_embeds"] = rng.standard_normal(
            (batch, vz.num_image_tokens, vz.d_embed)).astype(np.float32)
    return out
