"""Operations and bytes from shapes: the yardstick's arithmetic.

The sizes come from the configuration file (``Dims``), never from the
program.  Peaks are an H100 SXM's data-sheet numbers: dense bf16 989e12
FLOP/s and 3.35e12 B/s of HBM.  A FLOP count is two a multiply-add; a byte
count reads each input once and writes each output once.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12


@dataclass(frozen=True)
class Dims:
    layers: int
    d: int
    heads: int
    kv_heads: int
    head_dim: int
    ff: int
    vocab: int
    tied: bool
    gated: bool                  # SwiGLU: three FFN matrices, else two
    param_bytes_each: int        # 2 for bf16 weights, 4 for fp32

    @classmethod
    def of(cls, config: Dict[str, Any]) -> "Dims":
        return cls(layers=config["num_hidden_layers"], d=config["hidden_size"],
                   heads=config["num_attention_heads"],
                   kv_heads=config["num_key_value_heads"], head_dim=config["head_dim"],
                   ff=config["intermediate_size"], vocab=config["vocab_size"],
                   tied=config["tie_word_embeddings"], gated=config["hidden_act"] == "silu",
                   param_bytes_each=4 if config["torch_dtype"] == "float32" else 2)


def layer_params(c: Dims) -> int:
    """Matrix parameters of one layer (attention and FFN)."""
    q, kv = c.heads * c.head_dim, c.kv_heads * c.head_dim
    return c.d * (2 * q + 2 * kv) + (3 if c.gated else 2) * c.d * c.ff


def params(c: Dims) -> int:
    """Every parameter: embedding, head, layers with their norms."""
    embed = c.vocab * c.d * (1 if c.tied else 2)
    return embed + c.layers * (layer_params(c) + 4 * c.d) + 2 * c.d


def param_bytes(c: Dims) -> int:
    return params(c) * c.param_bytes_each


def kv_bytes(c: Dims, batch: int, slots: int) -> int:
    """A decode cache of ``slots`` rows for every layer, keys and values."""
    return 2 * c.layers * batch * slots * c.kv_heads * c.head_dim * c.param_bytes_each


def flash_work(c: Dims, batch: int, seq: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of one causal self-attention call over ``seq`` tokens."""
    pairs = seq * (seq + 1) / 2
    flops = 4.0 * batch * c.heads * c.head_dim * pairs
    nbytes = 2.0 * batch * seq * (2 * c.heads + 2 * c.kv_heads) * c.head_dim
    return flops, nbytes


def decode_work(c: Dims, batch: int, keys: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of one decode-attention call over ``keys`` cache rows:
    the cache read once, the query read and the output written, the mask."""
    flops = 4.0 * batch * c.heads * c.head_dim * keys
    nbytes = (2.0 * 2 * batch * keys * c.kv_heads * c.head_dim
              + 2.0 * 2 * batch * c.heads * c.head_dim + batch * keys)
    return flops, nbytes


def bound_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def prefill_flops(c: Dims, batch: int, seq: int) -> float:
    """The layers over every prompt token, attention, the last token's head."""
    return (c.layers * (2.0 * batch * seq * layer_params(c) + flash_work(c, batch, seq)[0])
            + 2.0 * batch * c.d * c.vocab)


def decode_flops(c: Dims, batch: int, keys: int) -> float:
    """One decode step: the layers over one token a row, attention over
    ``keys`` rows, the head."""
    return (c.layers * (2.0 * batch * layer_params(c) + decode_work(c, batch, keys)[0])
            + 2.0 * batch * c.d * c.vocab)


def request_flops(c: Dims, batch: int, seq: int, steps: int) -> float:
    """One invoke: a prefill and ``steps`` decode steps.  The engine's cache
    holds the prompt's ``seq`` rows, so each step attends ``seq`` keys."""
    return prefill_flops(c, batch, seq) + steps * decode_flops(c, batch, seq)
