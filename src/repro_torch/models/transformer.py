"""Decoder-only block stack (port of ``repro.models.transformer``).

The JAX package stacks parameters over the repeats of a block *period* and
runs them under ``lax.scan``; PyTorch runs eagerly, so here the layers are an
``nn.ModuleList`` walked by a Python loop and each layer keeps its own cache.
Each block is a mixer — GQA attention (``"A"``), Mamba (``"M"``), mLSTM
(``"L"``) or sLSTM (``"S"``) — and a dense or routed-MoE FFN, or none
(xLSTM blocks carry their own projections: ``d_ff = 0``).

Modes:
  full   — prefill over (B, S); returns per-layer cache material
  decode — one token against per-layer caches / recurrent states
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from repro_torch import sharding
from repro_torch.models import attention, layers, mamba, moe, xlstm


# --------------------------------------------------------------------------- #
# pattern / period logic
# --------------------------------------------------------------------------- #


def period_len(cfg) -> int:
    p = len(cfg.block_pattern)
    if cfg.moe is not None:
        p = math.lcm(p, cfg.moe.every_n_layers)
    if cfg.num_layers % p:
        raise ValueError(
            f"{cfg.name}: num_layers={cfg.num_layers} not a multiple of "
            f"pattern period {p}")
    return p


def _block_meta(cfg) -> List[Dict[str, Any]]:
    """Per-position-in-period: mixer kind + ffn kind."""
    per = period_len(cfg)
    moe_mask = cfg.moe_layer_mask()
    pat = cfg.layer_pattern
    out = []
    for i in range(per):
        if pat[i] not in "AMLS":
            raise ValueError(f"{cfg.name}: unknown block kind {pat[i]!r}")
        ffn = "moe" if moe_mask[i] else ("dense" if cfg.d_ff else "none")
        out.append({"kind": pat[i], "ffn": ffn})
    return out


# --------------------------------------------------------------------------- #
# blocks
# --------------------------------------------------------------------------- #


class Block(nn.Module):
    """``norm1`` + ``attn``, ``ssm`` or ``xl``; ``norm2`` + ``ffn`` or ``moe``
    where the block has an FFN (the JAX tree's names)."""

    def __init__(self, cfg, meta, *, device, gen: Optional[torch.Generator] = None):
        super().__init__()
        self.norm1 = layers.norm_init(cfg.d_model, cfg.norm, cfg.param_dtype, device=device)
        kind = meta["kind"]
        if kind == "A":
            self.attn = attention.Attention(cfg, device=device, gen=gen)
        elif kind == "M":
            self.ssm = mamba.Mamba(cfg, device=device, gen=gen)
        elif kind == "L":
            self.xl = xlstm.MLSTM(cfg, device=device, gen=gen)
        else:
            self.xl = xlstm.SLSTM(cfg, device=device, gen=gen)
        if meta["ffn"] != "none":
            self.norm2 = layers.norm_init(cfg.d_model, cfg.norm, cfg.param_dtype,
                                          device=device)
        if meta["ffn"] == "dense":
            self.ffn = layers.MLP(cfg.d_model, cfg.d_ff, cfg.act, cfg.param_dtype,
                                  device=device, gen=gen)
        elif meta["ffn"] == "moe":
            self.moe = moe.MoE(cfg, device=device, gen=gen)


def init_stack(gen: Optional[torch.Generator], cfg, *, device) -> nn.ModuleList:
    """One ``Block`` per layer (layer ``i`` is period position ``i % period``)."""
    metas = _block_meta(cfg)
    return nn.ModuleList(Block(cfg, metas[i % len(metas)], device=device, gen=gen)
                         for i in range(cfg.num_layers))


def _apply_ffn(p: Block, x, cfg):
    """x + FFN(norm2(x)).  Returns (x, MoE aux loss; 0.0 without MoE)."""
    if not hasattr(p, "norm2"):
        return x, 0.0
    h = layers.norm_apply(p.norm2, x, cfg.norm)
    if hasattr(p, "ffn"):
        h = sharding.logical(h, ("batch", "seq", "embed"))
        return x + layers.mlp_apply(p.ffn, h, cfg.act), 0.0
    y, aux = moe.moe_ffn(p.moe, h, cfg)
    return x + y, aux


def _block_full(p: Block, x, cfg, q_pos, window):
    """Full-sequence block.  Returns (x, aux, cache_material)."""
    h = layers.norm_apply(p.norm1, x, cfg.norm)
    if hasattr(p, "attn"):
        # context-parallel fallback: tokens split over the model axis through
        # the attention block when heads do not divide it
        h = sharding.logical(h, ("batch", "attn_seq", None))
        y, (k, v) = attention.full_attention(p.attn, h, cfg, q_pos=q_pos,
                                             window=window, return_kv=True)
        y = sharding.logical(y, ("batch", "attn_seq", None))
        cache = {"k": k, "v": v}
    elif hasattr(p, "ssm"):
        y, cache = mamba.mamba_forward(p.ssm, h, cfg)
    elif isinstance(p.xl, xlstm.MLSTM):
        y, cache = xlstm.mlstm_forward(p.xl, h, cfg)
    else:
        y, cache = xlstm.slstm_forward(p.xl, h, cfg)
    x, aux = _apply_ffn(p, x + y, cfg)
    return sharding.logical(x, ("batch", "seq", "embed")), aux, cache


def _block_decode(p: Block, x, cfg, pos, window, cache):
    """One-token block.  x: (B, d).  Returns (x, new_cache)."""
    h = layers.norm_apply(p.norm1, x, cfg.norm)
    if hasattr(p, "attn"):
        y, cache = attention.decode_attention(p.attn, h, cache, pos, cfg, window=window)
    elif hasattr(p, "ssm"):
        y, cache = mamba.mamba_step(p.ssm, h, cache, cfg)
    elif isinstance(p.xl, xlstm.MLSTM):
        y, cache = xlstm.mlstm_step(p.xl, h, cache, cfg)
    else:
        y, cache = xlstm.slstm_step(p.xl, h, cache, cfg)
    x, _ = _apply_ffn(p, (x + y)[:, None, :], cfg)
    return x[:, 0, :], cache


# --------------------------------------------------------------------------- #
# stack apply (a Python loop over layers)
# --------------------------------------------------------------------------- #


def _period_full(period, x, aux, cfg, q_pos, window):
    """The layers of one period in turn: (x, aux, their caches)."""
    caches = []
    for p in period:
        x, a, c = _block_full(p, x, cfg, q_pos, window)
        aux = aux + a
        caches.append(c)
    return x, aux, caches


def stack_full(blocks: nn.ModuleList, x, cfg, *, q_pos, window=None, train=False):
    """x: (B, S, d) -> (x, summed MoE aux loss, caches), one cache per layer.

    With ``train`` and ``cfg.remat`` each period runs under activation
    checkpointing (the reference's ``jax.checkpoint`` of its period): its
    activations are recomputed in the backward instead of kept.  The numbers
    are the same either way."""
    aux = sharding.replicate_like(torch.zeros((), dtype=torch.float32, device=x.device), x)
    per = period_len(cfg)
    caches = []
    for i in range(0, len(blocks), per):
        period = blocks[i:i + per]
        if train and cfg.remat:
            x, aux, c = checkpoint(_period_full, period, x, aux, cfg, q_pos, window,
                                   use_reentrant=False)
        else:
            x, aux, c = _period_full(period, x, aux, cfg, q_pos, window)
        caches += c
    return x, aux, caches


def stack_decode(blocks: nn.ModuleList, x, cfg, *, pos, window=None, caches=None):
    """x: (B, d) one token -> (x, new_caches)."""
    new = []
    for p, c in zip(blocks, caches):
        x, c = _block_decode(p, x, cfg, pos, window, c)
        new.append(c)
    return x, new


def init_decode_caches(cfg, batch: int, max_seq: int, *, window=None, device):
    """Allocate one zero cache (attention) or initial recurrent state (Mamba,
    mLSTM, sLSTM) per layer."""
    metas = _block_meta(cfg)
    init = {"A": lambda: attention.init_cache(cfg, batch, max_seq, window=window,
                                              device=device),
            "M": lambda: mamba.init_mamba_state(cfg, batch, device=device),
            "L": lambda: xlstm.init_mlstm_state(cfg, batch, device=device),
            "S": lambda: xlstm.init_slstm_state(cfg, batch, device=device)}
    return [init[metas[i % len(metas)]["kind"]]() for i in range(cfg.num_layers)]
