"""Whisper-style encoder–decoder (port of ``repro.models.encdec``; the
audio frontend is a stub there too).

Encoder: a non-causal transformer over precomputed frame embeddings
(B, num_frames, d_enc), with sinusoidal positions added here.  Decoder:
causal self-attention with learned absolute positions (no RoPE),
cross-attention over the encoder's output, and a GELU MLP.  The reference
stacks each stack's layers under ``lax.scan``; here they are an
``nn.ModuleList`` walked by a Python loop.

Decode caches: ``{"self": [...], "cross": [...]}``, one ``{"k", "v"}`` a
decoder layer: the self cache padded to ``max_seq`` slots, the cross cache
(B, num_frames, H_kv, head_dim) computed once at prefill and never written.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from repro_torch import sharding
from repro_torch.models import attention, layers
from repro_torch.models.lm import _pad_seq, embed_lookup, masked_nll, unembed_names, whole_vocab


class EncLayer(nn.Module):
    """``norm1``, ``attn``, ``norm2``, ``ffn`` at the encoder's width."""

    def __init__(self, cfg, *, device, gen: Optional[torch.Generator] = None):
        super().__init__()
        e, pdt = cfg.encoder, cfg.param_dtype
        self.norm1 = layers.norm_init(e.d_model, cfg.norm, pdt, device=device)
        self.attn = attention.Attention(cfg, e.d_model, num_heads=e.num_heads,
                                        num_kv_heads=e.num_heads, device=device, gen=gen)
        self.norm2 = layers.norm_init(e.d_model, cfg.norm, pdt, device=device)
        self.ffn = layers.MLP(e.d_model, e.d_ff, cfg.act, pdt, device=device, gen=gen)


class DecLayer(nn.Module):
    """``norm1``, ``self``, ``norm_x``, ``cross``, ``norm2``, ``ffn``."""

    def __init__(self, cfg, *, device, gen: Optional[torch.Generator] = None):
        super().__init__()
        d, pdt = cfg.d_model, cfg.param_dtype
        self.norm1 = layers.norm_init(d, cfg.norm, pdt, device=device)
        self.self = attention.Attention(cfg, device=device, gen=gen)
        self.norm_x = layers.norm_init(d, cfg.norm, pdt, device=device)
        self.cross = attention.Attention(cfg, cross=True, device=device, gen=gen)
        self.norm2 = layers.norm_init(d, cfg.norm, pdt, device=device)
        self.ffn = layers.MLP(d, cfg.d_ff, cfg.act, pdt, device=device, gen=gen)


class EncDec(nn.Module):
    """Parameters of the encoder–decoder.  ``state_dict`` keys: ``embed``
    (tied with the unembedding), ``pos`` (max_seq, d), ``enc_blocks.<i>.*``,
    ``enc_norm.*``, ``dec_blocks.<i>.*``, ``norm_f.*`` (the JAX tree's
    names; its stacked layer ``i`` is the port's ``<i>``)."""

    def __init__(self, cfg, *, max_seq: int, device,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        e, pdt = cfg.encoder, cfg.param_dtype
        self.embed = layers.embed_init(gen, cfg.vocab_size, cfg.d_model, pdt, device=device)
        self.pos = layers.posembed_init(gen, max_seq, cfg.d_model, pdt, device=device)
        self.enc_blocks = nn.ModuleList(EncLayer(cfg, device=device, gen=gen)
                                        for _ in range(e.num_layers))
        self.enc_norm = layers.norm_init(e.d_model, cfg.norm, pdt, device=device)
        self.dec_blocks = nn.ModuleList(DecLayer(cfg, device=device, gen=gen)
                                        for _ in range(cfg.num_layers))
        self.norm_f = layers.norm_init(cfg.d_model, cfg.norm, pdt, device=device)


def init_encdec(gen: torch.Generator, cfg, *, max_seq: int, device) -> EncDec:
    return EncDec(cfg, max_seq=max_seq, device=device, gen=gen)


# --------------------------------------------------------------------------- #
# encoder
# --------------------------------------------------------------------------- #


def _layers(fn, blocks, x, *args, train: bool, remat: bool):
    """``x = fn(layer, x, *args)`` over ``blocks``, each layer under
    activation checkpointing with ``train and remat`` (the reference's
    ``jax.checkpoint`` of its scanned layer).  Returns (x, each layer's
    other outputs)."""
    outs = []
    for lp in blocks:
        if train and remat:
            x, *o = checkpoint(fn, lp, x, *args, use_reentrant=False)
        else:
            x, *o = fn(lp, x, *args)
        outs.append(o)
    return x, outs


def _enc_layer(lp: EncLayer, x, cfg, pos):
    e = cfg.encoder
    h = layers.norm_apply(lp.norm1, x, cfg.norm)
    x = x + attention.full_attention(lp.attn, h, cfg, q_pos=pos, causal=False,
                                     use_rope=False, num_heads=e.num_heads,
                                     num_kv_heads=e.num_heads)
    h = layers.norm_apply(lp.norm2, x, cfg.norm)
    return (x + layers.mlp_apply(lp.ffn, h, cfg.act),)


def encode(p: EncDec, cfg, frames, *, train=False):
    """frames: (B, F, d_enc) stub embeddings -> (B, F, d_enc)."""
    e = cfg.encoder
    x = frames.to(layers.dt(cfg.dtype))
    pe = layers.sinusoid_embed(x.shape[1], e.d_model, x.dtype, device=x.device)
    x = sharding.logical(x + sharding.replicate_like(pe, x)[None], ("batch", None, "embed"))
    pos = torch.arange(x.shape[1], device=x.device, dtype=torch.int32)
    x, _ = _layers(_enc_layer, p.enc_blocks, x, cfg, pos, train=train, remat=cfg.remat)
    return layers.norm_apply(p.enc_norm, x, cfg.norm)


# --------------------------------------------------------------------------- #
# decoder
# --------------------------------------------------------------------------- #


def _unembed(p: EncDec, x):
    logits = x.float() @ p.embed.T.float()     # tied
    return sharding.logical(logits, unembed_names(logits))


def _dec_layer(lp: DecLayer, x, cfg, q_pos, enc_out):
    h = layers.norm_apply(lp.norm1, x, cfg.norm)
    # context-parallel fallback: whisper's 20 heads do not divide the model axis
    h = sharding.logical(h, ("batch", "attn_seq", None))
    y, (k, v) = attention.full_attention(lp.self, h, cfg, q_pos=q_pos,
                                         use_rope=False, return_kv=True)
    x = x + sharding.logical(y, ("batch", "attn_seq", None))
    h = layers.norm_apply(lp.norm_x, x, cfg.norm)
    y, (xk, xv) = attention.full_attention(lp.cross, h, cfg, q_pos=q_pos,
                                           kv_x=enc_out, causal=False,
                                           use_rope=False, return_kv=True)
    x = x + y
    h = layers.norm_apply(lp.norm2, x, cfg.norm)
    return x + layers.mlp_apply(lp.ffn, h, cfg.act), {"k": k, "v": v}, {"k": xk, "v": xv}


def _dec_hidden(p: EncDec, cfg, tokens, enc_out, *, train=False):
    """Final-norm hidden states (B, S, d) and each layer's self and cross
    keys / values."""
    s = tokens.shape[1]
    x = embed_lookup(p.embed, tokens).to(layers.dt(cfg.dtype))
    x = sharding.logical(x + p.pos[:s][None].to(x.dtype), ("batch", "seq", "embed"))
    q_pos = torch.arange(s, device=x.device, dtype=torch.int32)
    x, kv = _layers(_dec_layer, p.dec_blocks, x, cfg, q_pos, enc_out, train=train,
                    remat=cfg.remat)
    self_kv, cross_kv = [o[0] for o in kv], [o[1] for o in kv]
    return layers.norm_apply(p.norm_f, x, cfg.norm), self_kv, cross_kv


def _dec_full(p: EncDec, cfg, tokens, enc_out, *, train=False):
    """Returns (logits (B, S, V) fp32, self-kv per layer, cross-kv per layer)."""
    x, self_kv, cross_kv = _dec_hidden(p, cfg, tokens, enc_out, train=train)
    return _unembed(p, x), self_kv, cross_kv


def encdec_loss(p: EncDec, cfg, batch):
    """Mean next-token NLL of the decoder over labels >= 0 (no z-loss, aux 0).
    Returns (loss, {loss, aux, zloss, tokens})."""
    enc_out = encode(p, cfg, batch["frames"], train=True)
    logits, _, _ = _dec_full(p, cfg, batch["tokens"], enc_out, train=True)
    loss, _, denom = masked_nll(whole_vocab(logits), batch["labels"])
    zero = torch.zeros((), dtype=torch.float32, device=logits.device)
    return loss, {"loss": loss, "aux": zero, "zloss": zero, "tokens": denom.float()}


def encdec_prefill(p: EncDec, cfg, batch, *, max_seq: int):
    """Prefill on ``tokens`` and ``frames``: returns (last-token logits,
    decode caches, next position).  Only the last position is unembedded."""
    enc_out = encode(p, cfg, batch["frames"])
    x, self_kv, cross_kv = _dec_hidden(p, cfg, batch["tokens"], enc_out)
    self_kv = [{key: _pad_seq(t, max_seq) for key, t in c.items()} for c in self_kv]
    return _unembed(p, x[:, -1, :]), {"self": self_kv, "cross": cross_kv}, x.shape[1]


def _learned_position(table, pos, device):
    """Row ``pos`` of the (max_len, d) table as (1, d): a masked gather that
    reads row min(pos, max_len - 1) and gives NaN where pos >= max_len, which
    is ``jnp.take``'s fill for an index past the table.  Nothing is indexed
    out of bounds and nothing waits on the device, whether ``pos`` is an int
    or a device scalar.  A DTensor table gives a replicated row."""
    posv = attention._position(pos, device)
    max_len = table.shape[0]
    row = embed_lookup(table, posv.clamp(0, max_len - 1))
    past = sharding.replicate_like((posv >= max_len)[:, None], row)
    return torch.where(past, torch.full_like(row, float("nan")), row)


def encdec_decode_step(p: EncDec, cfg, caches, token, pos):
    """token: (B,) int; pos: scalar int.  Returns (logits (B, V), caches).
    Under the decode rules the self caches' rows are split (``cache_seq``),
    the cross caches' whole."""
    x = sharding.logical(embed_lookup(p.embed, token).to(layers.dt(cfg.dtype)),
                         ("batch", "embed"))
    x = x + _learned_position(p.pos, pos, x.device).to(x.dtype)
    self_kv = []
    for lp, skv, xkv in zip(p.dec_blocks, caches["self"], caches["cross"]):
        h = layers.norm_apply(lp.norm1, x, cfg.norm)
        y, skv = attention.decode_attention(lp.self, h, skv, pos, cfg, use_rope=False)
        x = x + y
        h = layers.norm_apply(lp.norm_x, x, cfg.norm)
        y, _ = attention.decode_attention(lp.cross, h, None, pos, cfg,
                                          cross_kv=(xkv["k"], xkv["v"]), use_rope=False)
        x = x + y
        h = layers.norm_apply(lp.norm2, x, cfg.norm)
        x = x + layers.mlp_apply(lp.ffn, h, cfg.act)
        self_kv.append(skv)
    x = layers.norm_apply(p.norm_f, x, cfg.norm)
    return _unembed(p, x), {"self": self_kv, "cross": caches["cross"]}
