"""Decoder-only language model (port of ``repro.models.lm``): attention,
Mamba and xLSTM blocks with dense, MoE or no FFNs, and the vision-language
backbone, whose projected image embeddings are prepended to the text; and
the causal LM loss the trainer differentiates."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch import sharding
from repro_torch.models import layers, transformer


class LM(nn.Module):
    """Parameters of the LM.  ``state_dict`` keys: ``embed``,
    ``blocks.<layer>.{norm1,attn|ssm|xl,norm2,ffn|moe}.<leaf>`` (MoE: ``router``,
    ``wi``, ``wg``, ``wo`` stacked over experts, ``dense.<leaf>``; sLSTM:
    ``xl.{gi,gf,gz,go}.{wx,wh,b}``),
    ``norm_f.<leaf>``, for untied configs ``unembed`` and, for vision
    configs, the projector ``proj`` (d_embed, d_model) — every dense weight
    ``(in, out)``."""

    def __init__(self, cfg, *, device, gen: Optional[torch.Generator] = None):
        super().__init__()
        pdt = cfg.param_dtype
        self.embed = layers.embed_init(gen, cfg.vocab_size, cfg.d_model, pdt,
                                       device=device)
        self.blocks = transformer.init_stack(gen, cfg, device=device)
        self.norm_f = layers.norm_init(cfg.d_model, cfg.norm, pdt, device=device)
        if not cfg.tie_embeddings:
            self.unembed = layers.dense_init(gen, cfg.d_model, cfg.vocab_size,
                                             pdt, device=device)
        if cfg.vision is not None:
            # projector stub: the patch embeddings arrive at LM width already;
            # one linear keeps the interface of a real MLP projector
            self.proj = layers.dense_init(gen, cfg.vision.d_embed, cfg.d_model,
                                          pdt, device=device)


def init_lm(gen: torch.Generator, cfg, *, max_seq: int, device) -> LM:
    del max_seq  # the reference's signature; an LM has no learned positions
    return LM(cfg, device=device, gen=gen)


def embed_lookup(table, tokens):
    """Rows ``tokens`` of ``table``.  F.embedding, not table[tokens]: the same
    rows, and on CUDA a backward that sums each row's gradient in a sorted
    pass instead of scattering atomics into a bf16 table.  A DTensor table
    goes through :func:`_embed_sharded`."""
    if sharding.is_dtensor(table):
        return _embed_sharded(table, tokens)
    return F.embedding(tokens, table)


def _embed_sharded(table, tokens):
    """The lookup on a DTensor table through ``local_map``: its d_model
    (fsdp) split is gathered and its vocab split kept; each rank looks up the
    tokens its rows hold, zeros elsewhere, and the output is the ``Partial``
    sum over the vocab ranks that the caller's constraint reduces.  The
    table's gradient stays split by vocab, and is a partial sum over the
    ranks that split the tokens."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    tokens = sharding.replicate_like(tokens, table)
    tp = [Shard(0) if p.is_shard(0) else Replicate() for p in table.placements]
    ip = [Replicate() if t.is_shard(0) else p for p, t in zip(tokens.placements, tp)]
    out = [Partial() if t.is_shard(0) else p for p, t in zip(ip, tp)]
    grad = [t if t.is_shard(0) else (Partial() if p.is_shard(0) else Replicate())
            for p, t in zip(ip, tp)]
    first = sharding.shard_offset(mesh, tp, 0, table.shape[0])

    def local(table, tokens):
        ids = tokens - first
        held = (ids >= 0) & (ids < table.shape[0])
        rows = F.embedding(torch.where(held, ids, 0), table)
        return torch.where(held[..., None], rows, 0.0)

    fn = local_map(local, out_placements=out, in_placements=(tp, ip),
                   in_grad_placements=(grad, ip), device_mesh=mesh,
                   redistribute_inputs=True)
    return fn(table, tokens)


def _embed_tokens(p: LM, cfg, tokens):
    return embed_lookup(p.embed, tokens).to(layers.dt(cfg.dtype))


def _inputs_to_x(p: LM, cfg, batch):
    """tokens (+ image embeds projected and prepended) -> (B, S, d).  The
    last ``n_img`` text tokens are dropped, so S stays the tokens' length."""
    x = _embed_tokens(p, cfg, batch["tokens"])
    if cfg.vision is not None and "image_embeds" in batch:
        img = batch["image_embeds"].to(x.dtype) @ p.proj
        x = torch.cat([img, x[:, : x.shape[1] - img.shape[1], :]], dim=1)
    return sharding.logical(x, ("batch", "seq", "embed"))


def unembed_names(x):
    """The logits' logical names: batch, any positions, then the vocab."""
    return ("batch",) + (None,) * (x.dim() - 2) + ("vocab",)


def _unembed(p: LM, cfg, x):
    w = p.embed.T if cfg.tie_embeddings else p.unembed
    logits = x.float() @ w.float()
    return sharding.logical(logits, unembed_names(logits))


def _hidden(p: LM, cfg, batch, *, window=None, train=False):
    """Final-norm hidden states (B, S, d), the MoE aux loss and per-layer
    cache material."""
    x = _inputs_to_x(p, cfg, batch)
    q_pos = torch.arange(x.shape[1], device=x.device, dtype=torch.int32)
    x, aux, caches = transformer.stack_full(p.blocks, x, cfg, q_pos=q_pos,
                                            window=window, train=train)
    return layers.norm_apply(p.norm_f, x, cfg.norm), aux, caches


def lm_forward(p: LM, cfg, batch, *, window=None, train=False):
    """Full-sequence forward: returns (logits (B, S, V) fp32, aux, caches).
    ``train`` turns on activation checkpointing where ``cfg.remat`` asks."""
    x, aux, caches = _hidden(p, cfg, batch, window=window, train=train)
    return _unembed(p, cfg, x), aux, caches


def whole_vocab(logits):
    """The loss's logits: the vocab split of ``("batch", None, "vocab")`` is
    gathered (each rank then holds its batch rows' whole logits), so the
    log-softmax, the label's gather and the z-loss's logsumexp run on local
    rows; no partial reduction over vocab shards."""
    return sharding.logical(logits, ("batch", None, None))


def masked_nll(logits, labels):
    """Mean next-token NLL of fp32 ``logits`` (B, S, V) over ``labels >= 0``:
    (loss, mask, token count)."""
    mask = labels >= 0
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels.clamp(min=0).long()[..., None])[..., 0]
    denom = mask.sum().clamp(min=1)
    return torch.where(mask, nll, 0.0).sum() / denom, mask, denom


def lm_loss(p: LM, cfg, batch, *, window=None):
    """Causal LM loss: mean next-token NLL over labels >= 0 (image positions
    carry none), plus the z-loss 1e-4 * mean(logsumexp^2) and the MoE aux
    loss.  Returns (total, {loss, aux, zloss, tokens})."""
    logits, aux, _ = lm_forward(p, cfg, batch, window=window, train=True)
    logits = whole_vocab(logits)
    labels = batch["labels"]
    if cfg.vision is not None and "image_embeds" in batch:
        n_img = batch["image_embeds"].shape[1]
        none = torch.full((labels.shape[0], n_img), -1, dtype=labels.dtype,
                          device=labels.device)
        labels = torch.cat([sharding.replicate_like(none, labels),
                            labels[:, : labels.shape[1] - n_img]], dim=1)
    loss, mask, denom = masked_nll(logits, labels)
    # z-loss for logit drift (MaxText default)
    zl = 1e-4 * torch.where(mask, torch.logsumexp(logits, -1) ** 2, 0.0).sum() / denom
    total = loss + zl + aux
    return total, {"loss": loss, "aux": aux, "zloss": zl, "tokens": denom.float()}


def lm_prefill(p: LM, cfg, batch, *, max_seq: int, window=None):
    """Prefill: returns (last-token logits, decode caches, next position).

    Only the last position is unembedded: the same numbers as the JAX
    package's full forward sliced at -1, without the (B, S, V) fp32 tensor.
    """
    x, _, raw = _hidden(p, cfg, batch, window=window)
    seq_len = x.shape[1]
    caches = _format_caches(cfg, raw, seq_len=seq_len, max_seq=max_seq,
                            window=window)
    return _unembed(p, cfg, x[:, -1, :]), caches, seq_len


def _pad_seq(t, s_cache: int):
    """Zero-pad (B, S, H, D) along S to s_cache."""
    pad = s_cache - t.shape[1]
    if pad < 0:
        raise ValueError(f"prompt of {t.shape[1]} tokens exceeds the "
                         f"{s_cache}-slot decode cache")
    return torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad)) if pad else t


def _format_caches(cfg, raw_caches, *, seq_len: int, max_seq: int, window):
    """Pack per-layer prefill keys/values into the fixed decode layout;
    recurrent (Mamba, mLSTM, sLSTM) states are decode-ready and pass through."""
    s_cache = min(window, max_seq) if window else max_seq
    out = []
    for kind, c in zip(cfg.layer_pattern, raw_caches):
        if kind != "A":
            out.append(c)
            continue
        k, v = c["k"], c["v"]                  # (B, S, hkv, hd)
        if window and s_cache <= window and seq_len >= s_cache:
            # ring layout: absolute position p lives in slot p % w; the kept
            # suffix starts at `start`, so roll right by start % w.
            w = s_cache
            shift = (seq_len - w) % w
            out.append({"k": torch.roll(k[:, -w:], shift, dims=1),
                        "v": torch.roll(v[:, -w:], shift, dims=1)})
        else:
            out.append({"k": _pad_seq(k, s_cache), "v": _pad_seq(v, s_cache)})
    return out


def lm_decode_step(p: LM, cfg, caches, token, pos, *, window=None):
    """token: (B,) int; pos: scalar int.  Returns (logits (B, V), caches).
    Under the decode rules the token is split as the caches' batch
    (``launch.specs.distribute_token``); the embedding's vocab partial sums
    are reduced once here, as the prefill's constraint reduces them."""
    x = sharding.logical(_embed_tokens(p, cfg, token), ("batch", "embed"))
    x, caches = transformer.stack_decode(p.blocks, x, cfg, pos=pos,
                                         window=window, caches=caches)
    x = layers.norm_apply(p.norm_f, x, cfg.norm)
    return _unembed(p, cfg, x), caches
