"""GQA attention layer (port of ``repro.models.attention``): full-sequence
and single-token-decode paths, self- and cross-attention.

Cache layout per attention layer:
  ``k``/``v``: (B, S_cache, H_kv, head_dim).  For sliding-window archs the
  cache is a **ring buffer** of ``S_cache == window`` slots; for full
  attention ``S_cache == max_seq``.
Keys are stored *post-RoPE* so decode never re-rotates the cache.
Cross-attention (the encoder-decoder's) attends a fixed, all-valid
(B, S_enc, H_kv, head_dim) key / value pair computed once at prefill.

Under the decode rules a cache is a DTensor split over its batch and its
rows (``cache_seq``): the new key and value are written on the rank that
holds slot ``pos`` (``_write_sharded``), and ``ops.decode_attention`` runs
each rank's rows and merges their softmaxes.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from repro_torch import sharding
from repro_torch.kernels import ops
from repro_torch.models import layers


class Attention(nn.Module):
    """``wq``, ``wk``, ``wv``, ``wo`` and, under ``cfg.qkv_bias``, ``bq``,
    ``bk``, ``bv`` (a cross layer has no biases).  ``d_model`` (with the
    head counts) sizes an encoder layer: its head dim is d_model / heads."""

    def __init__(self, cfg, d_model: Optional[int] = None, *, cross: bool = False,
                 num_heads: Optional[int] = None, num_kv_heads: Optional[int] = None,
                 device, gen: Optional[torch.Generator] = None):
        super().__init__()
        d = d_model or cfg.d_model
        h = num_heads or cfg.num_heads
        hkv = num_kv_heads or cfg.num_kv_heads
        hd = cfg.head_dim if d_model is None else d // h
        pdt = cfg.param_dtype
        self.wq = layers.dense_init(gen, d, h * hd, pdt, device=device)
        self.wk = layers.dense_init(gen, d, hkv * hd, pdt, device=device)
        self.wv = layers.dense_init(gen, d, hkv * hd, pdt, device=device)
        self.wo = layers.dense_init(gen, h * hd, d, pdt, scale=(h * hd) ** -0.5,
                                    device=device)
        if cfg.qkv_bias and not cross:
            self.bq = layers.zeros_init(h * hd, pdt, device=device)
            self.bk = layers.zeros_init(hkv * hd, pdt, device=device)
            self.bv = layers.zeros_init(hkv * hd, pdt, device=device)


def _proj_qkv(p: Attention, x, kv_x, h, hkv, hd):
    b = x.shape[0]
    q = x @ p.wq
    k = kv_x @ p.wk
    v = kv_x @ p.wv
    if hasattr(p, "bq"):
        q = q + p.bq
        k = k + p.bk
        v = v + p.bv
    return (q.reshape(b, -1, h, hd), k.reshape(b, -1, hkv, hd),
            v.reshape(b, -1, hkv, hd))


def full_attention(p: Attention, x, cfg, *, q_pos, causal=True, window=None,
                   kv_x=None, use_rope=True, impl=None, num_heads=None,
                   num_kv_heads=None, return_kv=False):
    """Full-sequence attention (prefill, encoder, cross).

    x: (B, Sq, d); kv_x: (B, Skv, d) for cross-attention (default: x).
    q_pos: (Sq,) absolute positions of the queries (= the keys' when self).
    Cross-attention is non-causal over keys at ``arange(Skv)``, without RoPE.
    """
    h = num_heads or cfg.num_heads
    hkv = num_kv_heads or cfg.num_kv_heads
    hd = p.wq.shape[1] // h
    self_attn = kv_x is None
    kv_in = x if self_attn else kv_x
    q, k, v = _proj_qkv(p, x, kv_in, h, hkv, hd)
    if sharding.is_dtensor(q):
        # the kernel's layout: q split by batch and heads (or, context-
        # parallel, by its rows), k / v by batch and kv heads, their rows whole
        q = sharding.logical(q, ("batch", "attn_seq", "heads", None))
        k, v = (sharding.logical(t, ("batch", None, "kv_heads", None)) for t in (k, v))
    kv_pos = q_pos if self_attn else torch.arange(kv_in.shape[1], device=x.device,
                                                  dtype=torch.int32)
    if use_rope and self_attn:
        cos, sin = (sharding.replicate_like(t, q)
                    for t in layers.rope_cos_sin(q_pos, hd, cfg.rope_theta))
        q = layers.apply_rope(q, cos[None], sin[None])
        k = layers.apply_rope(k, cos[None], sin[None])
    out = ops.flash_attention(q, k, v, causal=causal and self_attn, window=window,
                              q_pos=q_pos, kv_pos=kv_pos,
                              impl=impl or cfg.attention_impl)
    b, sq = x.shape[0], x.shape[1]
    y = out.reshape(b, sq, h * hd) @ p.wo
    if return_kv:
        return y, (k, v)
    return y


def init_cache(cfg, batch: int, max_seq: int, *, window: Optional[int] = None,
               num_heads=None, num_kv_heads=None, dtype=None, device):
    """Zero ``k`` / ``v`` of (batch, S, kv heads, head_dim), S the ring's
    ``window`` slots or ``max_seq``.  ``num_heads`` is the reference's and
    sizes nothing (a cache holds kv heads only)."""
    del num_heads
    s = min(window, max_seq) if window else max_seq
    shape = (batch, s, num_kv_heads or cfg.num_kv_heads, cfg.head_dim)
    dtype = layers.dt(dtype or cfg.dtype)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _position(pos, device) -> torch.Tensor:
    """pos (python int or scalar tensor) as a (1,) int64 tensor on device."""
    if torch.is_tensor(pos):
        return pos.reshape(1).to(device=device, dtype=torch.int64)
    return torch.full((1,), int(pos), dtype=torch.int64, device=device)


def _write_slot(cache, new, slot, first: int = 0):
    """``cache`` (B, S, Hkv, hd) with row ``slot`` (a (1,) tensor) replaced
    by ``new`` (B, 1, Hkv, hd); the rows are ``first .. first + S - 1`` of
    the whole cache.  The masked write of the reference: a slot past the
    cache (pos >= max_seq without a ring) matches nothing, so the new key
    and value are dropped exactly as in JAX, never written out of bounds."""
    idx = torch.arange(first, first + cache.shape[1], device=cache.device)
    hot = (idx == slot)[None, :, None, None]
    return torch.where(hot, new.to(cache.dtype), cache)


def _write_sharded(cache, new, slot):
    """:func:`_write_slot` on a DTensor cache through ``local_map``: each
    rank writes its own rows (offset by ``sharding.shard_offset``), so only
    the rank that holds ``slot`` changes, and the cache keeps its
    placements."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    if not sharding.is_dtensor(cache):
        raise ValueError("a plain KV cache beside DTensor activations: place the caches "
                         "with launch.specs.distribute_caches")
    mesh = cache.device_mesh
    cp = list(cache.placements)
    newp = [p if p.is_shard(0) else Replicate() for p in cp]
    first = sharding.shard_offset(mesh, cp, 1, cache.shape[1])
    fn = local_map(lambda c, n, s: _write_slot(c, n, s, first), out_placements=cp,
                   in_placements=(cp, newp, [Replicate()] * mesh.ndim), device_mesh=mesh,
                   redistribute_inputs=True)
    return fn(cache, new, sharding.replicate_like(slot, cache))


def decode_attention(p: Attention, x, cache, pos, cfg, *, window=None,
                     cross_kv=None, use_rope=True, impl=None, num_heads=None,
                     num_kv_heads=None):
    """One-token decode.  x: (B, d); pos: scalar int (current position).

    Returns (y (B, d), new_cache).  With ``cross_kv = (k, v)`` it attends
    those fixed encoder keys / values, all valid, and returns ``cache``
    unchanged.
    """
    h = num_heads or cfg.num_heads
    hkv = num_kv_heads or cfg.num_kv_heads
    hd = p.wq.shape[1] // h
    b = x.shape[0]
    impl = impl or cfg.attention_impl

    if cross_kv is not None:
        k, v = cross_kv
        q = (x @ p.wq).reshape(b, h, hd)
        valid = torch.ones((b, k.shape[1]), dtype=torch.bool, device=x.device)
        out = ops.decode_attention(q, k, v, valid, impl=impl)
        return out.reshape(b, h * hd) @ p.wo, cache

    posv = _position(pos, x.device)
    q, k, v = _proj_qkv(p, x[:, None, :], x[:, None, :], h, hkv, hd)
    if use_rope:
        cos, sin = (sharding.replicate_like(t, q)
                    for t in layers.rope_cos_sin(posv, hd, cfg.rope_theta))
        q = layers.apply_rope(q, cos[None], sin[None])
        k = layers.apply_rope(k, cos[None], sin[None])
    # the whole cache's rows (a DTensor's shape is its global one): a ring's
    # slot is taken modulo its own length, not the rules' sequence length
    s_cache = cache["k"].shape[1]
    ring = window is not None and s_cache <= window
    slot = (posv % s_cache) if ring else posv
    if sharding.is_dtensor(x):
        k_cache, v_cache = (_write_sharded(cache[n], t, slot) for n, t in (("k", k), ("v", v)))
    else:
        k_cache, v_cache = (_write_slot(cache[n], t, slot) for n, t in (("k", k), ("v", v)))
    idx = torch.arange(s_cache, device=x.device)
    valid = idx <= posv                     # full cache AND ring
    if window is not None and not ring:
        valid &= idx > (posv - window)      # full-size cache, windowed attention
    valid = valid[None].expand(b, s_cache).contiguous()
    out = ops.decode_attention(q.reshape(b, h, hd), k_cache, v_cache, valid, impl=impl)
    y = out.reshape(b, h * hd) @ p.wo
    return y, {"k": k_cache, "v": v_cache}
