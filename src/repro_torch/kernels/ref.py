"""Naive torch oracles for the attention kernels (copy of the attention half
of ``repro.kernels.ref``).

Deliberately naive (O(S^2) score materialisation, repeated kv heads): they
are the correctness reference that the plain versions and the hand kernels
are held against.  The cluster-step and SSM halves come with their slices.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def _gqa_expand(k, num_q_heads):
    """(B, S, Hkv, D) -> (B, S, Hq, D) by repeating kv heads."""
    rep = num_q_heads // k.shape[2]
    return torch.repeat_interleave(k, rep, dim=2)


def attention_mask(q_pos, kv_pos, *, causal: bool, window: Optional[int]):
    """(Sq, Skv) boolean mask from absolute positions."""
    m = torch.ones((q_pos.shape[0], kv_pos.shape[0]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= kv_pos[None, :] <= q_pos[:, None]
    if window is not None:
        m &= kv_pos[None, :] > (q_pos[:, None] - window)
    return m


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None,
                        q_pos=None, kv_pos=None):
    """Naive attention oracle.

    q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D) with Hq % Hkv == 0.
    Returns (B, Sq, Hq, D) in q.dtype; softmax in fp32.
    """
    b, sq, hq, d = q.shape
    skv = k.shape[1]
    if q_pos is None:
        q_pos = torch.arange(sq, device=q.device) + (skv - sq)
    if kv_pos is None:
        kv_pos = torch.arange(skv, device=q.device)
    k = _gqa_expand(k, hq)
    v = _gqa_expand(v, hq)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(d)
    mask = attention_mask(q_pos, kv_pos, causal=causal, window=window)
    scores = torch.where(mask[None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype)


def decode_attention_ref(q, k_cache, v_cache, valid_mask):
    """Single-token decode oracle.

    q: (B, Hq, D); caches: (B, S, Hkv, D); valid_mask: (B, S) bool.
    Returns (B, Hq, D).
    """
    b, hq, d = q.shape
    k = _gqa_expand(k_cache, hq)
    v = _gqa_expand(v_cache, hq)
    scores = torch.einsum("bhd,bshd->bhs", q.float(), k.float()) / math.sqrt(d)
    scores = torch.where(valid_mask[:, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhs,bshd->bhd", probs, v.float())
    return out.to(q.dtype)
