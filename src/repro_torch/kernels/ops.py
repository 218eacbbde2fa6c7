"""Kernel entry points (the port of ``repro.kernels.ops``, attention half).

Same signatures and defaults as the JAX package.  Each op has two paths:

* ``impl="reference"`` or ``"pallas"`` (what the configs name) — the hand
  kernel for a CUDA tensor, its plain torch version for a CPU tensor;
* ``impl="oracle"`` — the naive oracles in ``ref.py``.

``ssm_scan`` / ``ssm_step`` come with the SSM slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.decode_attention import decode_attention_hopper
from repro_torch.kernels.flash_attention import flash_attention_hopper

IMPLS = ("reference", "pallas", "oracle")


def _check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}; known: {IMPLS}")


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    q_pos=None, kv_pos=None, impl: str = "reference"):
    """Blocked attention. q: (B,Sq,Hq,D), k/v: (B,Skv,Hkv,D) -> (B,Sq,Hq,D)."""
    _check_impl(impl)
    sq, skv = q.shape[1], k.shape[1]
    if q_pos is None:
        q_pos = torch.arange(sq, device=q.device) + (skv - sq)
    if kv_pos is None:
        kv_pos = torch.arange(skv, device=q.device)
    if impl == "oracle":
        return _ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                        q_pos=q_pos, kv_pos=kv_pos)
    return flash_attention_hopper(
        q, k, v, causal=causal, window=window,
        q_pos=q_pos.to(device=q.device, dtype=torch.int32),
        kv_pos=kv_pos.to(device=q.device, dtype=torch.int32))


def decode_attention(q, k_cache, v_cache, valid_mask, *, impl: str = "reference"):
    """q: (B,Hq,D); caches (B,S,Hkv,D); valid_mask (B,S) -> (B,Hq,D)."""
    _check_impl(impl)
    if impl == "oracle":
        return _ref.decode_attention_ref(q, k_cache, v_cache, valid_mask)
    return decode_attention_hopper(q, k_cache, v_cache, valid_mask)
