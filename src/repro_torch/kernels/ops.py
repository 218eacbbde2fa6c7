"""Kernel entry points (the port of ``repro.kernels.ops``).

Same signatures and defaults as the JAX package.  Each op has two paths:

* ``impl="reference"`` or ``"pallas"`` (what the configs name) — the hand
  kernel for a CUDA tensor, its plain torch version for a CPU tensor;
* ``impl="oracle"`` — the naive oracles in ``ref.py``.

``ssm_step`` is plain torch, as it is plain jnp in the JAX package.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.decode_attention import decode_attention_hopper
from repro_torch.kernels.flash_attention import FlashAttention, flash_attention_hopper
from repro_torch.kernels.ssm_scan import SSMScan, ssm_scan_hopper

IMPLS = ("reference", "pallas", "oracle")


def _check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}; known: {IMPLS}")


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    q_pos=None, kv_pos=None, impl: str = "reference"):
    """Blocked attention. q: (B,Sq,Hq,D), k/v: (B,Skv,Hkv,D) -> (B,Sq,Hq,D).

    With grad mode on and an input that requires grad, the call goes through
    :class:`FlashAttention` (the backward kernel on CUDA, its plain version
    on the CPU); otherwise straight to the forward wrapper."""
    _check_impl(impl)
    sq, skv = q.shape[1], k.shape[1]
    if q_pos is None:
        q_pos = torch.arange(sq, device=q.device) + (skv - sq)
    if kv_pos is None:
        kv_pos = torch.arange(skv, device=q.device)
    if impl == "oracle":
        return _ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                        q_pos=q_pos, kv_pos=kv_pos)
    q_pos = q_pos.to(device=q.device, dtype=torch.int32)
    kv_pos = kv_pos.to(device=q.device, dtype=torch.int32)
    if _build.needs_grad(q, k, v):
        return FlashAttention.apply(q, k, v, q_pos, kv_pos, causal, window)
    return flash_attention_hopper(q, k, v, causal=causal, window=window,
                                  q_pos=q_pos, kv_pos=kv_pos)


def decode_attention(q, k_cache, v_cache, valid_mask, *, impl: str = "reference"):
    """q: (B,Hq,D); caches (B,S,Hkv,D); valid_mask (B,S) -> (B,Hq,D)."""
    _check_impl(impl)
    if impl == "oracle":
        return _ref.decode_attention_ref(q, k_cache, v_cache, valid_mask)
    return decode_attention_hopper(q, k_cache, v_cache, valid_mask)


def ssm_scan(u, delta, A, B, C, D, h0, *, chunk: int = 256,
             impl: str = "reference"):
    """Mamba-1 selective scan.  See ``ref.ssm_scan_ref`` for semantics.

    ``chunk`` is taken for the JAX signature; the hand kernel stages its own
    chunks of time.  Strided views (the splits of a projection) are made
    contiguous here: the kernel's wrapper takes contiguous tensors only (the
    gradient flows back through the copy).  With grad mode on and an input
    that requires grad, the call goes through :class:`SSMScan` (the backward
    kernel on CUDA, its plain version on the CPU); otherwise straight to the
    forward wrapper.
    """
    del chunk
    _check_impl(impl)
    if impl == "oracle":
        return _ref.ssm_scan_ref(u, delta, A, B, C, D, h0)
    args = tuple(x.contiguous() for x in (u, delta, A, B, C, D, h0))
    if _build.needs_grad(*args):
        return SSMScan.apply(*args)
    return ssm_scan_hopper(*args)


def ssm_step(u, delta, A, B, C, D, h):
    """Single decode step of the selective scan: (B, Din) inputs, fp32 state."""
    uf, df = u.float(), delta.float()
    h = torch.exp(df[..., None] * A.float()[None]) * h \
        + (df * uf)[..., None] * B.float()[:, None, :]
    y = torch.einsum("bdn,bn->bd", h, C.float()) + uf * D.float()[None]
    return y.to(u.dtype), h
