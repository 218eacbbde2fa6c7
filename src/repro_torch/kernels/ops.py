"""Kernel entry points (the port of ``repro.kernels.ops``).

Same signatures and defaults as the JAX package.  Each op has two paths:

* ``impl="reference"`` or ``"pallas"`` (what the configs name) — the hand
  kernel for a CUDA tensor, its plain torch version for a CPU tensor;
* ``impl="oracle"`` — the naive oracles in ``ref.py``.

``ssm_step`` is plain torch, as it is plain jnp in the JAX package.

Given DTensors (the GSPMD path, ``sharding.py``), ``flash_attention`` and
``ssm_scan`` run through ``local_map``: the inputs are redistributed to the
layout the first one (q, u) asks for, and the same hand kernel (its
autograd function when a gradient is wanted, its plain version on the CPU)
runs on each rank's local shard.  Nothing is gathered whole and nothing
falls back: a layout the route cannot split raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import sharding
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
    on the CPU); otherwise straight to the forward wrapper.  DTensor inputs
    go through :func:`_flash_sharded`."""
    _check_impl(impl)
    sq, skv = q.shape[1], k.shape[1]
    if q_pos is None:
        q_pos = torch.arange(sq, device=q.device) + (skv - sq)
    if kv_pos is None:
        kv_pos = torch.arange(skv, device=q.device)
    if sharding.is_dtensor(q):
        return _flash_sharded(q, k, v, causal, window, q_pos, kv_pos, impl)
    return _flash_local(q, k, v, causal, window, q_pos, kv_pos, impl)


def _flash_local(q, k, v, causal, window, q_pos, kv_pos, impl):
    if impl == "oracle":
        return _ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                        q_pos=q_pos, kv_pos=kv_pos)
    q_pos = q_pos.to(device=q.device, dtype=torch.int32)
    kv_pos = kv_pos.to(device=q.device, dtype=torch.int32)
    if _build.needs_grad(q, k, v):
        return FlashAttention.apply(q, k, v, q_pos, kv_pos, causal, window)
    return flash_attention_hopper(q, k, v, causal=causal, window=window,
                                  q_pos=q_pos, kv_pos=kv_pos)


def _flash_sharded(q, k, v, causal, window, q_pos, kv_pos, impl):
    """Attention on DTensors through ``local_map``.  Each mesh dim keeps q's
    own split: of the batch (k / v split alike), of the sequence (the
    context-parallel ``attn_seq``: k / v whole, each rank's queries at their
    global ``q_pos``) or of the q heads (k / v split alike where the kv heads
    divide as the q heads do; else whole, and each rank passes the kernel
    the kv head of its q heads' group).  Where k / v are whole but q is
    split, each rank's dk / dv is a partial sum (a ``Partial`` gradient)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    hq, hkv = q.shape[2], k.shape[2]
    group = hq // hkv
    head_ranks = 1
    for i, p in enumerate(q.placements):
        if p.is_shard(2):
            head_ranks *= mesh.size(i)
    kv_split = hkv % head_ranks == 0
    qp, kp, gp = [], [], []
    for p in q.placements:
        if p.is_shard(0) or (p.is_shard(2) and kv_split):
            qp.append(p), kp.append(p), gp.append(p)
        elif p.is_shard(1) or p.is_shard(2):
            qp.append(p), kp.append(Replicate()), gp.append(Partial())
        else:                                   # Replicate, or a Partial to reduce
            qp.append(Replicate()), kp.append(Replicate()), gp.append(Replicate())
    kv_heads = None
    if not kv_split:
        # k / v whole: a rank's q heads must lie in one kv head's group
        hq_local = hq // head_ranks
        if hq % head_ranks or group % hq_local:
            raise ValueError(f"{hq} q heads over {head_ranks} ranks leave a rank q heads "
                             f"of several groups of {group} ({hkv} kv heads)")
        first = sharding.shard_offset(mesh, qp, 2, hq) // group
        kv_heads = slice(first, first + 1)
    posp = [Shard(0) if p.is_shard(1) else Replicate() for p in qp]
    rep = [Replicate()] * mesh.ndim
    q_pos = sharding.replicate_like(q_pos.to(torch.int32), q)
    kv_pos = sharding.replicate_like(kv_pos.to(torch.int32), q)

    def local(q, k, v, q_pos, kv_pos):
        # the kernels take contiguous, 16-byte aligned tensors: a rank's kv
        # head or rows of a split are copied out (a no-op where whole)
        if kv_heads is not None:
            k, v = k[:, :, kv_heads], v[:, :, kv_heads]
        if q_pos.storage_offset():
            q_pos = q_pos.clone()
        return _flash_local(q.contiguous(), k.contiguous(), v.contiguous(), causal, window,
                            q_pos, kv_pos, impl)

    fn = local_map(local, out_placements=qp, device_mesh=mesh, redistribute_inputs=True,
                   in_placements=(qp, kp, kp, posp, rep),
                   in_grad_placements=(qp, gp, gp, posp, rep))
    return fn(q, k, v, q_pos, kv_pos)


def decode_attention(q, k_cache, v_cache, valid_mask, *, impl: str = "reference"):
    """q: (B,Hq,D); caches (B,S,Hkv,D); valid_mask (B,S) -> (B,Hq,D).  DTensor
    inputs raise: decode under the decode rules (caches split over
    ``cache_seq``) needs a softmax combined across ranks (ROADMAP A9)."""
    _check_impl(impl)
    if sharding.is_dtensor(q) or sharding.is_dtensor(k_cache):
        raise NotImplementedError("decode attention on DTensors (decode under the decode "
                                  "rules) is ROADMAP item A9")
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
    forward wrapper.  DTensor inputs go through :func:`_scan_sharded`.
    """
    del chunk
    _check_impl(impl)
    if sharding.is_dtensor(u):
        return _scan_sharded(u, delta, A, B, C, D, h0, impl)
    return _scan_local(u, delta, A, B, C, D, h0, impl)


def _scan_local(u, delta, A, B, C, D, h0, impl):
    if impl == "oracle":
        return _ref.ssm_scan_ref(u, delta, A, B, C, D, h0)
    args = tuple(x.contiguous() for x in (u, delta, A, B, C, D, h0))
    if _build.needs_grad(*args):
        return SSMScan.apply(*args)
    return ssm_scan_hopper(*args)


def _scan_sharded(u, delta, A, B, C, D, h0, impl):
    """The scan on DTensors through ``local_map``.  Each mesh dim keeps u's
    split of the batch or of the channels (``ssm_inner``); a split of time
    is gathered, as the recurrence walks all of it.  A channel split takes
    ``delta``, ``A``, ``D`` and ``h0`` alike and leaves ``B`` / ``C`` whole; a
    batch split leaves ``A`` / ``D`` whole.  The gradients of an input left
    whole on a split mesh dim are each rank's partial sums (``Partial``)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    rep, part = Replicate(), Partial()
    by_split = {  # u's split: (u, A, B / C, D, h0) placements, then A, B / C, D grads
        0: ((Shard(0), rep, Shard(0), rep, Shard(0)), (part, Shard(0), part)),
        2: ((Shard(2), Shard(0), rep, Shard(0), Shard(1)), (Shard(0), part, Shard(0))),
    }
    whole = ((rep,) * 5, (rep,) * 3)
    cols = [by_split.get(next((d for d in (0, 2) if p.is_shard(d)), None), whole)
            for p in u.placements]
    up, ap, bp, dp, hp = ([c[0][i] for c in cols] for i in range(5))
    ag, bg, dg = ([c[1][i] for c in cols] for i in range(3))
    fn = local_map(lambda *a: _scan_local(*a, impl), out_placements=(up, hp),
                   in_placements=(up, up, ap, bp, bp, dp, hp),
                   in_grad_placements=(up, up, ag, bg, bg, dg, hp),
                   device_mesh=u.device_mesh, redistribute_inputs=True)
    return fn(u, delta, A, B, C, D, sharding.replicate_like(h0, u))


def ssm_step(u, delta, A, B, C, D, h):
    """Single decode step of the selective scan: (B, Din) inputs, fp32 state."""
    uf, df = u.float(), delta.float()
    h = torch.exp(df[..., None] * A.float()[None]) * h \
        + (df * uf)[..., None] * B.float()[:, None, :]
    y = torch.einsum("bdn,bn->bd", h, C.float()) + uf * D.float()[None]
    return y.to(u.dtype), h
