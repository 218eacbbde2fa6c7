"""Kernel entry points (the port of ``repro.kernels.ops``).

Same signatures and defaults as the JAX package.  Each op has two paths:

* ``impl="reference"`` or ``"pallas"`` (what the configs name) — the hand
  kernel for a CUDA tensor, its plain torch version for a CPU tensor;
* ``impl="oracle"`` — the naive oracles in ``ref.py``.

``ssm_step`` is plain torch, as it is plain jnp in the JAX package.

Given DTensors (the GSPMD path, ``sharding.py``), ``flash_attention``,
``ssm_scan`` and ``ssm_step`` run through ``local_map``: the inputs are
redistributed to the layout the first one (q, u) asks for, and the same
hand kernel (its autograd function when a gradient is wanted, its plain
version on the CPU) runs on each rank's local shard.  ``decode_attention``
follows the caches' layout instead (the decode rules split their batch and
their rows): each rank runs the decode kernel on its own rows, and where
the rows are split the ranks' partial softmaxes are merged by
:func:`combine_partials`.  Nothing is gathered whole and nothing falls
back: a layout the route cannot split raises.
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
    inputs go through :func:`_decode_sharded`."""
    _check_impl(impl)
    if sharding.is_dtensor(q) or sharding.is_dtensor(k_cache):
        return _decode_sharded(q, k_cache, v_cache, valid_mask, impl)
    return _decode_local(q, k_cache, v_cache, valid_mask, impl)


def _decode_local(q, k_cache, v_cache, valid_mask, impl, stats=False):
    if impl == "oracle":
        return _ref.decode_attention_ref(q, k_cache, v_cache, valid_mask, stats=stats)
    return decode_attention_hopper(q, k_cache, v_cache, valid_mask, stats=stats)


def combine_partials(out, m, l, groups=None, *, dtype=None):
    """Merge partial softmaxes taken over disjoint rows of one cache: each
    part's fp32 normalised output ``out`` (..., D), max score ``m`` and sum
    of exponentials ``l`` (...), as the decode kernel writes them with
    ``stats=True``.  With ``groups`` (process groups) each rank holds its own
    part, and the merge all-reduces over every group: M = max m, then the
    sums of out · w and w with w = l · e^(m - M).  Without, the parts are
    stacked on dim 0 and merged there.  Returns sum(out · w) / max(sum(w),
    1e-30) in ``dtype`` (default: ``out``'s), rounded once.  A part whose
    rows are all masked (m = -1e30) weighs exactly 0 beside a part with a
    valid key; where no part has one, the result is the mean of every V."""
    if groups is None:
        top = m.amax(dim=0)
        w = l * torch.exp(m - top)
        num, den = (out * w[..., None]).sum(dim=0), w.sum(dim=0)
    else:
        import torch.distributed as dist

        top = m.clone()
        for g in groups:
            dist.all_reduce(top, op=dist.ReduceOp.MAX, group=g)
        w = l * torch.exp(m - top)
        both = torch.cat([out * w[..., None], w[..., None]], dim=-1)
        for g in groups:
            dist.all_reduce(both, group=g)
        num, den = both[..., :-1], both[..., -1]
    return (num / den.clamp(min=1e-30)[..., None]).to(dtype or out.dtype)


def _decode_sharded(q, k_cache, v_cache, valid_mask, impl):
    """Decode attention on DTensors through ``local_map``, in the caches'
    layout (``specs.cache_pspec``): a mesh dim that splits their batch splits
    q's and the mask's alike; one that splits their rows (``cache_seq``)
    splits the mask's, and q is whole there.  Each rank runs the kernel on
    its own rows; where a mesh dim splits them, with ``stats=True``, and
    :func:`combine_partials` merges the ranks' softmaxes over that dim's
    process group.  Where the rows are whole (a cross cache, a mesh whose
    row axis has one rank) the kernel runs as on one device.  The output
    is whole over the row-splitting dims.  A plain cache beside a DTensor
    q, and a cache split on any other dim, are refused."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    if not all(map(sharding.is_dtensor, (q, k_cache, v_cache))):
        raise ValueError("decode attention on DTensors takes q and both caches as DTensors: "
                         "place the caches with launch.specs.distribute_caches")
    mesh = k_cache.device_mesh
    qp, kp, mp, groups = [], [], [], []
    for i, p in enumerate(k_cache.placements):
        if p.is_shard(0):
            qp.append(p), kp.append(p), mp.append(p)
        elif p.is_shard(1):
            qp.append(Replicate()), kp.append(p), mp.append(p)
            groups.append(mesh.get_group(i))
        elif p.is_replicate():
            qp.append(p), kp.append(p), mp.append(p)
        else:
            raise ValueError(f"a KV cache placed {k_cache.placements}: decode attention "
                             f"splits a cache's batch or rows only")
    valid_mask = sharding.replicate_like(valid_mask, k_cache)

    def local(q, k, v, mask):
        q, k, v, mask = (t.contiguous() for t in (q, k, v, mask))
        if not groups:
            return _decode_local(q, k, v, mask, impl)
        out, m, l = _decode_local(q, k, v, mask, impl, stats=True)
        return combine_partials(out, m, l, groups, dtype=q.dtype)

    fn = local_map(local, out_placements=qp, in_placements=(qp, kp, kp, mp),
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(q, k_cache, v_cache, valid_mask)


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
    """Single decode step of the selective scan: (B, Din) inputs, fp32 state.
    DTensor inputs go through :func:`_step_sharded`."""
    if sharding.is_dtensor(u):
        return _step_sharded(u, delta, A, B, C, D, h)
    return _step_local(u, delta, A, B, C, D, h)


def _step_sharded(u, delta, A, B, C, D, h):
    """:func:`ssm_step` on DTensors through ``local_map``, each mesh dim
    keeping u's split: of the batch (``B``, ``C`` and the state alike,
    ``A`` / ``D`` whole) or of the channels (``delta``, ``A``, ``D`` and the
    state alike, ``B`` / ``C`` whole)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    rep = Replicate()
    by_split = {0: (Shard(0), rep, Shard(0), rep, Shard(0)),   # u, A, B / C, D, h
                1: (Shard(1), Shard(0), rep, Shard(0), Shard(1))}
    cols = [by_split.get(next((d for d in (0, 1) if p.is_shard(d)), None), (rep,) * 5)
            for p in u.placements]
    up, ap, bp, dp, hp = ([c[i] for c in cols] for i in range(5))
    fn = local_map(_step_local, out_placements=(up, hp),
                   in_placements=(up, up, ap, bp, bp, dp, hp),
                   device_mesh=u.device_mesh, redistribute_inputs=True)
    return fn(u, delta, A, B, C, D, h)


def _step_local(u, delta, A, B, C, D, h):
    uf, df = u.float(), delta.float()
    h = torch.exp(df[..., None] * A.float()[None]) * h \
        + (df * uf)[..., None] * B.float()[:, None, :]
    y = torch.einsum("bdn,bn->bd", h, C.float()) + uf * D.float()[None]
    return y.to(u.dtype), h
