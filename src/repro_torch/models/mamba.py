"""Mamba-1 selective-SSM mixer block (port of ``repro.models.mamba``,
Jamba's SSM half).

The full-sequence path runs ``ops.ssm_scan`` (the hand kernel on the card);
decode is one recurrence step (``ops.ssm_step``).  Decode state per layer:
``conv`` (B, d_conv-1, d_in) trailing inputs + ``h`` (B, d_in, N) fp32 SSM
state, O(1) in sequence length.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch import sharding
from repro_torch.kernels import ops
from repro_torch.models import layers


def _dt_rank(cfg) -> int:
    return cfg.ssm.dt_rank or -(-cfg.d_model // 16)


class Mamba(nn.Module):
    """Parameters under the JAX tree's names.  ``dt_w``, ``dt_b``, ``A_log``
    and ``D`` are fp32 whatever ``param_dtype`` is, as in ``init_mamba``."""

    def __init__(self, cfg, *, device, gen: Optional[torch.Generator] = None):
        super().__init__()
        s = cfg.ssm
        d, d_in, n, dtr = cfg.d_model, s.expand * cfg.d_model, s.d_state, _dt_rank(cfg)
        pdt = cfg.param_dtype
        self.in_proj = layers.dense_init(gen, d, 2 * d_in, pdt, device=device)
        conv_w = torch.empty((s.d_conv, d_in), dtype=torch.float32, device=device)
        if gen is not None:
            conv_w.normal_(generator=gen).mul_(s.d_conv ** -0.5)
        self.conv_w = layers._param(conv_w.to(layers.dt(pdt)))
        self.conv_b = layers.zeros_init(d_in, pdt, device=device)
        self.x_proj = layers.dense_init(gen, d_in, dtr + 2 * n, pdt, device=device)
        self.dt_w = layers.dense_init(gen, dtr, d_in, "float32", device=device)
        self.dt_b = layers._param(torch.full((d_in,), math.log(math.expm1(0.01)),
                                             dtype=torch.float32, device=device))
        a = torch.arange(1, n + 1, dtype=torch.float32, device=device)
        self.A_log = layers._param(torch.log(a)[None].repeat(d_in, 1))  # A = -exp(A_log)
        self.D = layers._param(torch.ones((d_in,), dtype=torch.float32, device=device))
        self.out_proj = layers.dense_init(gen, d_in, d, pdt, scale=d_in ** -0.5,
                                          device=device)


def _softplus(x):
    """``jax.nn.softplus``: log(1 + e^x) with no linear threshold."""
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return torch.logaddexp(x, sharding.replicate_like(zero, x))


def _split_xproj(p: Mamba, xs, cfg):
    s = cfg.ssm
    dtr = _dt_rank(cfg)
    proj = xs @ p.x_proj
    dt_low, b, c = torch.split(proj, [dtr, s.d_state, s.d_state], dim=-1)
    dt = _softplus(dt_low.float() @ p.dt_w + p.dt_b)
    return dt, b, c


def _causal_conv(xs, conv_w, conv_b):
    """silu of the causal depthwise conv over time of xs (B, T, d_in), summed
    in the reference's order, and the conv state (the last d_conv - 1
    inputs)."""
    t, d_conv = xs.shape[1], conv_w.shape[0]
    pad = d_conv - 1
    xp = F.pad(xs, (0, 0, pad, 0))
    conv = sum(xp[:, i: i + t, :] * conv_w[i][None, None] for i in range(d_conv))
    return F.silu(conv + conv_b[None, None]), (xp[:, t:, :] if pad == 0 else xp[:, -pad:, :])


def _causal_conv_sharded(xs, conv_w, conv_b):
    """:func:`_causal_conv` on DTensors through ``local_map``: each rank
    convolves its batch rows and channels (``ssm_inner``) over the whole time
    axis (a split of time is gathered); the weights' gradients are partial
    sums where the batch is split."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    xp, wp, bp, wg = [], [], [], []
    for p in xs.placements:
        if p.is_shard(0):
            xp.append(p), wp.append(Replicate()), bp.append(Replicate()), wg.append(Partial())
        elif p.is_shard(2):
            xp.append(p), wp.append(Shard(1)), bp.append(Shard(0)), wg.append(None)
        else:
            xp.append(Replicate()), wp.append(Replicate()), bp.append(Replicate())
            wg.append(Replicate())
    fn = local_map(_causal_conv, out_placements=(xp, xp), in_placements=(xp, wp, bp),
                   in_grad_placements=(xp, [g or w for g, w in zip(wg, wp)],
                                       [g or b for g, b in zip(wg, bp)]),
                   device_mesh=xs.device_mesh, redistribute_inputs=True)
    return fn(xs, conv_w, conv_b)


def mamba_forward(p: Mamba, x, cfg, *, h0=None):
    """x: (B, T, d) -> (y (B, T, d), final state {"conv", "h"})."""
    s = cfg.ssm
    b, d = x.shape[0], x.shape[2]
    d_in = s.expand * d
    xs, z = torch.chunk(x @ p.in_proj, 2, dim=-1)             # (B, T, d_in) x2
    xs = sharding.logical(xs, ("batch", "seq", "ssm_inner"))
    if sharding.is_dtensor(xs):
        xs, conv_state = _causal_conv_sharded(xs, p.conv_w, p.conv_b)
    else:
        xs, conv_state = _causal_conv(xs, p.conv_w, p.conv_b)

    dt, bm, cm = _split_xproj(p, xs, cfg)
    A = -torch.exp(p.A_log)
    if h0 is None:
        h0 = torch.zeros((b, d_in, s.d_state), dtype=torch.float32, device=x.device)
    y, hT = ops.ssm_scan(xs, dt, A, bm, cm, p.D, h0, impl=cfg.attention_impl)
    out = (y * F.silu(z)) @ p.out_proj
    return out, {"conv": conv_state, "h": hT}


def init_mamba_state(cfg, batch: int, *, device):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    return {
        "conv": torch.zeros((batch, s.d_conv - 1, d_in), dtype=layers.dt(cfg.dtype),
                            device=device),
        "h": torch.zeros((batch, d_in, s.d_state), dtype=torch.float32, device=device),
    }


def _conv_step(conv, xs, conv_w, conv_b):
    """silu of one step of the causal conv: the window is the conv state
    (B, d_conv-1, d_in) and the new input xs (B, d_in).  Returns it and the
    new state (the window's last d_conv - 1 inputs)."""
    window = torch.cat([conv, xs[:, None, :]], dim=1)         # (B, d_conv, d_in)
    y = torch.einsum("bcd,cd->bd", window, conv_w.to(window.dtype))
    return F.silu(y + conv_b[None]), window[:, 1:, :]


def _conv_step_sharded(conv, xs, conv_w, conv_b):
    """:func:`_conv_step` on DTensors through ``local_map``: each rank takes
    its batch rows and channels (``ssm_inner``) of the window; the new state
    comes back in xs's split, for the caller to place."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    rep = Replicate()
    by_split = {0: (Shard(0), Shard(0), rep, rep),             # xs, conv, conv_w, conv_b
                1: (Shard(1), Shard(2), Shard(1), Shard(0))}
    cols = [by_split.get(next((d for d in (0, 1) if p.is_shard(d)), None), (rep,) * 4)
            for p in xs.placements]
    xp, cp, wp, bp = ([c[i] for c in cols] for i in range(4))
    fn = local_map(_conv_step, out_placements=(xp, cp), in_placements=(cp, xp, wp, bp),
                   device_mesh=xs.device_mesh, redistribute_inputs=True)
    return fn(conv, xs, conv_w, conv_b)


def mamba_step(p: Mamba, x, state, cfg):
    """One decode step.  x: (B, d) -> (y (B, d), new state).  On DTensors the
    new state leaves in the layout of the state it replaces."""
    xs, z = torch.chunk(x @ p.in_proj, 2, dim=-1)             # (B, d_in)
    if sharding.is_dtensor(xs):
        xs = sharding.logical(xs, ("batch", "ssm_inner"))
        xs1, conv = _conv_step_sharded(state["conv"], xs, p.conv_w, p.conv_b)
    else:
        xs1, conv = _conv_step(state["conv"], xs, p.conv_w, p.conv_b)
    dt, bm, cm = _split_xproj(p, xs1, cfg)
    A = -torch.exp(p.A_log)
    y, h = ops.ssm_step(xs1, dt, A, bm, cm, p.D, state["h"])
    out = (y * F.silu(z)) @ p.out_proj
    return out, {"conv": sharding.like(conv, state["conv"]), "h": sharding.like(h, state["h"])}
