"""Mixture-of-Experts FFN (port of ``repro.models.moe``, the single-device
path): top-k routing and sort-based capacity dispatch.

Tokens are cut into groups of at most ``GROUP``; within a group a stable sort
by expert packs them into an ``(experts, capacity, d_model)`` buffer, the
experts run as batched products, and each token takes back its rows weighted
by its renormalised router probabilities.  Tokens past an expert's capacity
drop (Switch-style).  Arctic's dense residual branch runs beside the
experts.  Returns the load-balance auxiliary loss with the output.  The
expert-parallel ``shard_map`` path comes with ROADMAP item A7.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.models import layers

GROUP = 4096  # max tokens per dispatch group


class MoE(nn.Module):
    """``router`` (d, E) fp32; ``wi``, ``wg`` (E, d, ff) and ``wo`` (E, ff, d)
    stacked over experts; ``dense`` the residual MLP where the config has one."""

    def __init__(self, cfg, *, device, gen: Optional[torch.Generator] = None):
        super().__init__()
        m, d, pdt = cfg.moe, cfg.d_model, cfg.param_dtype
        e, ff = m.num_experts, m.expert_ff

        def expert_stack(a, b):
            return layers._param(layers._trunc_normal(gen, (e, a, b), a ** -0.5,
                                                      layers.dt(pdt), device))

        self.router = layers.dense_init(gen, d, e, "float32", device=device)
        self.wi = expert_stack(d, ff)
        self.wo = expert_stack(ff, d)
        if cfg.act == "swiglu":
            self.wg = expert_stack(d, ff)
        if m.dense_residual:
            self.dense = layers.MLP(d, m.dense_residual_ff or cfg.d_ff, cfg.act, pdt,
                                    device=device, gen=gen)


def _capacity(tokens_per_group: int, m) -> int:
    c = int(tokens_per_group * m.top_k * m.capacity_factor / m.num_experts)
    return max(m.top_k, min(c, tokens_per_group))


def _dispatch_group(x, p: MoE, cfg):
    """x: (t, d) one token group -> (y (t, d), aux_loss scalar)."""
    m = cfg.moe
    t, d = x.shape
    e, k = m.num_experts, m.top_k
    cap = _capacity(t, m)

    probs = torch.softmax(x.float() @ p.router, dim=-1)          # (t, E)
    # lax.top_k: the k largest, the lower expert first among equals
    top_w, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_i = top_w[:, :k], top_i[:, :k]
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)

    flat_e = top_i.reshape(t * k)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = torch.bincount(flat_e, minlength=e)                 # (E,)
    offsets = torch.cumsum(counts, 0) - counts                   # exclusive
    pos_in_e = torch.arange(t * k, device=x.device) - offsets[sorted_e]
    keep = pos_in_e < cap
    slot = torch.where(keep, sorted_e * cap + pos_in_e, e * cap)
    tok_idx = order // k

    # row e*cap is the sink of every dropped assignment; it is cut off below
    buf = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=x.device)
    buf[slot] = x[tok_idx]
    buf = buf[: e * cap].reshape(e, cap, d)

    h = torch.bmm(buf, p.wi)
    if hasattr(p, "wg"):
        h = F.silu(h) * torch.bmm(buf, p.wg)
    else:
        h = F.gelu(h, approximate="tanh")
    out = torch.bmm(h, p.wo)

    out_flat = torch.cat([out.reshape(e * cap, d), out.new_zeros((1, d))], dim=0)
    y_sorted = out_flat[slot]                                    # (t*k, d)
    w_sorted = (top_w.reshape(t * k)[order] * keep).float()
    y = torch.zeros((t, d), dtype=torch.float32, device=x.device).index_add_(
        0, tok_idx, y_sorted.float() * w_sorted[:, None])

    # load-balance aux loss (Switch): E * sum_e f_e * p_e
    f = counts.float() / (t * k)
    aux = e * torch.sum(f * probs.mean(dim=0))
    return y.to(x.dtype), aux


def moe_ffn(p: MoE, x, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y (B, S, d), aux_loss scalar)."""
    b, s, d = x.shape
    t = b * s
    gs = min(GROUP, t)
    g = t // gs
    xg = x.reshape(g, gs, d) if g * gs == t else x.reshape(1, t, d)
    ys, auxs = zip(*(_dispatch_group(xx, p, cfg) for xx in xg))
    out = torch.stack(ys).reshape(b, s, d)
    if hasattr(p, "dense"):
        out = out + layers.mlp_apply(p.dense, x, cfg.act)
    return out, cfg.moe.router_aux_weight * torch.stack(auxs).mean()
