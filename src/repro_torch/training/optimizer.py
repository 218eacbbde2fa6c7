"""AdamW + cosine schedule + global-norm clipping on nested dicts of tensors
(port of ``repro.training.optimizer``; no ``torch.optim``).

fp32 optimizer state regardless of param dtype (bf16 params get fp32 m/v
and fp32 update math, then cast back), as the reference keeps it.  A tree
is a nested ``dict`` of tensors; leaves are visited in sorted-key order,
the order JAX flattens a dict in, so the global norm sums in the
reference's order.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, List, NamedTuple

import torch


@dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class OptState(NamedTuple):
    step: torch.Tensor      # int32 scalar
    m: Any
    v: Any


def tree_leaves(tree) -> List[torch.Tensor]:
    """The leaves of a nested dict in sorted-key order (JAX's flatten order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over corresponding leaves of trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def lr_at(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    step = step.to(torch.float32)
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.lr * (cfg.min_lr_frac
                    + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * frac)))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params) -> OptState:
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    step = torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)
    return OptState(step, zeros, tree_map(torch.zeros_like, zeros))


def clip_by_global_norm(grads, max_norm: float):
    total = 0
    for g in tree_leaves(grads):
        total = total + torch.sum(torch.square(g.to(torch.float32)))
    gn = torch.sqrt(total)
    scale = torch.clamp_max(max_norm / torch.clamp_min(gn, 1e-9), 1.0)
    return tree_map(lambda g: g * scale, grads), gn


def apply_updates(cfg: OptimizerConfig, params, grads, state: OptState, decay=None):
    """One AdamW step.  Returns ``(params, state, {"grad_norm", "lr"})``;
    nothing is updated in place.  ``decay``, a tree of bools like
    ``params``, says which leaves take weight decay; by default those of two
    or more dims (the reference's rule on its own tree)."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    step = state.step + 1
    lr = lr_at(cfg, step)
    stepf = step.to(torch.float32)
    b1t = 1 - torch.pow(cfg.b1, stepf)
    b2t = 1 - torch.pow(cfg.b2, stepf)

    def upd(p, g, m, v, dec):
        g = g.to(torch.float32)
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        u = (m / b1t) / (torch.sqrt(v / b2t) + cfg.eps)
        if dec:
            u = u + cfg.weight_decay * p.to(torch.float32)
        newp = p.to(torch.float32) - lr * u
        return newp.to(p.dtype), m, v

    if decay is None:
        decay = tree_map(lambda p: p.dim() >= 2, params)
    out = tree_map(upd, params, grads, state.m, state.v, decay)   # (p, m, v) leaves
    new_p, new_m, new_v = (tree_map(lambda t, i=i: t[i], out) for i in range(3))
    return new_p, OptState(step, new_m, new_v), {"grad_norm": gnorm, "lr": lr}
