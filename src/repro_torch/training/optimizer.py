"""AdamW + cosine schedule + global-norm clipping on nested dicts of tensors
(port of ``repro.training.optimizer``; no ``torch.optim``).

fp32 optimizer state regardless of param dtype (bf16 params get fp32 m/v
and fp32 update math, then cast back), as the reference keeps it.  A tree
is a nested ``dict`` of tensors; leaves are visited in sorted-key order,
the order JAX flattens a dict in, so the global norm sums in the
reference's order.

DTensor trees (the GSPMD path) keep their placements: the state mirrors the
parameters, the global norm sums each element once (a shard's sum is a
``Partial`` term, a replicated leaf's is counted once, not once a rank), and
the in-place update runs on each rank's local shards, exact because AdamW is
element-wise and m / v are split as p is.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, List, NamedTuple

import torch

from repro_torch.sharding import is_dtensor


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


def _zeros_f32(p):
    if is_dtensor(p):                  # the parameter's placements, fp32
        return torch.zeros_like(p, dtype=torch.float32, requires_grad=False)
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _local(x):
    """A DTensor's local shard (a view of its storage), or ``x``."""
    return x.to_local() if is_dtensor(x) else x


def init_opt_state(params) -> OptState:
    zeros = tree_map(_zeros_f32, params)
    step = torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)
    return OptState(step, zeros, tree_map(torch.zeros_like, zeros))


def global_norm(grads) -> torch.Tensor:
    """The gradients' global norm, summed in fp32 over the leaves in
    sorted-key order (the reference's order)."""
    total = 0
    for g in tree_leaves(grads):
        sq = torch.sum(torch.square(g.to(torch.float32)))
        total = total + (sq.full_tensor() if is_dtensor(sq) else sq)
    return torch.sqrt(total)


def _clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp_max(max_norm / torch.clamp_min(gn, 1e-9), 1.0)


def clip_by_global_norm(grads, max_norm: float):
    """The gradients scaled to a global norm of at most ``max_norm``, each in
    fp32 (the reference's ``g * scale`` promotes a bf16 leaf to fp32), and
    the norm."""
    gn = global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    return tree_map(lambda g: g.to(torch.float32) * scale, grads), gn


def _terms(cfg: OptimizerConfig, params, grads, state: OptState, decay):
    """What every leaf's update shares: the step, the global norm, the decay
    tree (by default the leaves of two or more dims, the reference's rule on
    its own tree) and ``_adamw``'s (scale, lr, b1t, b2t)."""
    gnorm = global_norm(grads)
    step = state.step + 1
    stepf = step.to(torch.float32)
    if decay is None:
        decay = tree_map(lambda p: p.dim() >= 2, params)
    return step, gnorm, decay, (_clip_scale(gnorm, cfg.clip_norm), lr_at(cfg, step),
                                1 - torch.pow(cfg.b1, stepf), 1 - torch.pow(cfg.b2, stepf))


def _adamw(cfg: OptimizerConfig, p, g, m, v, dec: bool, scale, lr, b1t, b2t):
    """One leaf's (or one slice's) AdamW arithmetic: the clip's ``scale`` on
    the fp32 gradient, the moments, the bias-corrected update, the decay
    where ``dec``; returns the new p (in p's dtype), m and v."""
    g = g.to(torch.float32) * scale
    m = cfg.b1 * m + (1 - cfg.b1) * g
    v = cfg.b2 * v + (1 - cfg.b2) * g * g
    u = (m / b1t) / (torch.sqrt(v / b2t) + cfg.eps)
    if dec:
        u = u + cfg.weight_decay * p.to(torch.float32)
    newp = p.to(torch.float32) - lr * u
    return newp.to(p.dtype), m, v


def apply_updates(cfg: OptimizerConfig, params, grads, state: OptState, decay=None):
    """One AdamW step.  Returns ``(params, state, {"grad_norm", "lr"})``;
    nothing is updated in place (the DQN agent keeps its target network as
    the tree it passes in).  ``decay``, a tree of bools like ``params``,
    says which leaves take weight decay."""
    step, gnorm, decay, terms = _terms(cfg, params, grads, state, decay)
    out = tree_map(lambda p, g, m, v, dec: _adamw(cfg, p, g, m, v, dec, *terms),
                   params, grads, state.m, state.v, decay)      # (p, m, v) leaves
    new_p, new_m, new_v = (tree_map(lambda t, i=i: t[i], out) for i in range(3))
    return new_p, OptState(step, new_m, new_v), {"grad_norm": gnorm, "lr": terms[1]}


SLICE = 1 << 26   # elements of a leaf that apply_updates_ updates at once


def apply_updates_(cfg: OptimizerConfig, params, grads, state: OptState, decay=None):
    """:func:`apply_updates` in place: every leaf of ``params``, ``state.m``
    and ``state.v`` is written where it lies, leaf by leaf in sorted-key
    order and SLICE elements at a time, so that the fp32 temporaries stay
    those of one slice (the reference's jit donates the buffers for the same
    end).  The global norm is summed over every leaf before any is written;
    no clipped tree is built.  The arithmetic is :func:`apply_updates`'s
    (``_adamw``), so the two agree bit for bit.  Returns ``(params,
    OptState(step, m, v), {"grad_norm", "lr"})`` with the same tensors."""
    with torch.no_grad():
        step, gnorm, decay, terms = _terms(cfg, params, grads, state, decay)
        for p, g, m, v, dec in zip(*(tree_leaves(t) for t in (params, grads, state.m,
                                                                state.v, decay))):
            pf, mf, vf = (_local(x).view(-1) for x in (p, m, v))  # raises rather than copy
            gf = _local(g).reshape(-1)
            for i in range(0, pf.numel(), SLICE):
                part = slice(i, i + SLICE)
                newp, newm, newv = _adamw(cfg, pf[part], gf[part], mf[part], vf[part], dec,
                                          *terms)
                pf[part].copy_(newp)
                mf[part].copy_(newm)
                vf[part].copy_(newv)
    return params, OptState(step, state.m, state.v), {"grad_norm": gnorm, "lr": terms[1]}
