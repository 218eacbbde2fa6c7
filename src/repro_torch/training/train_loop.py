"""Train step and training loop (port of ``repro.training.train_loop``).

``make_train_step`` builds the ``(params, opt_state, batch) -> (params,
opt_state, metrics)`` function: the gradient of ``bundle.loss`` with respect
to every parameter leaf (``torch.autograd.grad`` on the leaves made to
require grad for the step), then one AdamW update written in place into the
model and the optimizer state (``training.optimizer.apply_updates_``: fp32
m / v, bf16 parameters cast back, a slice of a leaf at a time).  Outside a
step the parameters keep ``requires_grad=False``, as serving has them.  On
the card, attention and the selective scan run forward and backward through
their hand kernels; a kernel that has no backward refuses to be
differentiated rather than training without a gradient.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch import sharding
from repro_torch.models.convert import LAYER_STACKED, STACKED
from repro_torch.models.registry import ModelBundle
from repro_torch.training.optimizer import (OptimizerConfig, OptState,
                                            apply_updates_, init_opt_state)


def param_tree(params: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The model's parameter leaves by ``state_dict`` name: the tree the
    optimizer state mirrors."""
    return dict(params.named_parameters())


def decays(tree: Dict[str, torch.Tensor]) -> Dict[str, bool]:
    """Which leaves take weight decay: those the reference decays, the leaves
    of two or more dims of its tree.  That tree stacks each layer's leaves
    over the layers, so a layer's norm scales and biases are 2-D there and
    decay too; the model's own 1-D leaves (the final norm, the forecaster's
    head bias) do not."""
    return {name: p.dim() >= 2 or name.partition(".")[0] in STACKED + LAYER_STACKED
            for name, p in tree.items()}


def to_device(batch: Dict[str, Any], device: torch.device) -> Dict[str, torch.Tensor]:
    """A numpy batch on ``device``, one copy an array."""
    return {k: torch.as_tensor(np.asarray(v)).to(device) for k, v in batch.items()}


def value_and_grad(bundle: ModelBundle, params: torch.nn.Module, batch):
    """``bundle.loss(params, batch)`` and its gradient with respect to every
    parameter leaf: ``(loss, metrics, {name: grad})``.  The leaves require
    grad for this call only; a leaf the loss does not reach (a vision
    projector on a batch without image embeds) has the zero gradient JAX
    gives it.  DTensor parameters (the GSPMD path) get DTensor gradients in
    their own placements; the loss and the metrics come back whole."""
    tree = param_tree(params)
    leaves = list(tree.values())
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss, metrics = bundle.loss(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    grads = {name: torch.zeros_like(p) if g is None else _placed_like(g, p)
             for (name, p), g in zip(tree.items(), grads)}
    metrics = {k: _whole(v.detach()) for k, v in metrics.items()}
    return _whole(loss.detach()), metrics, grads


def _placed_like(g, p):
    """A DTensor gradient in its parameter's placements: a ``Partial`` sum
    reduced (reduce-scattered where the parameter is split, as FSDP's
    gradients are), a split gathered or cut to the parameter's."""
    if sharding.is_dtensor(g) and list(g.placements) != list(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _whole(x):
    """A DTensor scalar (the loss, a metric) as the plain tensor every rank
    holds alike."""
    return x.full_tensor() if sharding.is_dtensor(x) else x


def make_train_step(bundle: ModelBundle, opt_cfg: OptimizerConfig):
    def train_step(params: torch.nn.Module, opt_state: OptState, batch):
        loss, metrics, grads = value_and_grad(bundle, params, batch)
        tree = param_tree(params)
        _, opt_state, opt_metrics = apply_updates_(opt_cfg, tree, grads, opt_state,
                                                   decay=decays(tree))
        del grads
        metrics.update(opt_metrics)
        metrics["total_loss"] = loss
        return params, opt_state, metrics

    return train_step


@dataclass
class TrainResult:
    losses: list
    steps: int
    wall_s: float
    final_params: Any
    tokens_per_s: float
    step_s: list = field(default_factory=list)   # each step's wall seconds


def train(bundle: ModelBundle, data_iter: Iterator[Dict[str, np.ndarray]], *, steps: int,
          opt_cfg: Optional[OptimizerConfig] = None, log_every: int = 10,
          log_fn: Callable[[str], None] = print) -> TrainResult:
    """``steps`` optimizer steps from weights drawn from seed 0 on
    ``bundle.device``; each numpy batch moves to the device once."""
    opt_cfg = opt_cfg or OptimizerConfig(total_steps=steps)
    params = bundle.init(torch.Generator(device=bundle.device).manual_seed(0))
    opt_state = init_opt_state(param_tree(params))
    step_fn = make_train_step(bundle, opt_cfg)
    losses, step_s = [], []
    tokens = 0
    t0 = time.perf_counter()
    for i in range(steps):
        ts = time.perf_counter()
        batch = to_device(next(data_iter), bundle.device)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])          # waits for the step's device work
        tokens += int(metrics["tokens"])
        losses.append(loss)
        step_s.append(time.perf_counter() - ts)
        if log_every and (i % log_every == 0 or i == steps - 1):
            log_fn(f"step {i:5d} loss {loss:.4f} "
                   f"grad_norm {float(metrics['grad_norm']):.3f} "
                   f"lr {float(metrics['lr']):.2e}")
    wall = time.perf_counter() - t0
    return TrainResult(losses, steps, wall, params, tokens / max(wall, 1e-9), step_s)
