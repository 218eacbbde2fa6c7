"""The transformer next-invocation-gap quantile forecaster (port of
``repro.learn.forecaster``): serving and training.

A small ``models/transformer.py`` stack (2 layers, d_model 32, 4 heads of
8, float32): feature windows project into the stack, the last (most
recent) position reads out through a 3-unit head, and monotone softplus
offsets turn it into ordered ``(q05, q50, q95)`` quantiles of
``log1p(next gap)``.  On the card the stack's attention is the hand flash
kernel (``kernels/csrc/flash_attention.cu``, its fp32 path), one launch a
layer; training (:func:`train_forecaster`, the port's train loop on the
pinball loss) runs it forward and the hand backward kernel
(``kernels/csrc/flash_attention_bwd.cu``) back, in fp32 at (B, 16, 4, 8).

Checkpoints: the JAX package's ``checkpoints/forecaster.npz`` is read
without JAX (``training/checkpoint.read_reference``, its leaves placed in
JAX's flatten order of this model's tree); the port writes its own format
(``training/checkpoint.save``, no pickle).  ``resolve_checkpoint``
implements the discovery order (explicit path > ``REPRO_FORECASTER_CKPT``
> ``checkpoints/forecaster.npz``) used by the serving-side predictor and
the policy catalog.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Iterator, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.learn.features import FeatureConfig
from repro_torch.models import convert, layers, transformer
from repro_torch.models.registry import ModelBundle
from repro_torch.training import checkpoint
from repro_torch.training.optimizer import OptimizerConfig
from repro_torch.training.train_loop import TrainResult, train

CHECKPOINT_ENV = "REPRO_FORECASTER_CKPT"
DEFAULT_CHECKPOINT = os.path.join("checkpoints", "forecaster.npz")
CHECKPOINT_VERSION = 1


def resolve_checkpoint(path: Optional[str] = None) -> Optional[str]:
    """Explicit path > env var > repo-default; None when nothing exists."""
    for cand in (path, os.environ.get(CHECKPOINT_ENV), DEFAULT_CHECKPOINT):
        if cand and os.path.exists(cand):
            return cand
    return None


def model_config(*, num_layers: int = 2, d_model: int = 32,
                 num_heads: int = 4, d_ff: int = 64) -> ModelConfig:
    return ModelConfig(
        name="gap-forecaster", family="dense",
        source="repro.learn in-repo forecaster (arXiv 2504.11338 lineage)",
        num_layers=num_layers, d_model=d_model, num_heads=num_heads,
        d_ff=d_ff, dtype="float32", param_dtype="float32", remat=False)


class Dense(nn.Module):
    """``x @ w + b`` with ``w`` (in, out)."""

    def __init__(self, in_dim: int, out_dim: int, dtype, *, device,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.w = layers.dense_init(gen, in_dim, out_dim, dtype, device=device)
        self.b = layers.zeros_init(out_dim, dtype, device=device)


class Forecaster(nn.Module):
    """Parameters of the forecaster; ``state_dict`` keys ``inp.{w,b}``,
    ``stack.<layer>.{norm1,attn,norm2,ffn}.<leaf>``, ``norm.scale``,
    ``head.{w,b}`` (the JAX tree's names, its stacked layers split)."""

    def __init__(self, cfg: ModelConfig, feat: FeatureConfig, *, device,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        pdt = cfg.param_dtype
        self.inp = Dense(feat.n_features, cfg.d_model, pdt, device=device, gen=gen)
        self.stack = transformer.init_stack(gen, cfg, device=device)
        self.norm = layers.norm_init(cfg.d_model, cfg.norm, pdt, device=device)
        self.head = Dense(cfg.d_model, 3, pdt, device=device, gen=gen)


def init_forecaster(gen: torch.Generator, cfg: ModelConfig, feat: FeatureConfig,
                    *, device="cuda") -> Forecaster:
    return Forecaster(cfg, feat, device=resolve_device(device), gen=gen)


def forecaster_from_state(state, cfg: ModelConfig, feat: FeatureConfig, *,
                          device="cuda") -> Forecaster:
    """A ``Forecaster`` holding ``state`` (a ``state_dict``, e.g. from
    ``convert.params_from_jax``) on ``device``."""
    params = Forecaster(cfg, feat, device=resolve_device(device))
    params.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
    return params


def apply_forecaster(params: Forecaster, x, cfg: ModelConfig, *, train: bool = False):
    """x: (B, W, n_features) -> ordered (B, 3) log-gap quantiles."""
    h = x @ params.inp.w + params.inp.b
    q_pos = torch.arange(x.shape[1], device=x.device, dtype=torch.int32)
    h, _, _ = transformer.stack_full(params.stack, h, cfg, q_pos=q_pos, train=train)
    h = layers.norm_apply(params.norm, h[:, -1, :], cfg.norm)
    raw = h @ params.head.w + params.head.b
    q50 = raw[:, 0]
    q05 = q50 - F.softplus(raw[:, 1])
    q95 = q50 + F.softplus(raw[:, 2])
    return torch.stack([q05, q50, q95], dim=1)


def pinball_loss(q, y, quantiles) -> torch.Tensor:
    """Mean quantile (pinball) loss: q (B, Q), y (B,)."""
    taus = torch.as_tensor(quantiles, dtype=torch.float32, device=q.device)[None, :]
    err = y[:, None] - q
    return torch.mean(torch.maximum(taus * err, (taus - 1.0) * err))


def make_bundle(cfg: ModelConfig, feat: FeatureConfig, *, device="cuda") -> ModelBundle:
    """The forecaster as a ``ModelBundle`` for the train loop: init and the
    pinball loss over ``batch["x"]`` (B, W, n_features), ``batch["y"]`` (B,)."""
    dev = resolve_device(device)

    def loss_fn(params, batch):
        q = apply_forecaster(params, batch["x"], cfg, train=True)
        loss = pinball_loss(q, batch["y"], feat.quantiles)
        tokens = torch.tensor(float(batch["y"].shape[0] * feat.window), device=q.device)
        return loss, {"loss": loss, "tokens": tokens}

    def unsupported(*_a, **_k):
        raise NotImplementedError("the forecaster has no decode path")

    return ModelBundle(cfg=cfg, shape=None, max_seq=feat.window, window=None, device=dev,
                       init=lambda gen: Forecaster(cfg, feat, device=dev, gen=gen),
                       loss=loss_fn, prefill=unsupported, decode_step=unsupported)


def train_forecaster(data_iter: Iterator[Dict[str, Any]], *, steps: int,
                     cfg: Optional[ModelConfig] = None,
                     feat: Optional[FeatureConfig] = None,
                     lr: float = 3e-3, log_every: int = 50, log_fn=print,
                     device="cuda") -> Tuple[Forecaster, TrainResult, ModelConfig,
                                             FeatureConfig]:
    """``steps`` AdamW steps on the pinball loss from weights drawn from seed
    0 on ``device``: the reference's schedule (warm-up to ``lr`` over
    min(100, steps // 10 + 1) steps, cosine decay, weight decay 0.01)."""
    cfg = cfg or model_config()
    feat = feat or FeatureConfig()
    bundle = make_bundle(cfg, feat, device=device)
    opt = OptimizerConfig(lr=lr, warmup_steps=min(100, steps // 10 + 1),
                          total_steps=steps, weight_decay=0.01)
    result = train(bundle, data_iter, steps=steps, opt_cfg=opt, log_every=log_every,
                   log_fn=log_fn or (lambda *_a, **_k: None))
    return result.final_params, result, cfg, feat


def save_forecaster(path: str, params: Forecaster, cfg: ModelConfig,
                    feat: FeatureConfig, *, metrics: Optional[dict] = None) -> int:
    extra = {
        "version": CHECKPOINT_VERSION,
        "model": {"num_layers": cfg.num_layers, "d_model": cfg.d_model,
                  "num_heads": cfg.num_heads, "d_ff": cfg.d_ff},
        "features": feat.to_dict(),
        "metrics": metrics or {},
    }
    return checkpoint.save(path, params.state_dict(), extra=extra)


def load_forecaster(path: str, *, device="cuda") -> Tuple[Forecaster, ModelConfig,
                                                          FeatureConfig, dict]:
    """A forecaster checkpoint, the port's or the JAX package's, on
    ``device``."""
    dev = resolve_device(device)
    reference = checkpoint.is_reference(path)
    if reference:
        leaves, extra = checkpoint.read_reference(path)
    else:
        state, extra = checkpoint.restore(path)
    if extra.get("version") != CHECKPOINT_VERSION:
        raise ValueError(f"{path}: forecaster checkpoint version "
                         f"{extra.get('version')!r} != {CHECKPOINT_VERSION}")
    cfg = model_config(**extra["model"])
    feat = FeatureConfig.from_dict(extra["features"])
    if reference:
        # the JAX tree's structure, from this model's own parameters: the
        # leaves a0, a1, ... follow its sorted-key flatten order
        like = convert.params_to_jax(Forecaster(cfg, feat, device="meta").state_dict(),
                                     transformer.period_len(cfg))
        state = convert.params_from_jax(checkpoint.tree_from_leaves(like, leaves))
    return forecaster_from_state(state, cfg, feat, device=dev), cfg, feat, extra
