"""Shared building blocks (port of ``repro.models.layers``): inits, norms,
MLPs, RoPE, learned and sinusoidal positions.

Weights are stored ``(in_dim, out_dim)`` as in the JAX package and applied as
``x @ w`` (no ``nn.Linear``), so a JAX parameter tree carries over without
transposes.  Compute runs in ``cfg.dtype`` with fp32 reductions in the norms.
Modules are parameter holders: built with a ``torch.Generator`` they draw
their weights from it; built without one (e.g. on the meta device) they are
left empty for ``load_state_dict(..., assign=True)``.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.kernels._build import needs_grad

def dt(name: str) -> torch.dtype:
    return getattr(torch, name)


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


# --------------------------------------------------------------------------- #
# initialisers
# --------------------------------------------------------------------------- #


def _trunc_normal(gen, shape, std, dtype, device):
    w = torch.empty(shape, dtype=torch.float32, device=device)
    if gen is not None:
        nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
        w.mul_(std)
    return w.to(dtype)


def dense_init(gen: Optional[torch.Generator], in_dim: int, out_dim: int,
               dtype="float32", scale: Optional[float] = None, *, device) -> nn.Parameter:
    """Truncated-normal fan-in init (the MaxText/T5 default), ``(in, out)``."""
    std = scale if scale is not None else in_dim ** -0.5
    return _param(_trunc_normal(gen, (in_dim, out_dim), std, dt(dtype), device))


def embed_init(gen: Optional[torch.Generator], vocab: int, d_model: int,
               dtype="float32", *, device) -> nn.Parameter:
    return _param(_trunc_normal(gen, (vocab, d_model), d_model ** -0.5,
                                dt(dtype), device))


def zeros_init(n: int, dtype="float32", *, device) -> nn.Parameter:
    return _param(torch.zeros((n,), dtype=dt(dtype), device=device))


# --------------------------------------------------------------------------- #
# norms: fp32 reductions forward; the backward is the reference's custom VJP,
# x.dtype pointwise math with fp32 reductions (in bf16 its gradients, not
# autograd's through an fp32 upcast)
# --------------------------------------------------------------------------- #

_NORM_EPS = 1e-6


class Norm(nn.Module):
    def __init__(self, d_model: int, kind: str, dtype="float32", *, device):
        super().__init__()
        self.scale = _param(torch.ones((d_model,), dtype=dt(dtype), device=device))
        if kind != "rmsnorm":
            self.bias = zeros_init(d_model, dtype, device=device)


def norm_init(d_model: int, kind: str, dtype="float32", *, device) -> Norm:
    return Norm(d_model, kind, dtype, device=device)


def _mean_last_f32(a, b):
    """mean over the last dim of a*b, accumulated and returned in fp32."""
    return (a.float() * b.float()).sum(-1, keepdim=True) / a.shape[-1]


def _sum_lead_f32(t, dtype):
    """``t`` summed in fp32 over every dim but the last, cast to ``dtype``."""
    return t.float().sum(dim=tuple(range(t.dim() - 1))).to(dtype)


def _rmsnorm(x, scale):
    # inv is cast to x.dtype BEFORE the multiply, as the reference does
    inv = torch.rsqrt(_mean_last_f32(x, x) + _NORM_EPS).to(x.dtype)
    return x * inv * scale.to(x.dtype), inv


def _layernorm(x, scale, bias):
    d = x.shape[-1]
    mean = x.float().sum(-1, keepdim=True) / d
    var = torch.clamp(_mean_last_f32(x, x) - mean * mean, min=0.0)
    inv = torch.rsqrt(var + _NORM_EPS).to(x.dtype)
    mean = mean.to(x.dtype)
    return (x - mean) * inv * scale.to(x.dtype) + bias.to(x.dtype), inv, mean


class RMSNorm(torch.autograd.Function):
    """``repro.models.layers._rmsnorm`` with its custom VJP (``_rmsnorm_bwd``)."""

    @staticmethod
    def forward(ctx, x, scale):
        y, inv = _rmsnorm(x, scale)
        ctx.save_for_backward(x, inv, scale)
        return y

    @staticmethod
    def backward(ctx, g):
        x, inv, scale = ctx.saved_tensors
        xn = x * inv
        g2 = g * scale.to(g.dtype)
        dot = _mean_last_f32(g2, xn).to(g.dtype)
        dx = (inv * (g2 - xn * dot)).to(x.dtype)
        return dx, _sum_lead_f32(g * xn, scale.dtype)


class LayerNorm(torch.autograd.Function):
    """``repro.models.layers._layernorm`` with its custom VJP (``_layernorm_bwd``)."""

    @staticmethod
    def forward(ctx, x, scale, bias):
        y, inv, mean = _layernorm(x, scale, bias)
        ctx.save_for_backward(x, inv, mean, scale)
        return y

    @staticmethod
    def backward(ctx, g):
        x, inv, mean, scale = ctx.saved_tensors
        xn = (x - mean) * inv
        g2 = g * scale.to(g.dtype)
        m1 = (g2.float().sum(-1, keepdim=True) / g2.shape[-1]).to(g.dtype)
        m2 = _mean_last_f32(g2, xn).to(g.dtype)
        dx = (inv * (g2 - m1 - xn * m2)).to(x.dtype)
        return dx, _sum_lead_f32(g * xn, scale.dtype), _sum_lead_f32(g, scale.dtype)


def norm_apply(params: Norm, x, kind: str, eps: float = 1e-6):
    """The norm; through its autograd function only where a gradient is
    wanted (serving runs the same forward without building one).  ``eps`` is
    taken for the reference's signature and ignored, as there: the norms'
    epsilon is fixed at ``_NORM_EPS``."""
    del eps
    if kind == "rmsnorm":
        if needs_grad(x, params.scale):
            return RMSNorm.apply(x, params.scale)
        return _rmsnorm(x, params.scale)[0]
    if needs_grad(x, params.scale, params.bias):
        return LayerNorm.apply(x, params.scale, params.bias)
    return _layernorm(x, params.scale, params.bias)[0]


# --------------------------------------------------------------------------- #
# MLP (SwiGLU / GELU)
# --------------------------------------------------------------------------- #


class MLP(nn.Module):
    def __init__(self, d_model: int, d_ff: int, act: str, dtype="float32", *,
                 device, gen: Optional[torch.Generator] = None):
        super().__init__()
        self.wi = dense_init(gen, d_model, d_ff, dtype, device=device)
        self.wo = dense_init(gen, d_ff, d_model, dtype, device=device)
        if act == "swiglu":
            self.wg = dense_init(gen, d_model, d_ff, dtype, device=device)


def mlp_apply(params: MLP, x, act: str):
    h = x @ params.wi
    if act == "swiglu":
        h = F.silu(h) * (x @ params.wg)
    else:
        h = F.gelu(h, approximate="tanh")   # jax.nn.gelu's default
    return h @ params.wo


# --------------------------------------------------------------------------- #
# rotary position embedding (half-split, not interleaved)
# --------------------------------------------------------------------------- #


@functools.lru_cache(maxsize=None)
def _rope_freqs(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    """Inverse frequencies, computed in numpy fp32 exactly as the reference
    does, and copied to the device once (never mutated by callers)."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))
    return torch.from_numpy(freqs).to(device)


def rope_cos_sin(positions, head_dim: int, theta: float, dtype=torch.float32):
    """positions: int tensor (...,) -> cos/sin of shape (..., head_dim//2)."""
    freqs = _rope_freqs(head_dim, float(theta), positions.device)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def apply_rope(x, cos, sin):
    """x: (..., S, H, head_dim); cos/sin: (..., S, head_dim//2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :]  # broadcast over heads
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# --------------------------------------------------------------------------- #
# learned absolute positions (whisper-style decoders)
# --------------------------------------------------------------------------- #


def posembed_init(gen: Optional[torch.Generator], max_len: int, d_model: int,
                  dtype="float32", *, device) -> nn.Parameter:
    """N(0, 1) in fp32, cast to ``dtype``, then scaled by 0.02 in ``dtype``
    (the reference's order of operations)."""
    w = torch.empty((max_len, d_model), dtype=torch.float32, device=device)
    if gen is not None:
        w.normal_(generator=gen)
    return _param(w.to(dt(dtype)) * 0.02)


@functools.lru_cache(maxsize=16)
def _sinusoids(length: int, d_model: int, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    pos = np.arange(length)[:, None]
    dim = np.arange(d_model // 2)[None, :]
    inv = np.exp(-np.log(10000.0) * dim / max(1, d_model // 2 - 1))
    ang = pos * inv
    emb = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.from_numpy(emb).to(device=device, dtype=dtype)


def sinusoid_embed(length: int, d_model: int, dtype=torch.float32, *,
                   device="cpu") -> torch.Tensor:
    """Whisper encoder sinusoids (length, d_model), computed in float64 with
    numpy exactly as the reference does, then cast once (bit-equal in fp32).
    The cached tensor is shared: callers must not write to it."""
    return _sinusoids(length, d_model, dtype, torch.device(device))
