"""xLSTM blocks (port of ``repro.models.xlstm``): mLSTM (matrix memory,
``"L"``) and sLSTM (scalar memory, ``"S"``).

Follows arXiv:2405.04517 with exponential gating and a stabiliser state m.
Both are recurrent.  The full-sequence paths walk time in a Python loop of
the same one-step functions that decode uses, in fp32, as the JAX package
runs them under ``lax.scan``; no hand kernel exists for them (the TPU side
has no Pallas kernel either).

Shapes: d_in = proj_factor * d_model, split into H heads of dh = d_in / H.
mLSTM state: C (B, H, dh, dh), n (B, H, dh), m (B, H).
sLSTM state: c, n, m, h (B, d_in) — one stabiliser per cell.
Every state leaf is fp32.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch import sharding
from repro_torch.models import layers

_M0 = -1e30          # initial stabiliser: the first step's forget term is 0
_N0 = 1e-6           # sLSTM's initial normaliser


def _dims(cfg):
    x = cfg.xlstm
    d_in = int(x.proj_factor * cfg.d_model)
    h = x.num_heads
    assert d_in % h == 0
    return d_in, h, d_in // h


def _walk(x, t: int) -> int:
    """The time steps a full-sequence loop walks: all ``t``, or one on a meta
    tensor (the dry run), whose shapes do not depend on the walk's length.
    Every meta op still costs host Python time, and a walk of every step is
    ~20 ops a step and layer over up to 524288 steps; the roofline counts
    the recurrence analytically."""
    return 1 if x.device.type == "meta" else t


def _full(shape, value, *, device):
    return layers._param(torch.full(shape, value, dtype=torch.float32, device=device))


# --------------------------------------------------------------------------- #
# mLSTM
# --------------------------------------------------------------------------- #


class MLSTM(nn.Module):
    """Parameters under the JAX tree's names: ``up`` (x and z halves), ``wq``,
    ``wk``, ``wv``, ``down`` and ``skip`` in ``param_dtype``; the gate
    projections ``w_i``, ``w_f`` and biases ``b_i``, ``b_f`` in fp32."""

    def __init__(self, cfg, *, device, gen: Optional[torch.Generator] = None):
        super().__init__()
        d = cfg.d_model
        d_in, h, _ = _dims(cfg)
        pdt = cfg.param_dtype
        self.up = layers.dense_init(gen, d, 2 * d_in, pdt, device=device)
        self.wq = layers.dense_init(gen, d_in, d_in, pdt, device=device)
        self.wk = layers.dense_init(gen, d_in, d_in, pdt, device=device)
        self.wv = layers.dense_init(gen, d_in, d_in, pdt, device=device)
        self.w_i = layers.dense_init(gen, d_in, h, "float32", device=device)
        self.b_i = _full((h,), 0.0, device=device)
        self.w_f = layers.dense_init(gen, d_in, h, "float32", device=device)
        self.b_f = _full((h,), 3.0, device=device)            # open forget gate
        self.down = layers.dense_init(gen, d_in, d, pdt, scale=d_in ** -0.5,
                                      device=device)
        self.skip = layers._param(torch.ones((d_in,), dtype=layers.dt(pdt),
                                             device=device))


def _mlstm_gates(p: MLSTM, xs):
    """xs: (..., d_in) -> log input gate, log forget gate (..., H) in fp32."""
    xf = xs.float()
    log_i = xf @ p.w_i + p.b_i                               # pre-activation ĩ
    log_f = sharding.pointwise(F.logsigmoid, xf @ p.w_f + p.b_f)  # log σ(f̃)
    return log_i, log_f


def _mlstm_qkv(p: MLSTM, xs, h, dh):
    lead = xs.shape[:-1]
    q = (xs @ p.wq).reshape(*lead, h, dh)
    k = (xs @ p.wk).reshape(*lead, h, dh) * (dh ** -0.5)
    v = (xs @ p.wv).reshape(*lead, h, dh)
    return q, k, v


def _mlstm_step(carry, q, k, v, log_i, log_f):
    """Stabilised mLSTM recurrence, one time step, all fp32."""
    C, n, m = carry                                          # (B,H,dh,dh), (B,H,dh), (B,H)
    m_new = torch.maximum(log_f + m, log_i)
    i_t = torch.exp(log_i - m_new)                           # (B, H)
    f_t = torch.exp(log_f + m - m_new)
    C = f_t[..., None, None] * C + i_t[..., None, None] * (
        v[..., :, None] * k[..., None, :])                   # v k^T
    n = f_t[..., None] * n + i_t[..., None] * k
    num = torch.einsum("bhij,bhj->bhi", C, q)                # read with q over the k dim
    den = torch.abs(torch.einsum("bhj,bhj->bh", n, q))
    h_t = num / torch.maximum(den, torch.exp(-m_new))[..., None]
    return (C, n, m_new), h_t


def init_mlstm_state(cfg, batch: int, *, device):
    _, h, dh = _dims(cfg)
    return {"C": torch.zeros((batch, h, dh, dh), dtype=torch.float32, device=device),
            "n": torch.zeros((batch, h, dh), dtype=torch.float32, device=device),
            "m": torch.full((batch, h), _M0, dtype=torch.float32, device=device)}


def mlstm_forward(p: MLSTM, x, cfg, *, state=None):
    """x: (B, T, d) -> (y (B, T, d), final state {"C", "n", "m"})."""
    d_in, h, dh = _dims(cfg)
    b, t, _ = x.shape
    xs, z = torch.chunk(x @ p.up, 2, dim=-1)
    q, k, v = _mlstm_qkv(p, xs, h, dh)
    log_i, log_f = _mlstm_gates(p, xs)
    if state is None:
        state = {k: sharding.replicate_like(t, x)
                 for k, t in init_mlstm_state(cfg, b, device=x.device).items()}
    carry = (state["C"], state["n"], state["m"])
    q, k, v = q.float(), k.float(), v.float()
    hs = []
    for i in range(_walk(x, t)):
        carry, h_t = _mlstm_step(carry, q[:, i], k[:, i], v[:, i],
                                 log_i[:, i], log_f[:, i])
        hs.append(h_t)
    hs = torch.stack(hs, dim=1).expand(b, t, h, dh).reshape(b, t, d_in).to(x.dtype)
    y = (hs + xs * p.skip[None, None]) * F.silu(z)
    C, n, m = carry
    return y @ p.down, {"C": C, "n": n, "m": m}


def mlstm_step(p: MLSTM, x, state, cfg):
    """One decode step.  x: (B, d) -> (y (B, d), new state).  On DTensors the
    new state leaves in the layout of the state it replaces."""
    d_in, h, dh = _dims(cfg)
    xs, z = torch.chunk(x @ p.up, 2, dim=-1)
    q, k, v = _mlstm_qkv(p, xs, h, dh)
    log_i, log_f = _mlstm_gates(p, xs)
    carry = (state["C"], state["n"], state["m"])
    carry, h_t = _mlstm_step(carry, q.float(), k.float(), v.float(), log_i, log_f)
    h_t = h_t.reshape(x.shape[0], d_in).to(x.dtype)
    y = (h_t + xs * p.skip[None]) * F.silu(z)
    new = dict(zip(("C", "n", "m"), carry))
    return y @ p.down, {k: sharding.like(t, state[k]) for k, t in new.items()}


# --------------------------------------------------------------------------- #
# sLSTM
# --------------------------------------------------------------------------- #


class Gate(nn.Module):
    """One sLSTM gate: ``wx`` (d_in, d_in) on the input, ``wh`` (H, dh, dh)
    block-diagonal per head on the previous hidden state, bias ``b``; fp32."""

    def __init__(self, d_in: int, h: int, dh: int, bias: float, *, device,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.wx = layers.dense_init(gen, d_in, d_in, "float32", device=device)
        wh = torch.empty((h, dh, dh), dtype=torch.float32, device=device)
        if gen is not None:
            wh.normal_(generator=gen).mul_(dh ** -0.5)
        self.wh = layers._param(wh)
        self.b = _full((d_in,), bias, device=device)


class SLSTM(nn.Module):
    """``up`` and ``down`` in ``param_dtype``; the gates ``gi``, ``gf``
    (bias 3: open), ``gz``, ``go`` in fp32."""

    def __init__(self, cfg, *, device, gen: Optional[torch.Generator] = None):
        super().__init__()
        d = cfg.d_model
        d_in, h, dh = _dims(cfg)
        pdt = cfg.param_dtype
        self.up = layers.dense_init(gen, d, 2 * d_in, pdt, device=device)
        self.gi = Gate(d_in, h, dh, 0.0, device=device, gen=gen)
        self.gf = Gate(d_in, h, dh, 3.0, device=device, gen=gen)
        self.gz = Gate(d_in, h, dh, 0.0, device=device, gen=gen)
        self.go = Gate(d_in, h, dh, 0.0, device=device, gen=gen)
        self.down = layers.dense_init(gen, d_in, d, pdt, scale=d_in ** -0.5,
                                      device=device)


def _slstm_step(p: SLSTM, carry, x_t, h_heads):
    """x_t: (B, d_in) fp32; h_heads: (B, H, dh) previous hidden state."""
    c, n, m = carry

    def g(gp: Gate):
        rec = torch.einsum("bhd,hde->bhe", h_heads, gp.wh)
        return x_t @ gp.wx + rec.reshape(x_t.shape[0], -1) + gp.b

    i_pre, f_pre = g(p.gi), g(p.gf)
    z_t = torch.tanh(g(p.gz))
    o_t = torch.sigmoid(g(p.go))
    log_f = sharding.pointwise(F.logsigmoid, f_pre)
    m_new = torch.maximum(log_f + m, i_pre)
    i_t = torch.exp(i_pre - m_new)
    f_t = torch.exp(log_f + m - m_new)
    c = f_t * c + i_t * z_t
    n = f_t * n + i_t
    h_t = o_t * c / torch.clamp(n, min=_N0)
    return (c, n, m_new), h_t


def init_slstm_state(cfg, batch: int, *, device):
    d_in, _, _ = _dims(cfg)
    zero = torch.zeros((batch, d_in), dtype=torch.float32, device=device)
    return {"c": zero, "n": zero + _N0,
            "m": torch.full((batch, d_in), _M0, dtype=torch.float32, device=device),
            "h": zero.clone()}


def slstm_forward(p: SLSTM, x, cfg, *, state=None):
    """x: (B, T, d) -> (y (B, T, d), final state {"c", "n", "m", "h"})."""
    _, h, dh = _dims(cfg)
    b, t, _ = x.shape
    xs, z = torch.chunk(x @ p.up, 2, dim=-1)
    if state is None:
        state = {k: sharding.replicate_like(t, x)
                 for k, t in init_slstm_state(cfg, b, device=x.device).items()}
    carry = (state["c"], state["n"], state["m"])
    h_t = state["h"]
    xf = xs.float()
    hs = []
    for i in range(_walk(x, t)):
        carry, h_t = _slstm_step(p, carry, xf[:, i], h_t.reshape(b, h, dh))
        hs.append(h_t)
    y = torch.stack(hs, dim=1).expand(b, t, h * dh).to(x.dtype) * F.silu(z)
    c, n, m = carry
    return y @ p.down, {"c": c, "n": n, "m": m, "h": h_t}


def slstm_step(p: SLSTM, x, state, cfg):
    """One decode step.  x: (B, d) -> (y (B, d), new state).  On DTensors the
    new state leaves in the layout of the state it replaces."""
    _, h, dh = _dims(cfg)
    b = x.shape[0]
    xs, z = torch.chunk(x @ p.up, 2, dim=-1)
    carry = (state["c"], state["n"], state["m"])
    carry, h_t = _slstm_step(p, carry, xs.float(), state["h"].reshape(b, h, dh))
    y = h_t.to(x.dtype) * F.silu(z)
    new = dict(zip(("c", "n", "m", "h"), (*carry, h_t)))
    return y @ p.down, {k: sharding.like(t, state[k]) for k, t in new.items()}
