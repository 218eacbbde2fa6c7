"""LSTM inter-arrival forecaster (the ATOM/MASTER/Fifer family; port of
``repro.core.predictors.lstm``).

A small single-layer LSTM regresses the next log-gap from the previous
``seq_len`` log-gaps, trained online in replay batches with a hand-written
Adam (0.9 / 0.999, bias correction, eps 1e-8, lr 1e-2, ``epochs`` passes
over a fixed batch of 128 windows), its gradient by ``torch.autograd``.
Deliberately tiny: the paper's §6.3 notes that heavyweight DL models on
small noisy cold-start datasets underperform.  No TPU kernel is on this
path (the reference runs ``lax.scan``): it is plain torch on ``device``.

A prediction is cached until the next observation (the forward is
deterministic), so a policy that asks every tick runs it once an arrival.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device


def _init_lstm(gen: torch.Generator, in_dim: int, hidden: int, *, device):
    """Normal weights drawn on the CPU from ``gen`` (the same net on every
    device), the forget-gate bias at 1."""
    def normal(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float32)

    scale = (in_dim + hidden) ** -0.5
    b = torch.zeros((4 * hidden,), dtype=torch.float32)
    b[hidden: 2 * hidden] = 1.0                              # forget
    params = {"wx": normal(in_dim, 4 * hidden) * scale,
              "wh": normal(hidden, 4 * hidden) * scale,
              "b": b,
              "wo": normal(hidden, 1) * hidden ** -0.5,
              "bo": torch.zeros((1,), dtype=torch.float32)}
    return {k: v.to(device) for k, v in params.items()}


def _lstm_apply(params, xs):
    """xs: (B, T, 1) -> (B,) prediction of the next value."""
    h = torch.zeros((xs.shape[0], params["wh"].shape[0]), dtype=xs.dtype,
                    device=xs.device)
    c = h
    for t in range(xs.shape[1]):
        z = xs[:, t] @ params["wx"] + h @ params["wh"] + params["b"]
        i, f, g, o = torch.chunk(z, 4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
    return (h @ params["wo"] + params["bo"])[:, 0]


def _train_epoch(params, opt_state, xs, ys, lr: float):
    """One Adam step on the MSE of the windows; returns (params, opt_state,
    loss)."""
    names = sorted(params)
    live = {k: params[k].detach().requires_grad_(True) for k in names}
    loss = torch.mean((_lstm_apply(live, xs) - ys) ** 2)
    grads = dict(zip(names, torch.autograd.grad(loss, [live[k] for k in names])))
    m, v, t = opt_state
    t = t + 1
    tf = torch.tensor(float(t), dtype=torch.float32)
    c1 = (1 - torch.pow(torch.tensor(0.9, dtype=torch.float32), tf)).item()
    c2 = (1 - torch.pow(torch.tensor(0.999, dtype=torch.float32), tf)).item()
    with torch.no_grad():
        m = {k: 0.9 * m[k] + 0.1 * grads[k] for k in names}
        v = {k: 0.999 * v[k] + 0.001 * grads[k] * grads[k] for k in names}
        params = {k: params[k] - lr * (m[k] / c1) / (torch.sqrt(v[k] / c2) + 1e-8)
                  for k in names}
    return params, (m, v, t), loss.detach()


class LSTMPredictor:
    name = "lstm"

    def __init__(self, hidden: int = 16, seq_len: int = 8,
                 train_every: int = 32, epochs: int = 40, seed: int = 0,
                 *, device="cuda"):
        self.device = resolve_device(device)
        self.hidden, self.seq_len = hidden, seq_len
        self.train_every, self.epochs = train_every, epochs
        self.params = _init_lstm(torch.Generator().manual_seed(seed), 1, hidden,
                                 device=self.device)
        z = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.opt_state = (z, {k: torch.zeros_like(p) for k, p in self.params.items()}, 0)
        self.gaps: list = []
        self.last_t: Optional[float] = None
        self._since_train = 0
        self.losses: list = []
        self._cached: Optional[float] = None

    # ------------------------------------------------------------------ #
    def observe(self, t: float) -> None:
        self._cached = None
        if self.last_t is not None:
            self.gaps.append(max(t - self.last_t, 1e-3))
            self._since_train += 1
            if (self._since_train >= self.train_every
                    and len(self.gaps) > self.seq_len + 4):
                self._train()
                self._since_train = 0
        self.last_t = t

    MAX_WINDOWS = 128

    def _windows(self):
        lg = np.log(np.asarray(self.gaps[-512:], np.float32))
        n = len(lg) - self.seq_len
        xs = np.stack([lg[i: i + self.seq_len] for i in range(n)])[..., None]
        ys = lg[self.seq_len:]
        # a fixed batch shape, as the reference keeps for its jitted trainer
        if n >= self.MAX_WINDOWS:
            xs, ys = xs[-self.MAX_WINDOWS:], ys[-self.MAX_WINDOWS:]
        else:
            reps = -(-self.MAX_WINDOWS // n)
            xs = np.tile(xs, (reps, 1, 1))[: self.MAX_WINDOWS]
            ys = np.tile(ys, reps)[: self.MAX_WINDOWS]
        return (torch.from_numpy(np.ascontiguousarray(xs)).to(self.device),
                torch.from_numpy(np.ascontiguousarray(ys)).to(self.device))

    def _train(self):
        xs, ys = self._windows()
        for _ in range(self.epochs):
            self.params, self.opt_state, loss = _train_epoch(
                self.params, self.opt_state, xs, ys, 1e-2)
        self.losses.append(float(loss))

    # ------------------------------------------------------------------ #
    def predict_next(self) -> Optional[float]:
        if self.last_t is None or len(self.gaps) < self.seq_len:
            return None
        if self._cached is None:
            lg = np.log(np.asarray(self.gaps[-self.seq_len:], np.float32))
            xs = torch.from_numpy(lg).to(self.device)[None, :, None]
            with torch.no_grad():
                pred = float(_lstm_apply(self.params, xs)[0])
            self._cached = self.last_t + float(np.exp(np.clip(pred, -7, 9)))
        return self._cached

    def uncertainty(self) -> float:
        if len(self.gaps) < 4:
            return float("inf")
        lg = np.log(np.asarray(self.gaps[-64:], np.float32))
        return float(np.std(lg) * np.mean(self.gaps[-64:]))
