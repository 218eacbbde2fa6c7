"""The plain reference: a decoder-only dense LM in plain PyTorch, float32.

It imports nothing of the program.  Its sizes come from the configuration
file, and it works the weights out again from the engine's seed, drawing
them in the order and with the initialisers that define the served model:
every matrix truncated-normal at fan-in scale in float32, cast to the
configuration's ``torch_dtype``; norms at one and zero.  It keeps them in
that type and computes in float32 (TF32 off), a layer at a time over all
the sampled rows, in blocks of rows that fit.

What it computes is the served model's answer for a prompt of ``S`` tokens
and the tokens served after it: the engine's decode cache holds ``S`` rows
(``max_seq`` is the prompt's length), so the key and value of each decoded
token fall past the cache and are dropped, and a decoded token attends the
prompt's keys alone.  Position ``i`` of the row therefore attends the keys
``j <= i`` with ``j < S``: causal over the prompt, the prompt alone after it.

``precision="fp8"`` is the control: every matrix product with both operands
rounded to float8 e4m3 (weights by output column, activations by row, each
scaled to its largest magnitude), the step below the served bfloat16.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List

import numpy as np
import torch

FP8_MAX = 448.0


def _q8(t: torch.Tensor, dim: int) -> torch.Tensor:
    scale = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def _trunc_normal(gen, shape, std, dtype, device) -> torch.Tensor:
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return w.mul_(std).to(dtype)


class DenseLM:
    def __init__(self, config: Dict[str, Any], *, device, seed: int = 0):
        self.c = config
        self.device = torch.device(device)
        d, hq, hkv, hd = (config["hidden_size"], config["num_attention_heads"],
                          config["num_key_value_heads"], config["head_dim"])
        ff, vocab = config["intermediate_size"], config["vocab_size"]
        self.gated = config["hidden_act"] == "silu"
        self.rms = config["norm"] == "rmsnorm"
        self.eps = float(config.get("rms_norm_eps", config.get("norm_epsilon")))
        dtype = getattr(torch, config["torch_dtype"])
        gen = torch.Generator(device=self.device).manual_seed(seed)

        def dense(i, o, std=None):
            return _trunc_normal(gen, (i, o), i ** -0.5 if std is None else std, dtype,
                                 self.device)

        self.embed = _trunc_normal(gen, (vocab, d), d ** -0.5, dtype, self.device)
        self.layers: List[Dict[str, torch.Tensor]] = []
        for _ in range(config["num_hidden_layers"]):
            w = {"wq": dense(d, hq * hd), "wk": dense(d, hkv * hd), "wv": dense(d, hkv * hd),
                 "wo": dense(hq * hd, d, (hq * hd) ** -0.5),
                 "wi": dense(d, ff), "w2": dense(ff, d)}
            if self.gated:
                w["wg"] = dense(d, ff)
            self.layers.append(w)
        self.head = None if config["tie_word_embeddings"] else dense(d, vocab)
        half = hd // 2
        freqs = 1.0 / (float(config["rope_theta"])
                       ** (np.arange(0, half, dtype=np.float32) / half))
        self.freqs = torch.from_numpy(freqs).to(self.device)

    # ------------------------------------------------------------------ #
    def _norm(self, x: torch.Tensor) -> torch.Tensor:
        if self.rms:
            return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + self.eps)
        mean = x.mean(-1, keepdim=True)
        var = ((x - mean) ** 2).mean(-1, keepdim=True)
        return (x - mean) * torch.rsqrt(var + self.eps)

    def _rope(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        ang = pos.float()[:, None] * self.freqs
        c, s = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
        half = x.shape[-1] // 2
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)

    def _attention(self, q, k, v, prompt_len: int) -> torch.Tensor:
        """q (R, L, Hq, D), k / v (R, L, Hkv, D): position i attends the
        keys j <= i with j < prompt_len, in chunks of queries, each against
        the keys it can reach."""
        r, n, hq, hd = q.shape
        group = hq // k.shape[2]
        k = torch.repeat_interleave(k, group, dim=2)
        v = torch.repeat_interleave(v, group, dim=2)
        q = q * (1.0 / math.sqrt(hd))
        out = torch.empty_like(q)
        chunk = max(1, int(5e8 // (r * hq * n * 4)))
        for a in range(0, n, chunk):
            b = min(n, a + chunk)
            keys = min(b, prompt_len)
            s = torch.einsum("rqhd,rkhd->rhqk", q[:, a:b], k[:, :keys])
            qi = torch.arange(a, b, device=q.device)[:, None]
            s.masked_fill_(torch.arange(keys, device=q.device)[None, :] > qi, float("-inf"))
            out[:, a:b] = torch.einsum("rhqk,rkhd->rqhd", s.softmax(-1), v[:, :keys])
        return out

    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def logits(self, prompts: np.ndarray, served: np.ndarray, *,
               precision: str = "fp32") -> torch.Tensor:
        """(R, n, vocab) float32 logits at the positions that chose the ``n``
        served tokens of each row: the prompt's last, then each served token
        but the last, fed back."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"precision {precision!r}: fp32 (reference) or fp8 (control)")
        c = self.c
        hq, hkv, hd = c["num_attention_heads"], c["num_key_value_heads"], c["head_dim"]
        rows, prompt_len = prompts.shape
        tokens = torch.from_numpy(np.concatenate([prompts, served[:, :-1]], axis=1)).to(
            self.device, torch.int64)
        n = tokens.shape[1]
        pos = torch.arange(n, device=self.device)
        x = self.embed[tokens].float()                               # (R, L, d)
        block = max(1, int(2e9 // (n * max(c["intermediate_size"], hq * hd) * 4)))

        def prep(w):
            w = w.float()
            return _q8(w, 0) if precision == "fp8" else w

        def mm(a, w):
            return (_q8(a, -1) if precision == "fp8" else a) @ w

        for layer in self.layers:
            w = {name: prep(t) for name, t in layer.items()}
            for r0 in range(0, rows, block):
                xb = x[r0:r0 + block]
                b = xb.shape[0]
                h = self._norm(xb)
                q = self._rope(mm(h, w["wq"]).view(b, n, hq, hd), pos)
                k = self._rope(mm(h, w["wk"]).view(b, n, hkv, hd), pos)
                v = mm(h, w["wv"]).view(b, n, hkv, hd)
                a = self._attention(q, k, v, prompt_len).reshape(b, n, hq * hd)
                xb = xb + mm(a, w["wo"])
                h = self._norm(xb)
                u = mm(h, w["wi"])
                u = (torch.nn.functional.silu(u) * mm(h, w["wg"]) if self.gated
                     else torch.nn.functional.gelu(u, approximate="tanh"))
                x[r0:r0 + block] = xb + mm(u, w["w2"])
            del w
        head = prep(self.embed.T if self.head is None else self.head)
        return mm(self._norm(x[:, prompt_len - 1:]), head)
