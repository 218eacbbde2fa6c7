"""Flash attention: the hand forward kernels (``csrc/flash_attention.cu``),
the hand backward kernel (``csrc/flash_attention_bwd.cu``), their wrappers,
their plain torch versions and :class:`FlashAttention`, the autograd
function that joins forward and backward.

Replaces ``repro.kernels.flash_attention.flash_attention_pallas``.  The
wrapper launches a kernel for a CUDA tensor (or raises) and runs
:func:`flash_attention_plain` for a CPU tensor; nothing falls back.  The C
entry picks the kernel by dtype: bf16 runs on the tensor cores (TMA copies,
wgmma products), fp32 on the plain-FMA kernel (tensor cores would round fp32
to TF32).  :func:`shape_error` is the shape rule of both, and of the
backward, pure Python, so the CPU tests can hold every model config to it.

The backward (:func:`flash_attention_bwd_hopper`) is three SIMT launches a
call: each row's softmax statistics, then dk / dv, then dq, fp32
accumulation, no atomics (two calls agree bit for bit).  It recomputes the
statistics itself, so the forward kernel stays as serving runs it.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import NEG_INF, attention_mask

launches = 0       # forward kernel launches; chip_smoke.py resets and reads it
bwd_launches = 0   # backward kernel launches, three a call

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"flash_attention_fwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                       _I, _I, _I, _I, ctypes.c_float, _I, _P)}
_BWD_SIGNATURES = {"flash_attention_bwd": (_P,) * 13 + (_I,) * 8
                   + (ctypes.c_float, _I, _P)}
BWD_KERNELS = 3    # launches a backward call: statistics, dk / dv, dq
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128
_GRID_YZ = 65535          # CUDA's limit on gridDim.y and gridDim.z


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: Optional[int] = None, q_pos, kv_pos):
    """Masked softmax attention in fp32, grouped-query, cast back to q.dtype.

    q: (B, Sq, Hq, D); k/v: (B, Skv, Hkv, D); q_pos (Sq,), kv_pos (Skv,).
    """
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    qf = q.float().reshape(b, sq, hkv, hq // hkv, d) * (1.0 / d ** 0.5)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float())
    mask = attention_mask(q_pos, kv_pos, causal=causal, window=window)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(b, sq, hq, d).to(q.dtype)


def flash_attention_bwd_plain(q, k, v, out, dout, *, causal: bool = True,
                              window: Optional[int] = None, q_pos, kv_pos):
    """(dq, dk, dv) of :func:`flash_attention_plain` for the output gradient
    ``dout``, in fp32 torch, cast back to q.dtype.

    ``out`` is the forward's output as stored (q.dtype): ``Dr = rowsum(dO * O)``
    is taken from it, as the kernel does.  A masked score passes no gradient;
    a row with no valid key weights every key by 1 / Skv in dv.
    """
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = 1.0 / d ** 0.5
    qs = q.float().reshape(b, sq, hkv, g, d) * scale
    kf, vf = k.float(), v.float()
    do = dout.float().reshape(b, sq, hkv, g, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qs, kf)
    mask = attention_mask(q_pos, kv_pos, causal=causal, window=window)
    p = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)
    dr = (do * out.float().reshape(b, sq, hkv, g, d)).sum(-1)           # (b, q, h, g)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, do)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", do, vf)
    ds = torch.where(mask, p * (dp - dr.permute(0, 2, 3, 1)[..., None]), 0.0)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qs)
    return (dq.reshape(b, sq, hq, d).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


def library():
    """The kernel's shared library, built from ``csrc/flash_attention.cu`` if missing."""
    return _build.load("flash_attention", _SIGNATURES)


def bwd_library():
    """The backward's shared library, built from ``csrc/flash_attention_bwd.cu``."""
    return _build.load("flash_attention_bwd", _BWD_SIGNATURES)


@functools.lru_cache(maxsize=1024)
def shape_error(b: int, sq: int, skv: int, hq: int, hkv: int, d: int,
                window: Optional[int] = None) -> Optional[str]:
    """Why the kernels cannot take this shape, or None if they can.

    q (b, sq, hq, d) against k / v (b, skv, hkv, d): any lengths, any
    grouping hq = G * hkv, any head dim that is a multiple of 8 from 8 to 128
    (TMA's strides are multiples of 16 bytes; the bf16 kernel pads D to 64 or
    128 with zeros), a window of None or >= 0.
    """
    if min(b, sq, skv) < 1:
        return f"empty batch or sequence (B {b}, Sq {sq}, Skv {skv})"
    if hkv < 1 or hq % hkv:
        return f"{hq} q heads do not group over {hkv} kv heads"
    if d < 8 or d > MAX_HEAD_DIM or d % 8:
        return f"head_dim {d} is not a multiple of 8 from 8 to {MAX_HEAD_DIM}"
    if hq > _GRID_YZ or b > _GRID_YZ:
        return f"{hq} q heads or batch {b} exceed the grid ({_GRID_YZ})"
    if window is not None and window < 0:
        return f"window {window} < 0"
    return None


def _check(q, k, v, q_pos, kv_pos, window):
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash attention takes float32 or bfloat16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("q must be (B, Sq, Hq, D) and k, v (B, Skv, Hkv, D)")
    b, sq, hq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"shapes do not match: q {tuple(q.shape)}, k {tuple(k.shape)}")
    err = shape_error(b, sq, k.shape[1], hq, k.shape[2], d, window)
    if err is not None:
        raise ValueError(err)
    if q_pos.shape != (sq,) or kv_pos.shape != (k.shape[1],):
        raise ValueError("q_pos must be (Sq,) and kv_pos (Skv,)")
    if q_pos.dtype != torch.int32 or kv_pos.dtype != torch.int32:
        raise TypeError("q_pos and kv_pos must be int32")
    for name, t in (("q", q), ("k", k), ("v", v), ("q_pos", q_pos), ("kv_pos", kv_pos)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def flash_attention_hopper(q, k, v, *, causal: bool = True,
                           window: Optional[int] = None, q_pos, kv_pos):
    """q: (B, Sq, Hq, D); k/v: (B, Skv, Hkv, D) -> (B, Sq, Hq, D).

    A CUDA tensor goes to the hand kernel, a CPU tensor to the plain version.
    """
    global launches
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_pos=q_pos, kv_pos=kv_pos)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")
    _check(q, k, v, q_pos, kv_pos, window)
    lib = library()
    b, sq, hq, d = q.shape
    out = torch.empty_like(q)
    code = _build.call(
        q.device, lib.flash_attention_fwd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        q_pos.data_ptr(), kv_pos.data_ptr(), out.data_ptr(), b, sq, k.shape[1], hq,
        k.shape[2], d, int(causal), -1 if window is None else int(window),
        1.0 / (d ** 0.5), _DTYPES[q.dtype])
    _build.check(lib, "flash_attention", code)
    launches += 1
    return out


def flash_attention_bwd_hopper(q, k, v, out, dout, *, causal: bool = True,
                               window: Optional[int] = None, q_pos, kv_pos):
    """(dq, dk, dv) of the forward for ``dout``; ``out`` is the forward's
    output.  A CUDA tensor goes to the hand kernel (three launches), a CPU
    tensor to :func:`flash_attention_bwd_plain`."""
    global bwd_launches
    args = dict(causal=causal, window=window, q_pos=q_pos, kv_pos=kv_pos)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, dout, **args)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")
    _check(q, k, v, q_pos, kv_pos, window)
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q: {tuple(t.shape)} {t.dtype} on {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    lib = bwd_library()
    b, sq, hq, d = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    m, linv, dr = torch.empty((3, b, hq, sq), dtype=torch.float32, device=q.device)
    code = _build.call(
        q.device, lib.flash_attention_bwd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), dout.data_ptr(), q_pos.data_ptr(), kv_pos.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), m.data_ptr(), linv.data_ptr(),
        dr.data_ptr(), b, sq, k.shape[1], hq, k.shape[2], d, int(causal),
        -1 if window is None else int(window), 1.0 / (d ** 0.5), _DTYPES[q.dtype])
    _build.check(lib, "flash_attention_bwd", code)
    bwd_launches += BWD_KERNELS
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Flash attention with a gradient: the forward wrapper, then the
    backward wrapper on what it saved (q, k, v, the output and the
    positions; recomputing the forward under activation checkpointing
    changes none of them)."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, kv_pos, causal, window):
        out = flash_attention_hopper(q, k, v, causal=causal, window=window,
                                     q_pos=q_pos, kv_pos=kv_pos)
        ctx.save_for_backward(q, k, v, out, q_pos, kv_pos)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, q_pos, kv_pos = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_hopper(
            q, k, v, out, dout.contiguous(), causal=ctx.causal, window=ctx.window,
            q_pos=q_pos, kv_pos=kv_pos)
        return dq, dk, dv, None, None, None, None
