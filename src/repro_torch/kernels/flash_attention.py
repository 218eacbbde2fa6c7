"""Flash-attention forward: the hand kernels (``csrc/flash_attention.cu``),
their wrapper and their plain torch version.

Replaces ``repro.kernels.flash_attention.flash_attention_pallas``.  The
wrapper launches a kernel for a CUDA tensor (or raises) and runs
:func:`flash_attention_plain` for a CPU tensor; nothing falls back.  The C
entry picks the kernel by dtype: bf16 runs on the tensor cores (TMA copies,
wgmma products), fp32 on the plain-FMA kernel (tensor cores would round fp32
to TF32).  :func:`shape_error` is the shape rule of both, pure Python, so the
CPU tests can hold every model config to it.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import NEG_INF, attention_mask

launches = 0   # kernel launches; chip_smoke.py resets and reads it

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"flash_attention_fwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                       _I, _I, _I, _I, ctypes.c_float, _I, _P)}
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


def library():
    """The kernel's shared library, built from ``csrc/flash_attention.cu`` if missing."""
    return _build.load("flash_attention", _SIGNATURES)


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
