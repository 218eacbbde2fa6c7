"""Decode attention: the hand kernel (``csrc/decode_attention.cu``), its
wrapper and its plain torch version.

Replaces ``repro.kernels.decode_attention.decode_attention_pallas``.  The
wrapper launches the kernel for a CUDA tensor (or raises) and runs
:func:`decode_attention_plain` for a CPU tensor; nothing falls back.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import NEG_INF

launches = 0   # kernel launches; chip_smoke.py resets and reads it

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"decode_attention_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                        ctypes.c_float, _I, _P)}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128
MAX_GROUP_WIDTH = 1024    # G * D: accumulator outputs one block holds


def decode_attention_plain(q, k_cache, v_cache, valid_mask):
    """Masked softmax over the cache in fp32, grouped-query, cast back.

    q: (B, Hq, D); caches (B, S, Hkv, D); valid_mask (B, S) bool.
    """
    b, hq, d = q.shape
    hkv = k_cache.shape[2]
    qf = q.float().reshape(b, hkv, hq // hkv, d) * (1.0 / d ** 0.5)
    s = torch.einsum("bhgd,bshd->bhgs", qf, k_cache.float())
    s = torch.where(valid_mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p, v_cache.float())
    return out.reshape(b, hq, d).to(q.dtype)


def library():
    """The kernel's shared library, built from ``csrc/decode_attention.cu`` if missing."""
    return _build.load("decode_attention", _SIGNATURES)


def _check(q, k_cache, v_cache, valid_mask):
    if q.dtype not in _DTYPES:
        raise TypeError(f"decode attention takes float32 or bfloat16, got {q.dtype}")
    if k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError("q and the caches must share one dtype")
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError("q must be (B, Hq, D) and the caches (B, S, Hkv, D)")
    b, hq, d = q.shape
    _, s, hkv, dk = k_cache.shape
    if k_cache.shape[0] != b or dk != d or hq % hkv:
        raise ValueError(f"shapes do not match: q {tuple(q.shape)}, "
                         f"cache {tuple(k_cache.shape)}")
    if d > MAX_HEAD_DIM or (hq // hkv) * d > MAX_GROUP_WIDTH:
        raise ValueError(f"head_dim {d} with {hq // hkv} q heads per kv head "
                         f"exceeds the kernel's block ({MAX_GROUP_WIDTH} outputs)")
    if s == 0:
        raise ValueError("empty cache")
    if valid_mask.shape != (b, s) or valid_mask.dtype != torch.bool:
        raise ValueError("valid_mask must be a (B, S) bool tensor")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("valid_mask", valid_mask)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def decode_attention_hopper(q, k_cache, v_cache, valid_mask):
    """q: (B, Hq, D); caches (B, S, Hkv, D); valid_mask (B, S) -> (B, Hq, D).

    A CUDA tensor goes to the hand kernel, a CPU tensor to the plain version.
    """
    global launches
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, valid_mask)
    if q.device.type != "cuda":
        raise ValueError(f"decode attention runs on cuda or cpu, not {q.device}")
    _check(q, k_cache, v_cache, valid_mask)
    lib = library()
    b, hq, d = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        code = lib.decode_attention_fwd(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            valid_mask.data_ptr(), out.data_ptr(), b, k_cache.shape[1], hq,
            k_cache.shape[2], d, 1.0 / (d ** 0.5), _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, "decode_attention", code)
    launches += 1
    return out
