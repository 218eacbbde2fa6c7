"""Decode attention: the hand kernel (``csrc/decode_attention.cu``), its
wrapper and its plain torch version.

Replaces ``repro.kernels.decode_attention.decode_attention_pallas``.  The
wrapper launches the kernel for a CUDA tensor (or raises) and runs
:func:`decode_attention_plain` for a CPU tensor; nothing falls back.  The
kernel splits the cache across blocks (:func:`decode_splits`) and combines
the fp32 partials in a second device kernel of the same C call, into scratch
that the wrapper allocates.  With ``stats=True`` the combine writes, instead
of the output in the cache's dtype, the normalised output in fp32 and each
row's max score m and sum of exponentials l: what a rank holding some of a
cache's rows needs to merge its softmax with the other ranks'
(``ops.combine_partials``).  :func:`shape_error` is its shape rule, pure
Python, so the CPU tests can hold every model config to it.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import NEG_INF

launches = 0   # kernel launches; chip_smoke.py resets and reads it

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"decode_attention_fwd": (_P,) * 9 + (_I,) * 6 + (ctypes.c_float, _I, _P)}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128
MIN_CHUNK = 32            # cache rows a split takes at least
H100_SMS = 132
# a split block's shared memory (csrc/decode_attention.cu, split_smem_bytes):
# 128 threads, two stages of 32-row K / V tiles, 16-byte vectors of at most 8
# elements, elements of at most 4 bytes
_THREADS, _TILE, _STAGES, _VEC, _ELEM = 128, 32, 2, 8, 4
MAX_SPLITS = 512
MAX_SHARED = 232448       # bytes a block may take on sm_90
_GRID_YZ = 65535


@functools.lru_cache(maxsize=1024)
def decode_splits(b: int, s: int, hkv: int, sms: int = H100_SMS) -> int:
    """Cache chunks a call splits each (batch, kv head) into: about two blocks
    an SM over the B * Hkv pairs, each chunk at least MIN_CHUNK rows, none
    empty."""
    want = -(-2 * sms // max(1, b * hkv))
    splits = max(1, min(want, -(-s // MIN_CHUNK), MAX_SPLITS))
    chunk = -(-s // splits)
    return -(-s // chunk)


def split_smem_bytes(g: int, d: int) -> int:
    """Shared memory of one split block, at most: two stages of K and V tiles
    (32 rows of D), then fp32 q and acc (G D each), the scores (G x 32), the
    tile's mask (32), m / l / corr (3 G) and the P V shares (max(G D, 128 x 8))."""
    return (_ELEM * _STAGES * 2 * _TILE * d
            + 4 * (2 * g * d + g * _TILE + _TILE + 3 * g + max(g * d, _THREADS * _VEC)))


@functools.lru_cache(maxsize=1024)
def shape_error(b: int, s: int, hq: int, hkv: int, d: int) -> Optional[str]:
    """Why the kernel cannot take this shape, or None if it can.

    q (b, hq, d) against caches (b, s, hkv, d): any cache length, any grouping
    hq = G * hkv (no cap on G * D short of the block's shared memory), any head
    dim that is a multiple of 8 from 8 to 128 (16-byte vectors).
    """
    if min(b, s) < 1:
        return f"empty batch or cache (B {b}, S {s})"
    if hkv < 1 or hq % hkv:
        return f"{hq} q heads do not group over {hkv} kv heads"
    if d < 8 or d > MAX_HEAD_DIM or d % 8:
        return f"head_dim {d} is not a multiple of 8 from 8 to {MAX_HEAD_DIM}"
    if split_smem_bytes(hq // hkv, d) > MAX_SHARED:
        return (f"{hq // hkv} q heads of head_dim {d} a kv head need "
                f"{split_smem_bytes(hq // hkv, d)} bytes of shared memory (> {MAX_SHARED})")
    if hkv > _GRID_YZ or b > _GRID_YZ:
        return f"{hkv} kv heads or batch {b} exceed the grid ({_GRID_YZ})"
    return None


def decode_attention_plain(q, k_cache, v_cache, valid_mask, *, stats: bool = False):
    """Masked softmax over the cache in fp32, grouped-query, cast back.

    q: (B, Hq, D); caches (B, S, Hkv, D); valid_mask (B, S) bool.  With
    ``stats``, returns ``(out, m, l)`` in fp32: the normalised output
    (B, Hq, D), each row's max score m and its sum of exponentials
    l = sum_s e^(s - m) (B, Hq), under the kernel's conventions (a masked
    score is NEG_INF itself, so a row with no valid key has m = NEG_INF,
    l = S and the mean of V).
    """
    b, hq, d = q.shape
    hkv = k_cache.shape[2]
    qf = q.float().reshape(b, hkv, hq // hkv, d) * (1.0 / d ** 0.5)
    s = torch.einsum("bhgd,bshd->bhgs", qf, k_cache.float())
    s = torch.where(valid_mask[:, None, None, :], s, NEG_INF)
    if stats:
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(dim=-1)
        out = torch.einsum("bhgs,bshd->bhgd", p, v_cache.float()) / l[..., None]
        return out.reshape(b, hq, d), m.reshape(b, hq), l.reshape(b, hq)
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
    if k_cache.shape[0] != b or dk != d:
        raise ValueError(f"shapes do not match: q {tuple(q.shape)}, "
                         f"cache {tuple(k_cache.shape)}")
    err = shape_error(b, s, hq, hkv, d)
    if err is not None:
        raise ValueError(err)
    if valid_mask.shape != (b, s) or valid_mask.dtype != torch.bool:
        raise ValueError("valid_mask must be a (B, S) bool tensor")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("valid_mask", valid_mask)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name != "valid_mask" and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (16-byte loads)")


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _stats_like(q):
    b, hq, d = q.shape
    return (torch.empty((b, hq, d), dtype=torch.float32, device=q.device),
            torch.empty((b, hq), dtype=torch.float32, device=q.device),
            torch.empty((b, hq), dtype=torch.float32, device=q.device))


def decode_attention_hopper(q, k_cache, v_cache, valid_mask, *, stats: bool = False):
    """q: (B, Hq, D); caches (B, S, Hkv, D); valid_mask (B, S) -> (B, Hq, D),
    or with ``stats`` ``(out, m, l)`` in fp32 as :func:`decode_attention_plain`
    gives them (the kernel's statistics instantiation).

    A CUDA tensor goes to the hand kernel, a CPU tensor to the plain version,
    a meta tensor (the dry run) to an empty output: no launch, no count.
    """
    global launches
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, valid_mask, stats=stats)
    if q.device.type == "meta":
        return _stats_like(q) if stats else torch.empty_like(q)
    if q.device.type != "cuda":
        raise ValueError(f"decode attention runs on cuda or cpu, not {q.device}")
    _build.refuse_grad("decode_attention", "decode serves, it is never trained through",
                       q, k_cache, v_cache)
    _check(q, k_cache, v_cache, valid_mask)
    lib = library()
    b, hq, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    splits = decode_splits(b, s, hkv, _sms(q.device.index or 0))
    scratch = torch.empty(b * hq * splits * (d + 2), dtype=torch.float32, device=q.device)
    # the output in q's dtype, or (null and) the fp32 output, m and l
    out = _stats_like(q) if stats else torch.empty_like(q)
    out_ptr, stat_ptrs = ((None, [t.data_ptr() for t in out]) if stats
                          else (out.data_ptr(), [None] * 3))
    code = _build.call(
        q.device, lib.decode_attention_fwd, q.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), valid_mask.data_ptr(), out_ptr, scratch.data_ptr(), *stat_ptrs,
        b, s, hq, hkv, d, splits, 1.0 / (d ** 0.5), _DTYPES[q.dtype])
    _build.check(lib, "decode_attention", code)
    launches += 1
    return out
