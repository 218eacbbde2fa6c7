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

The backward (:func:`flash_attention_bwd_hopper`) is two launches a call,
dq (with Dr = rowsum(dO * O)) then dk / dv: bf16 on the tensor cores, fp32
on the FMA units, fp32 accumulation, no atomics (two calls agree bit for
bit).  It reads each row's softmax statistics (max score m and 1 / l), which
the forward writes when asked (``stats=True``, what :class:`FlashAttention`
asks for); serving asks for none and runs the forward as it was.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import NEG_INF, attention_mask

launches = 0       # forward kernel launches; chip_smoke.py resets and reads it
bwd_launches = 0   # backward kernel launches, BWD_KERNELS a call

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"flash_attention_fwd": (_P,) * 8 + (_I,) * 8 + (ctypes.c_float, _I, _P)}
_BWD_SIGNATURES = {"flash_attention_bwd": (_P,) * 13 + (_I,) * 8
                   + (ctypes.c_float, _I, _P)}
BWD_KERNELS = 2    # launches a backward call: dq (and Dr), then dk / dv
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128
_GRID_YZ = 65535          # CUDA's limit on gridDim.y and gridDim.z


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: Optional[int] = None, q_pos, kv_pos,
                          stats: bool = False):
    """Masked softmax attention in fp32, grouped-query, cast back to q.dtype.

    q: (B, Sq, Hq, D); k/v: (B, Skv, Hkv, D); q_pos (Sq,), kv_pos (Skv,).
    With ``stats``, returns ``(out, m, linv)``: each row's masked max score m
    (NEG_INF for a row with no valid key) and the reciprocal of its sum of
    exp(s - m), fp32 (B, Hq, Sq), the numbers the kernels write.
    """
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    qf = q.float().reshape(b, sq, hkv, hq // hkv, d) * (1.0 / d ** 0.5)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float())
    mask = attention_mask(q_pos, kv_pos, causal=causal, window=window)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    out = out.reshape(b, sq, hq, d).to(q.dtype)
    if not stats:
        return out
    m = s.amax(-1)                                       # (b, hkv, g, sq)
    linv = 1.0 / torch.exp(s - m[..., None]).sum(-1)
    return out, m.reshape(b, hq, sq), linv.reshape(b, hq, sq)


def flash_attention_plain_rows(q, k, v, *, causal: bool = True,
                               window: Optional[int] = None, q_pos, kv_pos,
                               max_bytes: int = 4 << 30):
    """:func:`flash_attention_plain` evaluated over slices of q rows, each
    slice against every key: the same rows, with a (B, Hq, rows, Skv) fp32
    score tensor of at most ``max_bytes`` (at least one row a slice).  A row's
    softmax depends on its own scores only, so the slices join into the whole
    call's output; this is the plain version at lengths whose whole score
    tensor does not fit (granite's 32 heads at 32768 keys: 137 GB)."""
    b, sq, hq, _ = q.shape
    rows = max(1, max_bytes // (4 * b * hq * k.shape[1]))
    return torch.cat([flash_attention_plain(q[:, i:i + rows], k, v, causal=causal,
                                            window=window, q_pos=q_pos[i:i + rows],
                                            kv_pos=kv_pos)
                      for i in range(0, sq, rows)], dim=1)


def flash_attention_bwd_plain(q, k, v, out, dout, m, linv, *, causal: bool = True,
                              window: Optional[int] = None, q_pos, kv_pos):
    """(dq, dk, dv) of :func:`flash_attention_plain` for the output gradient
    ``dout``, in fp32 torch, cast back to q.dtype.

    ``out`` is the forward's output as stored (q.dtype): ``Dr = rowsum(dO * O)``
    is taken from it, and P = exp(s - m) * linv from the forward's statistics
    ``m``, ``linv`` (B, Hq, Sq), as the kernel does.  A masked score passes no
    gradient; a row with no valid key (m = NEG_INF) weights every key by
    1 / Skv in dv.
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
    mf = m.float().reshape(b, hkv, g, sq, 1)
    p = torch.exp(torch.where(mask, s, NEG_INF) - mf) * linv.float().reshape(b, hkv, g, sq, 1)
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
                           window: Optional[int] = None, q_pos, kv_pos,
                           stats: bool = False):
    """q: (B, Sq, Hq, D); k/v: (B, Skv, Hkv, D) -> (B, Sq, Hq, D), or with
    ``stats`` ``(out, m, linv)`` as :func:`flash_attention_plain` gives them.

    A CUDA tensor goes to the hand kernel, a CPU tensor to the plain version,
    a meta tensor (the dry run) to empty outputs: no launch, no count.
    The kernel writes the statistics only when asked: the instantiation that
    serving launches is the one without them.
    """
    global launches
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_pos=q_pos, kv_pos=kv_pos, stats=stats)
    if q.device.type == "meta":
        out = torch.empty_like(q)
        if not stats:
            return out
        b, sq, hq, _ = q.shape
        m, linv = torch.empty((2, b, hq, sq), dtype=torch.float32, device=q.device)
        return out, m, linv
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")
    _check(q, k, v, q_pos, kv_pos, window)
    lib = library()
    b, sq, hq, d = q.shape
    out = torch.empty_like(q)
    m = linv = None
    if stats:
        m, linv = torch.empty((2, b, hq, sq), dtype=torch.float32, device=q.device)
    code = _build.call(
        q.device, lib.flash_attention_fwd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        q_pos.data_ptr(), kv_pos.data_ptr(), out.data_ptr(),
        None if m is None else m.data_ptr(), None if linv is None else linv.data_ptr(),
        b, sq, k.shape[1], hq, k.shape[2], d, int(causal),
        -1 if window is None else int(window), 1.0 / (d ** 0.5), _DTYPES[q.dtype])
    _build.check(lib, "flash_attention", code)
    launches += 1
    return (out, m, linv) if stats else out


def flash_attention_bwd_hopper(q, k, v, out, dout, m, linv, *, causal: bool = True,
                               window: Optional[int] = None, q_pos, kv_pos):
    """(dq, dk, dv) of the forward for ``dout``; ``out``, ``m`` and ``linv``
    are what the forward gave with ``stats=True``.  A CUDA tensor goes to the
    hand kernel (BWD_KERNELS launches), a CPU tensor to
    :func:`flash_attention_bwd_plain`, a meta tensor to empty gradients."""
    global bwd_launches
    args = dict(causal=causal, window=window, q_pos=q_pos, kv_pos=kv_pos)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, dout, m, linv, **args)
    if q.device.type == "meta":
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")
    _check(q, k, v, q_pos, kv_pos, window)
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q: {tuple(t.shape)} {t.dtype} on {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    b, sq, hq, d = q.shape
    for name, t in (("m", m), ("linv", linv)):
        if t.shape != (b, hq, sq) or t.dtype != torch.float32 or t.device != q.device \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous fp32 (B, Hq, Sq) on {q.device}: "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    lib = bwd_library()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dr = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    code = _build.call(
        q.device, lib.flash_attention_bwd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), dout.data_ptr(), q_pos.data_ptr(), kv_pos.data_ptr(),
        m.data_ptr(), linv.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        dr.data_ptr(), b, sq, k.shape[1], hq, k.shape[2], d, int(causal),
        -1 if window is None else int(window), 1.0 / (d ** 0.5), _DTYPES[q.dtype])
    _build.check(lib, "flash_attention_bwd", code)
    bwd_launches += BWD_KERNELS
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Flash attention with a gradient: the forward wrapper with its row
    statistics, then the backward wrapper on what it saved (q, k, v, the
    output, the statistics and the positions; the forward is deterministic,
    so recomputing it under activation checkpointing changes none of them)."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, kv_pos, causal, window):
        out, m, linv = flash_attention_hopper(q, k, v, causal=causal, window=window,
                                              q_pos=q_pos, kv_pos=kv_pos, stats=True)
        ctx.save_for_backward(q, k, v, out, m, linv, q_pos, kv_pos)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, m, linv, q_pos, kv_pos = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_hopper(
            q, k, v, out, dout.contiguous(), m, linv, causal=ctx.causal, window=ctx.window,
            q_pos=q_pos, kv_pos=kv_pos)
        return dq, dk, dv, None, None, None, None
