"""Mamba-1 selective scan: the hand kernel (``csrc/ssm_scan.cu``), its
wrapper and its plain torch version.

Replaces ``repro.kernels.ssm_scan.ssm_scan_pallas``.  The wrapper launches
the kernel for CUDA tensors (or raises) and runs :func:`ssm_scan_plain` for
CPU tensors; nothing falls back.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

launches = 0   # kernel launches; chip_smoke.py resets and reads it

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"ssm_scan_fwd": (_P,) * 9 + (_I,) * 5 + (_P,)}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_STATE = 32     # N: at most 8 lanes of 4 states a channel
STATES = 4         # states a lane
CHANNELS = 64      # channels a block
CHUNK = 32         # time steps a stage of the ring holds


def scan_geometry(n: int, itemsize: int) -> dict:
    """The kernel's launch geometry for state size ``n`` and u / B / C of
    ``itemsize`` bytes (``launch_l`` and ``smem_bytes`` in the source):
    lanes a channel (the power of two >= n / 4), states a lane, channels and
    threads a block, steps a chunk and the block's shared memory."""
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"state size N={n} not in [1, {MAX_STATE}]")
    lanes = 1
    while lanes * STATES < n:
        lanes *= 2
    raw_bc = (CHUNK * n * itemsize + 15) // 16 * 16
    stage = CHUNK * CHANNELS * (itemsize + 4) + 2 * raw_bc
    y_stride = CHANNELS + max(32 // lanes, 4)
    smem = 2 * stage + 2 * CHUNK * 2 * STATES * lanes * 4 + 2 * CHUNK * y_stride * 4
    return dict(lanes=lanes, states=STATES, channels=CHANNELS,
                threads=CHANNELS * lanes, chunk=CHUNK, smem_bytes=smem)


def ssm_scan_plain(u, delta, A, B, C, D, h0):
    """A loop over T of the kernel's fp32 arithmetic.

    u, delta: (Bt, T, Din); A: (Din, N); B, C: (Bt, T, N); D: (Din,);
    h0: (Bt, Din, N).  Returns (y (Bt, T, Din) in u's dtype, hT fp32).
    """
    uf, df, Af, Bf, Cf = (x.float() for x in (u, delta, A, B, C))
    h = h0.float()
    y = torch.empty_like(uf)
    for t in range(u.shape[1]):
        d_t = df[:, t, :, None]
        h = torch.exp(d_t * Af) * h + (d_t * uf[:, t, :, None]) * Bf[:, t, None, :]
        y[:, t] = (h * Cf[:, t, None, :]).sum(-1)
    return (y + uf * D.float()).to(u.dtype), h


def library():
    """The kernel's shared library, built from ``csrc/ssm_scan.cu`` if missing."""
    return _build.load("ssm_scan", _SIGNATURES)


def _check(u, delta, A, B, C, D, h0):
    if u.dtype not in _DTYPES:
        raise TypeError(f"the selective scan takes float32 or bfloat16 u, got {u.dtype}")
    for name, t, want in (("B", B, u.dtype), ("C", C, u.dtype), ("delta", delta, torch.float32),
                          ("A", A, torch.float32), ("D", D, torch.float32),
                          ("h0", h0, torch.float32)):
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")
    if u.dim() != 3 or A.dim() != 2:
        raise ValueError("u must be (Bt, T, Din) and A (Din, N)")
    bt, t, din = u.shape
    n = A.shape[1]
    if delta.shape != u.shape or A.shape[0] != din or B.shape != (bt, t, n) \
            or C.shape != (bt, t, n) or D.shape != (din,) or h0.shape != (bt, din, n):
        raise ValueError(f"shapes do not match: u {tuple(u.shape)}, delta {tuple(delta.shape)}, "
                         f"A {tuple(A.shape)}, B {tuple(B.shape)}, C {tuple(C.shape)}, "
                         f"D {tuple(D.shape)}, h0 {tuple(h0.shape)}")
    scan_geometry(n, u.element_size())
    if min(bt, t, din) == 0:
        raise ValueError("empty scan")
    if bt > 65535:
        raise ValueError(f"batch {bt} exceeds the grid's 65535 rows")
    for name, x in (("u", u), ("delta", delta), ("A", A), ("B", B), ("C", C),
                    ("D", D), ("h0", h0)):
        if x.device != u.device:
            raise ValueError(f"{name} is on {x.device}, u on {u.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def ssm_scan_hopper(u, delta, A, B, C, D, h0):
    """See :func:`ssm_scan_plain`.  A CUDA tensor goes to the hand kernel, a
    CPU tensor to the plain version."""
    global launches
    if u.device.type == "cpu":
        return ssm_scan_plain(u, delta, A, B, C, D, h0)
    if u.device.type != "cuda":
        raise ValueError(f"the selective scan runs on cuda or cpu, not {u.device}")
    _build.refuse_grad("ssm_scan", "the scan's backward kernel, ROADMAP A6's next item",
                       u, delta, A, B, C, D, h0)
    _check(u, delta, A, B, C, D, h0)
    lib = library()
    bt, t, din = u.shape
    y = torch.empty_like(u)
    hT = torch.empty_like(h0)
    code = _build.call(
        u.device, lib.ssm_scan_fwd, u.data_ptr(), delta.data_ptr(), A.data_ptr(),
        B.data_ptr(), C.data_ptr(), D.data_ptr(), h0.data_ptr(), y.data_ptr(),
        hT.data_ptr(), bt, t, din, A.shape[1], _DTYPES[u.dtype])
    _build.check(lib, "ssm_scan", code)
    launches += 1
    return y, hT
