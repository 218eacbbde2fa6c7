"""Mamba-1 selective scan: the hand kernels (``csrc/ssm_scan.cu``, and its
gradient ``csrc/ssm_scan_bwd.cu``), their wrappers and their plain torch
versions.

The forward replaces ``repro.kernels.ssm_scan.ssm_scan_pallas``; the
backward has no TPU kernel beside it (the JAX package trains through
``jax.vjp`` of its jnp scan, ``repro.kernels.ops.ssm_scan``).  Each wrapper
launches its kernel for CUDA tensors (or raises) and runs the plain version
for CPU tensors; nothing falls back.  :class:`SSMScan` joins the two for
autograd.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

launches = 0       # forward kernel launches; chip_smoke.py resets and reads them
bwd_launches = 0   # backward kernel launches (BWD_KERNELS a call)
BWD_KERNELS = 2    # the reverse scan, then the sums of its partials

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"ssm_scan_fwd": (_P,) * 10 + (_I,) * 5 + (_P,)}
_BWD_SIGNATURES = {"ssm_scan_bwd": (_P,) * 17 + (_I,) * 5 + (_P,)}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_STATE = 32     # N: at most 8 lanes of 4 states a channel
STATES = 4         # states a lane
CHANNELS = 64      # channels a block
CHUNK = 32         # time steps a stage of the ring holds; the checkpoints' interval
SEGMENT = 8        # the backward's steps a segment: its states and decays in registers
SMEM_PER_SM = 233472   # shared memory of one H100 SM, bytes (228 KB)
SMEM_RESERVED = 1024   # of it, reserved for each resident block


def _lanes(n: int) -> int:
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"state size N={n} not in [1, {MAX_STATE}]")
    lanes = 1
    while lanes * STATES < n:
        lanes *= 2
    return lanes


def _round16(nbytes: int) -> int:
    return (nbytes + 15) // 16 * 16


def scan_geometry(n: int, itemsize: int) -> dict:
    """The kernel's launch geometry for state size ``n`` and u / B / C of
    ``itemsize`` bytes (``launch_l`` and ``smem_bytes`` in the source):
    lanes a channel (the power of two >= n / 4), states a lane, channels and
    threads a block, steps a chunk and the block's shared memory."""
    lanes = _lanes(n)
    raw_bc = _round16(CHUNK * n * itemsize)
    stage = CHUNK * CHANNELS * (itemsize + 4) + 2 * raw_bc
    y_stride = CHANNELS + max(32 // lanes, 4)
    smem = 2 * stage + 2 * CHUNK * 2 * STATES * lanes * 4 + 2 * CHUNK * y_stride * 4
    return dict(lanes=lanes, states=STATES, channels=CHANNELS,
                threads=CHANNELS * lanes, chunk=CHUNK, smem_bytes=smem)


def bwd_channels(n: int) -> int:
    """Channels a backward block (``cpb`` in ``csrc/ssm_scan_bwd.cu``): the
    forward's 64, 32 at 8 lanes a channel (256 threads, one block an SM)."""
    return CHANNELS // 2 if _lanes(n) == 8 else CHANNELS


def bwd_smem(n: int, itemsize: int) -> int:
    """Shared memory of one backward block, bytes (``smem_bytes`` in
    ``csrc/ssm_scan_bwd.cu``)."""
    lanes, chans = _lanes(n), bwd_channels(n)
    threads = chans * lanes
    np_, warps = STATES * lanes, threads // 32
    copies = 4 if lanes <= 4 else 1      # B and C in each lane order of the states
    work = (4 * CHUNK * (chans + 1) + 2 * copies * CHUNK * np_ + CHUNK * warps * 2 * np_
            + (CHUNK // SEGMENT - 1) * threads * 4)
    raw = 2 * CHUNK * chans * itemsize + CHUNK * chans * 4 + 2 * _round16(CHUNK * n * itemsize)
    return 4 * work + raw


def bwd_geometry(n: int, itemsize: int) -> dict:
    """The backward kernel's launch geometry for state size ``n`` and u / B /
    C / dy of ``itemsize`` bytes (``cpb``, ``smem_bytes`` and
    ``min_blocks`` in ``csrc/ssm_scan_bwd.cu``): lanes a channel (the
    forward's), channels and threads a block, steps a segment, the block's
    shared memory (the working rows of (u, dt, dy, dt u) in fp32 with a pad,
    B and C in fp32 in each lane order of the states, the warps' dB / dC rows
    of a chunk, each thread's segment entry states, then one raw stage), the
    blocks an SM its launch bounds ask for, those of them that fit the SM's
    shared memory, and the thread-block cluster (1: none; the per-block
    partials are summed by the second kernel)."""
    lanes, chans, smem = _lanes(n), bwd_channels(n), bwd_smem(n, itemsize)
    # min_blocks in the source: two where two fit at every N of these lanes
    most = bwd_smem(STATES * lanes, itemsize)
    bounds = 2 if lanes < 8 and most + SMEM_RESERVED <= SMEM_PER_SM // 2 else 1
    return dict(lanes=lanes, channels=chans, threads=chans * lanes, segment=SEGMENT,
                smem_bytes=smem, bounds_blocks=bounds,
                blocks_per_sm=min(bounds, SMEM_PER_SM // (smem + SMEM_RESERVED)), cluster=1)


def _step(h, df, uf, Af, Bf, t):
    """h_t from h_{t-1}: the recurrence's fp32 arithmetic."""
    d_t = df[:, t, :, None]
    return torch.exp(d_t * Af) * h + (d_t * uf[:, t, :, None]) * Bf[:, t, None, :]


def ssm_scan_plain(u, delta, A, B, C, D, h0, *, checkpoints: bool = False):
    """A loop over T of the kernel's fp32 arithmetic.

    u, delta: (Bt, T, Din); A: (Din, N); B, C: (Bt, T, N); D: (Din,);
    h0: (Bt, Din, N).  Returns (y (Bt, T, Din) in u's dtype, hT fp32), and
    with ``checkpoints`` also the state entering every CHUNK-th step,
    (Bt, ceil(T / CHUNK), Din, N) fp32 (entry 0 is h0).
    """
    uf, df, Af, Bf, Cf = (x.float() for x in (u, delta, A, B, C))
    h = h0.float()
    y = torch.empty_like(uf)
    kept = []
    for t in range(u.shape[1]):
        if checkpoints and t % CHUNK == 0:
            kept.append(h)
        h = _step(h, df, uf, Af, Bf, t)
        y[:, t] = (h * Cf[:, t, None, :]).sum(-1)
    out = ((y + uf * D.float()).to(u.dtype), h)
    return (*out, torch.stack(kept, 1)) if checkpoints else out


def ssm_scan_bwd_plain(u, delta, A, B, C, D, h0, ckpt, dy, dhT):
    """The gradient of :func:`ssm_scan_plain` for ``dy`` (u's dtype and
    shape) and ``dhT`` (fp32), the backward kernel's arithmetic in a reverse
    loop: each chunk's states recomputed from its checkpoint, then walked
    back.  Returns (du, ddelta, dA, dB, dC, dD, dh0): du, dB and dC in their
    inputs' dtype, the rest fp32.  ``h0`` is ``ckpt[:, 0]``, taken for the
    forward's signature.
    """
    del h0
    uf, df, Af, Bf, Cf, gf = (x.float() for x in (u, delta, A, B, C, dy))
    t_len = u.shape[1]
    du, ddelta = torch.empty_like(uf), torch.empty_like(df)
    dB, dC = torch.empty_like(Bf), torch.empty_like(Cf)
    dA = torch.zeros_like(Af)
    carry = dhT.float()                      # a_{t+1} G_{t+1}; dhT past the end
    for k in reversed(range(ckpt.shape[1])):
        t0 = k * CHUNK
        hs = [ckpt[:, k].float()]            # h_{t0 - 1}, h_{t0}, ...
        for t in range(t0, min(t0 + CHUNK, t_len)):
            hs.append(_step(hs[-1], df, uf, Af, Bf, t))
        for i in reversed(range(len(hs) - 1)):
            t = t0 + i
            d_t, u_t, g_t = df[:, t, :, None], uf[:, t, :, None], gf[:, t, :, None]
            b_t = Bf[:, t, None, :]
            a = torch.exp(d_t * Af)
            G = g_t * Cf[:, t, None, :] + carry
            ah = a * hs[i]
            du[:, t] = (G * b_t).sum(-1) * df[:, t] + gf[:, t] * D.float()
            ddelta[:, t] = (G * (Af * ah + u_t * b_t)).sum(-1)
            dA += (G * d_t * ah).sum(0)
            dB[:, t] = (G * (d_t * u_t)).sum(1)
            dC[:, t] = (g_t * hs[i + 1]).sum(1)
            carry = a * G
    dD = (gf * uf).sum((0, 1))
    return (du.to(u.dtype), ddelta, dA, dB.to(B.dtype), dC.to(C.dtype), dD, carry)


def library():
    """The kernel's shared library, built from ``csrc/ssm_scan.cu`` if missing."""
    return _build.load("ssm_scan", _SIGNATURES)


def bwd_library():
    """The backward's shared library, built from ``csrc/ssm_scan_bwd.cu``."""
    return _build.load("ssm_scan_bwd", _BWD_SIGNATURES)


def n_chunks(t: int) -> int:
    """Checkpoints a scan of ``t`` steps keeps: one a CHUNK steps."""
    return -(-t // CHUNK)


def bwd_workspace(bt: int, t: int, din: int, n: int) -> int:
    """fp32 elements of the backward's scratch: the per-block dB and dC
    partials, the per-row dA and dD partials (``ssm_scan_bwd.cu``)."""
    return 2 * (-(-din // bwd_channels(n))) * bt * t * n + bt * din * n + bt * din


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


def ssm_scan_hopper(u, delta, A, B, C, D, h0, *, checkpoints: bool = False):
    """See :func:`ssm_scan_plain`.  A CUDA tensor goes to the hand kernel, a
    CPU tensor to the plain version, a meta tensor (the dry run) to empty
    outputs with no launch and no count.  The kernel writes the checkpoints
    only when asked: the instantiation that serving launches is the one
    without them."""
    global launches
    if u.device.type == "cpu":
        return ssm_scan_plain(u, delta, A, B, C, D, h0, checkpoints=checkpoints)
    if u.device.type == "meta":
        y, hT = torch.empty_like(u), torch.empty_like(h0)
        if not checkpoints:
            return y, hT
        bt, t, din = u.shape
        return y, hT, torch.empty((bt, n_chunks(t), din, A.shape[1]), dtype=torch.float32,
                                  device=u.device)
    if u.device.type != "cuda":
        raise ValueError(f"the selective scan runs on cuda or cpu, not {u.device}")
    _check(u, delta, A, B, C, D, h0)
    lib = library()
    bt, t, din = u.shape
    n = A.shape[1]
    y = torch.empty_like(u)
    hT = torch.empty_like(h0)
    ckpt = torch.empty((bt, n_chunks(t), din, n), dtype=torch.float32,
                       device=u.device) if checkpoints else None
    code = _build.call(
        u.device, lib.ssm_scan_fwd, u.data_ptr(), delta.data_ptr(), A.data_ptr(),
        B.data_ptr(), C.data_ptr(), D.data_ptr(), h0.data_ptr(), y.data_ptr(),
        hT.data_ptr(), None if ckpt is None else ckpt.data_ptr(), bt, t, din, n,
        _DTYPES[u.dtype])
    _build.check(lib, "ssm_scan", code)
    launches += 1
    return (y, hT, ckpt) if checkpoints else (y, hT)


def ssm_scan_bwd_hopper(u, delta, A, B, C, D, h0, ckpt, dy, dhT):
    """(du, ddelta, dA, dB, dC, dD, dh0) of the forward for ``dy`` and
    ``dhT``; ``ckpt`` is what the forward gave with ``checkpoints=True``.  A
    CUDA tensor goes to the hand kernel (BWD_KERNELS launches), a CPU tensor
    to :func:`ssm_scan_bwd_plain`, a meta tensor to empty gradients."""
    global bwd_launches
    if u.device.type == "cpu":
        return ssm_scan_bwd_plain(u, delta, A, B, C, D, h0, ckpt, dy, dhT)
    if u.device.type == "meta":
        return tuple(torch.empty_like(x) for x in (u, delta, A, B, C, D, h0))
    if u.device.type != "cuda":
        raise ValueError(f"the selective scan runs on cuda or cpu, not {u.device}")
    _check(u, delta, A, B, C, D, h0)
    bt, t, din = u.shape
    n = A.shape[1]
    for name, x, shape, dtype in (("dy", dy, u.shape, u.dtype),
                                  ("dhT", dhT, h0.shape, torch.float32),
                                  ("ckpt", ckpt, (bt, n_chunks(t), din, n), torch.float32)):
        if tuple(x.shape) != tuple(shape) or x.dtype != dtype or x.device != u.device:
            raise ValueError(f"{name} must be {dtype} {tuple(shape)} on {u.device}: "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    lib = bwd_library()
    du, ddelta = torch.empty_like(u), torch.empty_like(delta)
    dA, dB, dC, dD = (torch.empty_like(x) for x in (A, B, C, D))
    dh0 = torch.empty_like(h0)
    work = torch.empty(bwd_workspace(bt, t, din, n), dtype=torch.float32, device=u.device)
    code = _build.call(
        u.device, lib.ssm_scan_bwd, *(x.data_ptr() for x in (
            u, delta, A, B, C, D, ckpt, dy, dhT, du, ddelta, dA, dB, dC, dD, dh0, work)),
        bt, t, din, n, _DTYPES[u.dtype])
    _build.check(lib, "ssm_scan_bwd", code)
    bwd_launches += BWD_KERNELS
    return du, ddelta, dA, dB, dC, dD, dh0


class SSMScan(torch.autograd.Function):
    """The selective scan with a gradient: the forward wrapper with its
    checkpoints, then the backward wrapper on what it saved (the inputs and
    the checkpoints; the forward is deterministic, so recomputing it under
    activation checkpointing changes none of them).  ``dhT`` arrives as
    zeros where the loss does not reach the final state."""

    @staticmethod
    def forward(ctx, u, delta, A, B, C, D, h0):
        y, hT, ckpt = ssm_scan_hopper(u, delta, A, B, C, D, h0, checkpoints=True)
        ctx.save_for_backward(u, delta, A, B, C, D, h0, ckpt)
        return y, hT

    @staticmethod
    def backward(ctx, dy, dhT):
        u, delta, A, B, C, D, h0, ckpt = ctx.saved_tensors
        return ssm_scan_bwd_hopper(u, delta, A, B, C, D, h0, ckpt, dy.contiguous(),
                                   dhT.contiguous())
