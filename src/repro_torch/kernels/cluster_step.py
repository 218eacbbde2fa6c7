"""The batch simulator's cluster step: the hand kernel
(``csrc/cluster_step.cu``), its wrapper and its plain torch version.

Replaces ``repro.kernels.cluster_step.cluster_sim_pallas``: every sweep cell
through all T fixed-dt cohort steps in one launch.  The wrapper launches the
kernel for CUDA tensors (or raises) and runs :func:`cluster_sim_plain` for
CPU tensors; nothing falls back.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as R

launches = 0   # kernel launches; chip_smoke.py resets and reads it

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"cluster_step_fwd": (_P,) * 15 + (_I,) * 5 + (_P,)}
MAX_THREADS = 512                 # one thread per function (and per worker)
MAX_SMEM_BYTES = 232448           # dynamic shared memory one H100 block can use
_NAMES = ("nw", "fs", "free", "arrivals", "conc", "fparam", "promote",
          "dwell", "ntier", "frac", "scal")


def smem_bytes(f: int, w: int) -> int:
    """Shared memory the kernel's block takes (``smem_bytes`` in the source)."""
    return 4 * (2 * f * (w | 1) + 2 * w + 2 * f + R.AG_N * f)


def cluster_sim_plain(nw, fs, free, arrivals, conc, fparam, promote, dwell,
                      ntier, frac, scal):
    """A Python loop over T of the batched torch step (``ref.cluster_step_ref``).

    ``now`` of step t is ``float32(t) * dt`` of each cell, as in the kernel.
    Returns ``(nw, fs, free, agg)`` with agg (C, AG_N).
    """
    c, t_steps, _ = arrivals.shape
    agg = torch.zeros((c, R.AG_N), dtype=torch.float32, device=nw.device)
    dt = scal[:, R.SC_DT]
    for t in range(t_steps):
        now = torch.tensor(float(t), dtype=torch.float32, device=nw.device) * dt
        nw, fs, free, d = R.cluster_step_ref(
            nw, fs, free, arrivals[:, t], conc[:, t], now, fparam, promote,
            dwell, ntier, frac, scal)
        agg = agg + d
    return nw, fs, free, agg


def library():
    """The kernel's shared library, built from ``csrc/cluster_step.cu`` if missing."""
    return _build.load("cluster_step", _SIGNATURES)


def _check(args):
    nw, fs, free, arrivals, conc, fparam, promote, dwell, ntier, frac, scal = args
    c, f, w = nw.shape
    t = arrivals.shape[1]
    k = dwell.shape[2]
    want = {"nw": (c, f, w), "fs": (c, f, R.FS_N), "free": (c, w),
            "arrivals": (c, t, f), "conc": (c, t, f),
            "fparam": (c, f, R.FP_N), "promote": (c, f, R.N_TIERS),
            "dwell": (c, f, k), "ntier": (c, f, k), "frac": (c, R.N_TIERS),
            "scal": (c, R.SC_N)}
    for name, x in zip(_NAMES, args):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if tuple(x.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                             f"expected {want[name]}")
        if x.device != nw.device:
            raise ValueError(f"{name} is on {x.device}, nw on {nw.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if min(c, f, w, k) < 1:
        raise ValueError(f"empty grid: C={c} F={f} W={w} K={k}")
    if max(f, w) > MAX_THREADS:
        raise ValueError(f"F={f} functions and W={w} workers: the kernel's "
                         f"block holds at most {MAX_THREADS} of each")
    if smem_bytes(f, w) > MAX_SMEM_BYTES:
        raise ValueError(f"F={f} x W={w} needs {smem_bytes(f, w)} bytes of "
                         f"shared memory, over the block's {MAX_SMEM_BYTES}")


def cluster_sim_hopper(nw, fs, free, arrivals, conc, fparam, promote, dwell,
                       ntier, frac, scal):
    """Advance every cell through all T steps; the arguments and results of
    :func:`repro.kernels.cluster_step.cluster_sim_pallas`.

    nw (C, F, W); fs (C, F, FS_N); free (C, W); arrivals and conc (C, T, F);
    fparam/promote (C, F, 5); dwell/ntier (C, F, K); frac (C, 5);
    scal (C, SC_N); all float32.  Returns ``(nw, fs, free, agg)`` with agg
    (C, AG_N).  CUDA tensors go to the hand kernel (one launch), CPU tensors
    to the plain version.
    """
    global launches
    args = (nw, fs, free, arrivals, conc, fparam, promote, dwell, ntier, frac,
            scal)
    if nw.device.type == "cpu":
        return cluster_sim_plain(*args)
    if nw.device.type != "cuda":
        raise ValueError(f"the cluster step runs on cuda or cpu, not {nw.device}")
    _check(args)
    lib = library()
    c, f, w = nw.shape
    t, k = arrivals.shape[1], dwell.shape[2]
    nw_out, fs_out, free_out = (torch.empty_like(x) for x in (nw, fs, free))
    agg = torch.empty((c, R.AG_N), dtype=torch.float32, device=nw.device)
    code = _build.call(
        nw.device, lib.cluster_step_fwd, *(x.data_ptr() for x in args), nw_out.data_ptr(),
        fs_out.data_ptr(), free_out.data_ptr(), agg.data_ptr(), c, f, w, k, t)
    _build.check(lib, "cluster_step", code)
    launches += 1
    return nw_out, fs_out, free_out, agg
