"""The batch simulator's cluster step: the hand kernels
(``csrc/cluster_step.cu``), their wrapper and the plain torch version.

Replaces ``repro.kernels.cluster_step.cluster_sim_pallas``: every sweep cell
through all T fixed-dt cohort steps in one launch.  The wrapper launches a
kernel for CUDA tensors (or raises) and runs :func:`cluster_sim_plain` for
CPU tensors; nothing falls back.  Two layouts, both hand kernels, picked by
shape (:func:`layout`): ``"warp"``, one warp a cell with the state in
registers, for every table up to F 64, W 8, K 8 (every registered batch
grid); ``"block"``, one block a cell with a thread a function, for wider
tables.

The RL keep-alive gym (``repro_torch.learn.gym``) runs one epoch a launch:
``t_begin`` offsets the steps' clock (step t of the launch at
``float32(t_begin + t) * dt``) and ``extras=True`` also returns the
per-function ``(cold, idle GB-s)`` sums of the launch, (C, 2, F).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as R

launches = 0   # kernel launches; chip_smoke.py resets and reads it
layout_launches = {"warp": 0, "block": 0}   # the same launches by layout

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"cluster_step_fwd": (_P,) * 16 + (_I,) * 7 + (_P,)}
_LAYOUT_CODE = {"warp": 0, "block": 1}
WARP_MAX = {"F": 64, "W": 8, "K": 8}   # the warp kernel's compile-time bounds
CHUNK = 128                       # steps a stage of the warp kernel's ring holds
MAX_THREADS = 512                 # block kernel: one thread per function (and per worker)
MAX_SMEM_BYTES = 232448           # dynamic shared memory one H100 block can use
_NAMES = ("nw", "fs", "free", "arrivals", "conc", "fparam", "promote",
          "dwell", "ntier", "frac", "scal")


def smem_bytes(kind: str, f: int, w: int) -> int:
    """Shared memory one block of layout ``kind`` takes (``warp_smem_bytes``
    and ``block_smem_bytes`` in the source)."""
    if kind == "warp":
        row = 4 if w <= 4 else 8
        return 16 + 4 * (4 * CHUNK * f + f * row + f + R.AG_N * f)
    if kind == "block":
        return 4 * (2 * f * (w | 1) + 2 * w + 2 * f + R.AG_N * f)
    raise ValueError(f"unknown cluster-step layout {kind!r}")


def layout(f: int, w: int, k: int) -> str:
    """The kernel layout for F functions, W workers and K schedule edges:
    ``"warp"`` within the warp kernel's bounds, else ``"block"``.  Raises
    ValueError for a table that neither takes."""
    if min(f, w, k) < 1:
        raise ValueError(f"empty grid: F={f} W={w} K={k}")
    if f <= WARP_MAX["F"] and w <= WARP_MAX["W"] and k <= WARP_MAX["K"] \
            and smem_bytes("warp", f, w) <= MAX_SMEM_BYTES:
        return "warp"
    if max(f, w) > MAX_THREADS:
        raise ValueError(f"F={f} functions and W={w} workers: the block kernel "
                         f"holds at most {MAX_THREADS} of each")
    if smem_bytes("block", f, w) > MAX_SMEM_BYTES:
        raise ValueError(f"F={f} x W={w} needs {smem_bytes('block', f, w)} bytes of "
                         f"shared memory, over the block's {MAX_SMEM_BYTES}")
    return "block"


def cluster_sim_plain(nw, fs, free, arrivals, conc, fparam, promote, dwell,
                      ntier, frac, scal, *, t_begin: int = 0, extras: bool = False):
    """A Python loop over T of the batched torch step (``ref.cluster_step_full``).

    ``now`` of step t is ``float32(t_begin + t) * dt`` of each cell, as in the
    kernel.  Returns ``(nw, fs, free, agg)`` with agg (C, AG_N), and with
    ``extras`` also (C, 2, F): per function, the steps' cold starts and idle
    GB-s, each summed in time order from zero.
    """
    c, t_steps, f = arrivals.shape
    agg = torch.zeros((c, R.AG_N), dtype=torch.float32, device=nw.device)
    cold = torch.zeros((c, f), dtype=torch.float32, device=nw.device)
    idle = torch.zeros_like(cold)
    dt = scal[:, R.SC_DT]
    for t in range(t_steps):
        now = torch.tensor(float(t_begin + t), dtype=torch.float32, device=nw.device) * dt
        nw, fs, free, d, (cold_t, idle_t) = R.cluster_step_full(
            nw, fs, free, arrivals[:, t], conc[:, t], now, fparam, promote,
            dwell, ntier, frac, scal)
        agg = agg + d
        cold = cold + cold_t
        idle = idle + idle_t
    if extras:
        return nw, fs, free, agg, torch.stack([cold, idle], dim=1)
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
    if c < 1:
        raise ValueError(f"empty grid: C={c}")
    return layout(f, w, k)


def cluster_sim_hopper(nw, fs, free, arrivals, conc, fparam, promote, dwell,
                       ntier, frac, scal, *, t_begin: int = 0, extras: bool = False):
    """Advance every cell through all T steps; the arguments and results of
    :func:`repro.kernels.cluster_step.cluster_sim_pallas`.

    nw (C, F, W); fs (C, F, FS_N); free (C, W); arrivals and conc (C, T, F);
    fparam/promote (C, F, 5); dwell/ntier (C, F, K); frac (C, 5);
    scal (C, SC_N); all float32.  Returns ``(nw, fs, free, agg)`` with agg
    (C, AG_N), and with ``extras`` also the per-function (cold, idle GB-s)
    sums (C, 2, F); step t runs at ``float32(t_begin + t) * dt``.  CUDA
    tensors go to a hand kernel (one launch, the layout :func:`layout`
    picks), CPU tensors to the plain version.
    """
    global launches
    args = (nw, fs, free, arrivals, conc, fparam, promote, dwell, ntier, frac,
            scal)
    if not 0 <= t_begin < 2 ** 24:
        raise ValueError(f"t_begin {t_begin} is not an integer step in [0, 2^24)")
    if nw.device.type == "cpu":
        return cluster_sim_plain(*args, t_begin=t_begin, extras=extras)
    if nw.device.type != "cuda":
        raise ValueError(f"the cluster step runs on cuda or cpu, not {nw.device}")
    _build.refuse_grad("cluster_step", "the simulator's step is not differentiated", *args)
    kind = _check(args)
    lib = library()
    c, f, w = nw.shape
    t, k = arrivals.shape[1], dwell.shape[2]
    nw_out, fs_out, free_out = (torch.empty_like(x) for x in (nw, fs, free))
    agg = torch.empty((c, R.AG_N), dtype=torch.float32, device=nw.device)
    ex = torch.empty((c, 2, f), dtype=torch.float32, device=nw.device) if extras else None
    code = _build.call(
        nw.device, lib.cluster_step_fwd, *(x.data_ptr() for x in args), nw_out.data_ptr(),
        fs_out.data_ptr(), free_out.data_ptr(), agg.data_ptr(),
        None if ex is None else ex.data_ptr(), c, f, w, k, t, int(t_begin),
        _LAYOUT_CODE[kind])
    _build.check(lib, "cluster_step", code)
    launches += 1
    layout_launches[kind] += 1
    if extras:
        return nw_out, fs_out, free_out, agg, ex
    return nw_out, fs_out, free_out, agg
