"""Builds the hand kernels in ``csrc/`` with ``nvcc`` at first use and loads
them with ``ctypes``.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface, ``build/repro_torch/<name>-<hash>.so`` at the repository root; the
hash covers the source, the shared headers ``csrc/*.cuh`` and its compiler
flags (the common ``NVCC_FLAGS`` and the source's own ``EXTRA_FLAGS``), so an
edited source or header is rebuilt and an unchanged one is loaded as it is.
:func:`build` starts one ``nvcc`` per missing library, all at once.  A failed
build raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence, Tuple

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("flash_attention", "flash_attention_bwd", "decode_attention", "cluster_step",
           "ssm_scan", "ssm_scan_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# per-source flags, appended to NVCC_FLAGS for that library only.  The cluster
# step rounds every product as its plain version does: a contracted FMA can
# flip the ceil / floor of a near-integer count.
EXTRA_FLAGS: Dict[str, Tuple[str, ...]] = {"cluster_step": ("-fmad=false",)}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
compiled = 0          # libraries this process has compiled with nvcc


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the hand kernels "
                           "are built from csrc/*.cu at first use")
    return found


def flags(name: str) -> Tuple[str, ...]:
    """The compiler flags of library ``name``."""
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(flags(name)).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def log_path(name: str) -> Path:
    """The compiler's output (ptxas registers / shared memory / spills)."""
    return library_path(name).with_suffix(".log")


def build() -> float:
    """Compile every missing library, one ``nvcc`` per source started
    together.  Returns the seconds spent (0.0 when all were built)."""
    with _lock:
        return _build_locked(SOURCES)


def _build_locked(names: Sequence[str]) -> float:
    global compiled
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs: Dict[str, Tuple[subprocess.Popen, Path]] = {}
    compiler = nvcc()
    for name in todo:
        tmp = library_path(name).with_suffix(f".{os.getpid()}.tmp.so")
        cmd = [compiler, *flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        output, _ = proc.communicate()
        log_path(name).write_text(output)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{output}")
            continue
        os.replace(tmp, library_path(name))
        compiled += 1
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """The loaded library ``name`` (built first if missing), with
    ``argtypes`` set from ``signatures`` and ``restype`` int for each entry."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            _build_locked((name,))
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int
            getattr(lib, f"{name}_error_string").argtypes = [ctypes.c_int]
            getattr(lib, f"{name}_error_string").restype = ctypes.c_char_p
            _loaded[name] = lib
        return lib


def call(device, fn, *args) -> int:
    """``fn(*args, stream)`` with ``device`` current and the raw handle of its
    current stream last: a C entry that launches on PyTorch's stream.  The
    device is switched only when it is not already current (a switch costs
    microseconds, and the attention kernels run once a layer a token)."""
    import torch

    index = device.index if device.index is not None else torch.cuda.current_device()
    if index == torch.cuda.current_device():
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))
    with torch.cuda.device(index):
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))


def needs_grad(*tensors) -> bool:
    """Whether autograd records an op on ``tensors``: grad mode is on and one
    of them requires grad."""
    import torch

    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def refuse_grad(kernel: str, missing: str, *tensors) -> None:
    """Raise where autograd would record a CUDA launch of ``kernel``: it has
    no backward (``missing`` says which is still to come), so its output would
    carry no gradient and training would go on without one, silently."""
    if needs_grad(*tensors):
        raise RuntimeError(
            f"{kernel} has no backward kernel ({missing}); its CUDA launch "
            f"cannot be differentiated.  Run it under torch.no_grad(), or on "
            f"the CPU, where its plain version is differentiable")


def check(lib: ctypes.CDLL, name: str, code: int) -> None:
    """Raise if a C entry returned a CUDA error."""
    if code != 0:
        msg = getattr(lib, f"{name}_error_string")(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {code} ({msg})")
