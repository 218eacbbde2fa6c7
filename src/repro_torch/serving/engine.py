"""Inference engine with *measured* cold starts (port of
``repro.serving.engine``).

A "serverless function" is a model endpoint, and its cold start is paid here
in the same four measured phases as the JAX engine:

  provision      CUDA context creation on the device
  runtime_init   building the model bundle (config, closures)
  deps_load      weight materialisation from the seed, or snapshot load
                 straight onto the device
  code_init      loading the hand-kernel libraries + one warm-up prefill and
                 one warm-up decode at the engine's shapes (there is no XLA
                 compile; the ``nvcc`` build is set-up, cached on disk by
                 source hash and timed apart as ``build_s``)
  execute        the requests

Mitigation paths: snapshot/restore (a ``torch.save`` state dict with a
pinned host copy in process, and a process-level cache of loaded libraries
and warmed keys: a restore of a warmed key skips the warm-up, as a JAX
restore skips the compile) and scale-to-zero (``shutdown()``).
``fuse_chain`` comes with a later slice.

Every phase ends in ``torch.cuda.synchronize()`` before its clock stops.
"""
from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.lifecycle import Breakdown, Phase
from repro_torch.device import resolve_device
from repro_torch.kernels import _build, decode_attention, flash_attention, ssm_scan
from repro_torch.models import registry


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Timer:
    def __init__(self, device: torch.device):
        self.device = device
        self.seconds: Dict[Phase, float] = {}

    def phase(self, p: Phase):
        timer = self

        class _Ctx:
            def __enter__(self):
                self.t0 = time.perf_counter()

            def __exit__(self, *a):
                _sync(timer.device)
                timer.seconds[p] = timer.seconds.get(p, 0.0) + (
                    time.perf_counter() - self.t0)

        return _Ctx()

    def breakdown(self) -> Breakdown:
        return Breakdown(dict(self.seconds))


# --------------------------------------------------------------------------- #
# snapshot store (vHive/Catalyzer analogue)
# --------------------------------------------------------------------------- #


class SnapshotStore:
    """Weight snapshots on disk, a pinned host copy of each in process, and a
    cache of ready "executables" in process.

    A snapshot is the engine's ``state_dict`` written by ``torch.save``; the
    file is the source of truth.  Where CUDA is present, ``save_params`` also
    keeps a page-locked host copy of every tensor (outside the timed phases,
    as the snapshot itself is written), and ``load_params`` fills tensors
    allocated on the device from it with asynchronous copies: the restore
    then runs at the host link's rate instead of the disk's.  A store without
    that copy (a new process, or the CPU) reads the file, memory-mapped,
    with ``weights_only=True``: no pickle of foreign types.  The executable
    cache maps an engine key to its loaded kernel libraries; a key present
    there has been warmed up in this process.
    """

    def __init__(self, root: Optional[str] = None):
        self.root = root or os.path.join(tempfile.gettempdir(), "coldtorch_snapshots")
        os.makedirs(self.root, exist_ok=True)
        self.executables: Dict[str, Any] = {}
        self.host: Dict[str, Dict[str, torch.Tensor]] = {}

    # params ------------------------------------------------------------- #
    def _path(self, key: str) -> str:
        return os.path.join(self.root, key.replace("/", "_") + ".pt")

    def has_params(self, key: str) -> bool:
        return os.path.exists(self._path(key))

    def save_params(self, key: str, state: Mapping[str, torch.Tensor]) -> int:
        path = self._path(key)
        tmp = f"{path}.{os.getpid()}.tmp"
        state = {k: v.detach() for k, v in state.items()}
        torch.save(state, tmp)
        os.replace(tmp, path)
        if torch.cuda.is_available():
            self.host[key] = {k: torch.empty_like(v, device="cpu", pin_memory=True).copy_(v)
                              for k, v in state.items()}
        return os.path.getsize(path)

    def load_params(self, key: str, device: Union[str, torch.device]) -> Dict[str, torch.Tensor]:
        """The snapshot's tensors on ``device``.  Copies from the pinned host
        copy are asynchronous: the caller synchronises before it reads them."""
        src = self.host.get(key)
        if src is None:
            src = torch.load(self._path(key), weights_only=True, mmap=True,
                             map_location="cpu")
        return {k: v.to(device, non_blocking=v.is_pinned()) for k, v in src.items()}

    # executables ---------------------------------------------------------- #
    def get_executable(self, key: str):
        return self.executables.get(key)

    def put_executable(self, key: str, compiled):
        self.executables[key] = compiled


# --------------------------------------------------------------------------- #
# the engine
# --------------------------------------------------------------------------- #


@dataclass
class ServeStats:
    prefill_s: float = 0.0
    decode_s: float = 0.0
    tokens: int = 0


def _kernel_libraries(device: torch.device) -> Tuple[Any, ...]:
    """Load the hand kernels a model's path can launch (none on the CPU)."""
    if device.type != "cuda":
        return ()
    return (flash_attention.library(), decode_attention.library(), ssm_scan.library())


class InferenceEngine:
    """One 'serverless function' instance (container analogue)."""

    def __init__(self, arch: str, *, smoke: bool = True, max_seq: int = 128,
                 batch: int = 1, store: Optional[SnapshotStore] = None,
                 runtime: str = "python-jit", seed: int = 0,
                 device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        self.arch = arch
        self.smoke = smoke
        self.max_seq = max_seq
        self.batch = batch
        self.store = store
        self.runtime = runtime    # the reference's label; the port runs eagerly
        self.seed = seed
        self.params = None
        self.bundle = None
        self.warm = False
        self.build_s = 0.0
        self.last_breakdown: Optional[Breakdown] = None
        self.last_used = 0.0

    # ------------------------------------------------------------------ #
    @property
    def key(self) -> str:
        return f"{self.arch}_s{self.max_seq}_b{self.batch}_{self.smoke}"

    def package_bytes(self) -> int:
        if self.params is None:
            return 0
        return sum(t.numel() * t.element_size() for t in self.params.state_dict().values())

    def _warm_up(self) -> None:
        """One prefill and one decode step at the engine's shapes."""
        tokens = torch.zeros((self.batch, self.max_seq), dtype=torch.int64,
                             device=self.device)
        logits, caches, pos = self.bundle.prefill(self.params, {"tokens": tokens})
        self.bundle.decode_step(self.params, caches, logits.argmax(-1), pos)

    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def cold_start(self, *, from_snapshot: bool = False) -> Breakdown:
        """Full measured startup.  Returns the per-phase breakdown."""
        if self.device.type == "cuda":
            self.build_s = _build.build()
        t = _Timer(self.device)
        with t.phase(Phase.PROVISION):
            if self.device.type == "cuda":
                torch.empty(0, device=self.device)   # creates the CUDA context
        with t.phase(Phase.RUNTIME_INIT):
            self.bundle = registry.build_arch(self.arch, smoke=self.smoke,
                                              max_seq=self.max_seq, device=self.device)
        use_snap = (from_snapshot and self.store is not None
                    and self.store.has_params(self.key))
        with t.phase(Phase.DEPS_LOAD):
            if use_snap:
                self.params = self.bundle.empty()
                self.params.load_state_dict(
                    self.store.load_params(self.key, self.device), assign=True)
            else:
                gen = torch.Generator(device=self.device).manual_seed(self.seed)
                self.params = self.bundle.init(gen)
        with t.phase(Phase.CODE_INIT):
            exe = None if self.store is None else self.store.get_executable(self.key)
            if exe is None:
                libs = _kernel_libraries(self.device)
                self._warm_up()
                if self.store is not None:
                    self.store.put_executable(self.key, libs)
        if self.store is not None and not self.store.has_params(self.key):
            self.store.save_params(self.key, self.params.state_dict())
        self.warm = True
        self.last_breakdown = t.breakdown()
        return self.last_breakdown

    def shutdown(self):
        """Scale to zero: drop device state (keep nothing warm)."""
        self.params = None
        self.bundle = None
        self.warm = False

    # ------------------------------------------------------------------ #
    def _check_extras(self, extras: Mapping[str, np.ndarray]) -> None:
        """The reference compiles its prefill for one batch spec: tokens, plus
        ``frames`` for an encoder and ``image_embeds`` for a vision config."""
        cfg = self.bundle.cfg
        usable = {"frames": cfg.encoder is not None,
                  "image_embeds": cfg.vision is not None}
        for key in extras:
            if not usable.get(key, False):
                raise ValueError(f"{self.arch}: the prefill takes no {key!r} input")
            raise NotImplementedError(
                f"{self.arch}: {key!r} inputs are not ported yet (ROADMAP item A5)")

    @torch.inference_mode()
    def serve(self, tokens: np.ndarray, *, decode_steps: int = 8,
              extras: Optional[Mapping[str, np.ndarray]] = None
              ) -> Tuple[np.ndarray, ServeStats]:
        """Greedy generation; measures prefill + decode wall time.

        ``tokens`` is (batch, max_seq), the one prefill shape the engine was
        warmed for (the JAX engine's compiled shape).  ``extras`` are merged
        into the prefill batch, as in the reference.
        """
        if not self.warm:
            raise RuntimeError("cold engine — call cold_start() first")
        tokens = np.asarray(tokens)
        if tokens.shape != (self.batch, self.max_seq):
            raise ValueError(f"tokens must be {(self.batch, self.max_seq)}, "
                             f"got {tokens.shape}")
        vocab = self.bundle.cfg.vocab_size
        if tokens.min() < 0 or tokens.max() >= vocab:
            # an out-of-range id would be a device-side assert in the gather
            raise ValueError(f"token ids must lie in [0, {vocab})")
        if extras:
            self._check_extras(extras)
        out, stats = generate(self.bundle, self.params, tokens, decode_steps=decode_steps,
                              extras=extras)
        self.last_used = time.monotonic()
        return out, stats


@torch.inference_mode()
def generate(bundle: registry.ModelBundle, params, tokens: np.ndarray, *,
             decode_steps: int, extras: Optional[Mapping[str, np.ndarray]] = None
             ) -> Tuple[np.ndarray, ServeStats]:
    """The engine's request loop on any bundle: one prefill, then greedy
    decode steps, each part timed up to a device synchronise."""
    stats = ServeStats()
    batch = {"tokens": torch.as_tensor(tokens, dtype=torch.int64).to(bundle.device)}
    if extras:
        batch.update({k: torch.as_tensor(v).to(bundle.device) for k, v in extras.items()})
    t0 = time.perf_counter()
    logits, caches, pos = bundle.prefill(params, batch)
    _sync(bundle.device)
    stats.prefill_s = time.perf_counter() - t0
    out = []
    tok = logits.argmax(-1)
    t0 = time.perf_counter()
    for i in range(decode_steps):
        out.append(tok.to(torch.int32).cpu().numpy())
        logits, caches = bundle.decode_step(params, caches, tok, pos + i)
        tok = logits.argmax(-1)
    _sync(bundle.device)
    stats.decode_s = time.perf_counter() - t0
    stats.tokens = decode_steps
    return np.stack(out, axis=1), stats
