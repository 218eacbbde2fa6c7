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
                 source hash, and its check at each cold start is the
                 ``engine.build_check`` span, outside every phase)
  execute        the requests

Mitigation paths: snapshot/restore (a ``torch.save`` state dict with a
pinned host copy in process, and a process-level cache of loaded libraries
and warmed keys: a restore of a warmed key skips the warm-up, as a JAX
restore skips the compile), scale-to-zero (``shutdown()``) and fusion:
``fuse_chain`` runs a chain of stages as one program, on the card one CUDA
graph (one capture for the chain, where the reference compiles it once).

Every phase ends in ``torch.cuda.synchronize()`` before its clock stops.

With an :class:`~repro_torch.core.events.EventLog` (``events=``), a cold
start and a request emit spans on ``time.perf_counter_ns``.
``engine.cold_start`` holds ``engine.build_check`` (counter ``built``: the
libraries ``nvcc`` compiled) and one span a phase, each the ``Breakdown``'s
own reading: ``engine.provision``, ``engine.runtime_init``,
``engine.deps_load`` (counters ``bytes``, on the card what the phase left
allocated, and ``segments``, the caching allocator's new segments) and
``engine.code_init`` (holding ``engine.libraries`` and ``engine.warmup``).
A request emits ``engine.h2d``, ``engine.prefill`` (to its synchronise) and,
a step, ``engine.readback`` and ``engine.decode_step`` (host time: no
synchronise is added).
"""
from __future__ import annotations

import contextlib
import os
import tempfile
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.events import EventLog, span
from repro_torch.core.lifecycle import Breakdown, Phase
from repro_torch.device import resolve_device
from repro_torch.kernels import _build, decode_attention, flash_attention, ssm_scan
from repro_torch.models import registry


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Timer:
    """One cold start's phases, each read on ``time.perf_counter_ns`` from
    its start to the synchronise that ends it.  The ``Breakdown`` and the
    phases' spans come from the same readings."""

    def __init__(self, device: torch.device, events: Optional[EventLog]):
        self.device = device
        self.events = events
        self.seconds: Dict[Phase, float] = {}

    @contextlib.contextmanager
    def phase(self, p: Phase, counters: Optional[Callable[[], Dict[str, int]]] = None):
        """Time phase ``p``; ``counters`` (read after the phase's clock
        stops, with a log only) gives its span's counters."""
        t0 = time.perf_counter_ns()
        yield
        _sync(self.device)
        t1 = time.perf_counter_ns()
        self.seconds[p] = self.seconds.get(p, 0.0) + (t1 - t0) / 1e9
        if self.events is not None:
            self.events.span(f"engine.{p.value}", t0, t1,
                             **(counters() if counters is not None else {}))

    def breakdown(self) -> Breakdown:
        return Breakdown(dict(self.seconds))


def _allocator(device: torch.device) -> Tuple[int, int]:
    """(bytes allocated now, segments allocated so far) of the caching
    allocator on ``device``: one read of its statistics (~0.25 ms)."""
    stats = torch.cuda.memory_stats(device)
    return stats.get("allocated_bytes.all.current", 0), stats.get("segment.all.allocated", 0)


# --------------------------------------------------------------------------- #
# snapshot store (vHive/Catalyzer analogue)
# --------------------------------------------------------------------------- #


_ALIGN = 256      # byte alignment of each tensor in a host image


def _view(buf: torch.Tensor, offset: int, like: torch.Tensor) -> torch.Tensor:
    """The tensor of ``like``'s dtype and shape at byte ``offset`` of the
    flat uint8 ``buf``."""
    n = like.numel() * like.element_size()
    return buf[offset:offset + n].view(like.dtype).view(like.shape)


class SnapshotStore:
    """Weight snapshots on disk, a pinned host copy of each in process, and a
    cache of ready "executables" in process.

    A snapshot is the engine's ``state_dict`` written by ``torch.save``; the
    file is the source of truth.  Where CUDA is present, ``save_params`` also
    keeps a page-locked host image of the state (outside the timed phases,
    as the snapshot itself is written): one flat buffer holding every
    tensor at a 256-byte aligned offset, and ``host[key]``, the tensors as
    views into it.  ``load_params`` restores that image with one device
    allocation and one asynchronous copy, and returns the same views into
    the device buffer: the restore runs at the host link's rate instead of
    the disk's, and pays no per-tensor allocation (a tensor at a time, the
    allocator's new segments stall the copies behind them).  A store
    without the image (a new process, or the CPU) reads the file,
    memory-mapped, with ``weights_only=True``: no pickle of foreign types.
    The executable cache maps an engine key to its loaded kernel libraries;
    a key present there has been warmed up in this process.
    """

    def __init__(self, root: Optional[str] = None):
        self.root = root or os.path.join(tempfile.gettempdir(), "coldtorch_snapshots")
        os.makedirs(self.root, exist_ok=True)
        self.executables: Dict[str, Any] = {}
        self.host: Dict[str, Dict[str, torch.Tensor]] = {}
        self._images: Dict[str, torch.Tensor] = {}

    # params ------------------------------------------------------------- #
    def _path(self, key: str) -> str:
        return os.path.join(self.root, key.replace("/", "_") + ".pt")

    def has_params(self, key: str) -> bool:
        return os.path.exists(self._path(key))

    def save_params(self, key: str, params: Mapping[str, torch.Tensor]) -> int:
        path = self._path(key)
        tmp = f"{path}.{os.getpid()}.tmp"
        state = {k: v.detach() for k, v in params.items()}
        torch.save(state, tmp)
        os.replace(tmp, path)
        if torch.cuda.is_available():
            offsets, size = {}, 0
            for k, v in state.items():
                offsets[k] = size
                size += -(-v.numel() * v.element_size() // _ALIGN) * _ALIGN
            image = torch.empty(size, dtype=torch.uint8, pin_memory=True)
            self.host[key] = {k: _view(image, offsets[k], v).copy_(v)
                              for k, v in state.items()}
            self._images[key] = image
        return os.path.getsize(path)

    def load_params(self, key: str, device: Union[str, torch.device]) -> Dict[str, torch.Tensor]:
        """The snapshot's tensors on ``device``.  The copy from the pinned
        host image is asynchronous: the caller synchronises before it reads
        the tensors."""
        image = self._images.get(key)
        if image is None:
            src = torch.load(self._path(key), weights_only=True, mmap=True,
                             map_location="cpu")
            return {k: v.to(device) for k, v in src.items()}
        buf = torch.empty_like(image, device=device)
        buf.copy_(image, non_blocking=True)
        return {k: _view(buf, v.storage_offset() * v.element_size(), v)
                for k, v in self.host[key].items()}

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
                 device: Union[str, torch.device] = "cuda",
                 events: Optional[EventLog] = None):
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
        self.events = events

    # ------------------------------------------------------------------ #
    @property
    def key(self) -> str:
        return f"{self.arch}_s{self.max_seq}_b{self.batch}_{self.smoke}"

    def package_bytes(self) -> int:
        if self.params is None:
            return 0
        return sum(t.numel() * t.element_size() for t in self.params.state_dict().values())

    def _prefill_batch_spec(self) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
        """(shape, dtype) of each prefill input: the one batch the reference
        compiles its prefill for — tokens, plus ``frames`` for an encoder and
        ``image_embeds`` for a vision config, in ``cfg.dtype``."""
        cfg = self.bundle.cfg
        act = getattr(torch, cfg.dtype)
        spec = {"tokens": ((self.batch, self.max_seq), torch.int64)}
        if cfg.encoder is not None:
            spec["frames"] = ((self.batch, cfg.encoder.num_frames, cfg.encoder.d_model), act)
        if cfg.vision is not None:
            spec["image_embeds"] = ((self.batch, cfg.vision.num_image_tokens,
                                     cfg.vision.d_embed), act)
        return spec

    def _warm_up(self) -> None:
        """One prefill on zero inputs of the batch spec and one decode step."""
        batch = {k: torch.zeros(shape, dtype=dtype, device=self.device)
                 for k, (shape, dtype) in self._prefill_batch_spec().items()}
        logits, caches, pos = self.bundle.prefill(self.params, batch)
        self.bundle.decode_step(self.params, caches, logits.argmax(-1), pos)

    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def cold_start(self, *, from_snapshot: bool = False) -> Breakdown:
        """Full measured startup.  Returns the per-phase breakdown."""
        ev, cuda = self.events, self.device.type == "cuda"
        with span(ev, "engine.cold_start"):
            if cuda:
                with span(ev, "engine.build_check") as sp:
                    built = _build.compiled
                    _build.build()
                    sp.count(built=_build.compiled - built)
            t = _Timer(self.device, ev)
            with t.phase(Phase.PROVISION):
                if cuda:
                    torch.empty(0, device=self.device)   # creates the CUDA context
            with t.phase(Phase.RUNTIME_INIT):
                self.bundle = registry.build_arch(self.arch, smoke=self.smoke,
                                                  max_seq=self.max_seq, device=self.device)
            use_snap = (from_snapshot and self.store is not None
                        and self.store.has_params(self.key))
            before = _allocator(self.device) if ev is not None and cuda else (0, 0)

            def placed() -> Dict[str, int]:
                """The bytes the phase left allocated on the card and the
                allocator's new segments; on the CPU the weights' bytes."""
                if not cuda:
                    return {"bytes": self.package_bytes()}
                now = _allocator(self.device)
                return {"bytes": now[0] - before[0], "segments": now[1] - before[1]}

            with t.phase(Phase.DEPS_LOAD, placed):
                if use_snap:
                    state = self.store.load_params(self.key, self.device)  # copy in flight
                    self.params = self.bundle.empty()
                    self.params.load_state_dict(state, assign=True)
                else:
                    gen = torch.Generator(device=self.device).manual_seed(self.seed)
                    self.params = self.bundle.init(gen)
            with t.phase(Phase.CODE_INIT):
                exe = None if self.store is None else self.store.get_executable(self.key)
                if exe is None:
                    with span(ev, "engine.libraries"):
                        libs = _kernel_libraries(self.device)
                    with span(ev, "engine.warmup"):
                        self._warm_up()
                    if self.store is not None:
                        self.store.put_executable(self.key, libs)
            if self.store is not None and not self.store.has_params(self.key):
                self.store.save_params(self.key, self.params.state_dict())
            self.warm = True
        return t.breakdown()

    def shutdown(self):
        """Scale to zero: drop device state (keep nothing warm)."""
        self.params = None
        self.bundle = None
        self.warm = False

    # ------------------------------------------------------------------ #
    def _check_extras(self, extras: Mapping[str, np.ndarray]) -> None:
        """The reference's compiled prefill takes exactly its batch spec:
        an unknown key, a missing input or a wrong shape is refused."""
        spec = self._prefill_batch_spec()
        for key in extras:
            if key == "tokens" or key not in spec:
                raise ValueError(f"{self.arch}: the prefill takes no {key!r} input")
        for key, (shape, _) in spec.items():
            if key == "tokens":
                continue
            if key not in extras:
                raise ValueError(f"{self.arch}: the prefill needs {key!r} of shape {shape}")
            got = tuple(np.shape(extras[key]))
            if got != shape:
                raise ValueError(f"{self.arch}: {key!r} must be {shape}, got {got}")

    @torch.inference_mode()
    def serve(self, tokens: np.ndarray, *, decode_steps: int = 8,
              extras: Optional[Mapping[str, np.ndarray]] = None
              ) -> Tuple[np.ndarray, ServeStats]:
        """Greedy generation; measures prefill + decode wall time.

        ``tokens`` is (batch, max_seq), the one prefill shape the engine was
        warmed for (the JAX engine's compiled shape).  ``extras`` are merged
        into the prefill batch, as in the reference: ``frames`` for an
        encoder-decoder, ``image_embeds`` for a vision config, each of the
        batch spec's shape.
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
        extras = extras or {}
        self._check_extras(extras)
        return generate(self.bundle, self.params, tokens, decode_steps=decode_steps,
                        extras=extras, events=self.events)


@torch.inference_mode()
def generate(bundle: registry.ModelBundle, params, tokens: np.ndarray, *,
             decode_steps: int, extras: Optional[Mapping[str, np.ndarray]] = None,
             events: Optional[EventLog] = None) -> Tuple[np.ndarray, ServeStats]:
    """The engine's request loop on any bundle: one prefill, then greedy
    decode steps, each part timed up to a device synchronise.  With
    ``events``, the spans ``engine.h2d``, ``engine.prefill`` (the reading
    ``prefill_s`` takes) and, a step, ``engine.readback`` (the token's copy
    to the host, where the host waits on the device) and
    ``engine.decode_step`` (the call to its return)."""
    stats = ServeStats()
    with span(events, "engine.h2d"):
        batch = {"tokens": torch.as_tensor(tokens, dtype=torch.int64).to(bundle.device)}
        if extras:
            batch.update({k: torch.as_tensor(v).to(bundle.device) for k, v in extras.items()})
    t0 = time.perf_counter_ns()
    logits, caches, pos = bundle.prefill(params, batch)
    _sync(bundle.device)
    t1 = time.perf_counter_ns()
    stats.prefill_s = (t1 - t0) / 1e9
    if events is not None:
        events.span("engine.prefill", t0, t1)
    out = []
    tok = logits.argmax(-1)
    t0 = time.perf_counter_ns()
    for i in range(decode_steps):
        with span(events, "engine.readback"):
            out.append(tok.to(torch.int32).cpu().numpy())
        with span(events, "engine.decode_step"):
            logits, caches = bundle.decode_step(params, caches, tok, pos + i)
        tok = logits.argmax(-1)
    _sync(bundle.device)
    stats.decode_s = (time.perf_counter_ns() - t0) / 1e9
    stats.tokens = decode_steps
    return np.stack(out, axis=1), stats


# --------------------------------------------------------------------------- #
# function fusion: chain LM stages into one program
# --------------------------------------------------------------------------- #


def fuse_chain(engines: List[InferenceEngine], *, decode_steps: int = 4
               ) -> Tuple[Callable[[Mapping[str, Any]], torch.Tensor], float]:
    """A chained pipeline of warm engines (stage i's greedy tokens feed stage
    i+1) as one program.  Returns ``(fn, compile_s)``; ``fn({"tokens": (B,
    S)})`` returns the last stage's (B, S) int32 tokens on the device.

    Each stage, as the reference's: ``tokens % vocab``, a prefill on the
    tokens alone, ``decode_steps`` greedy steps at ``S + i``, the generated
    tokens appended and the last S kept.  On the card the chain is one CUDA
    graph: one warm-up call, then a capture into static buffers; every token
    stays on the device, and ``compile_s`` is warm-up + capture +
    instantiate.  A failed capture raises.  On the CPU ``fn`` runs the chain
    eagerly and ``compile_s`` is the time of its first (warm-up) call.
    """
    bundles = [e.bundle for e in engines]
    params = [e.params for e in engines]
    if any(b is None for b in bundles):
        raise RuntimeError("cold engine in the chain — call cold_start() first")
    device = bundles[0].device
    if any(b.device != device for b in bundles):
        raise ValueError("the chain's engines must share one device")
    shape = (engines[0].batch, engines[0].max_seq)

    def chained(tokens):
        for bundle, p in zip(bundles, params):
            tokens = tokens % bundle.cfg.vocab_size
            logits, caches, _ = bundle.prefill(p, {"tokens": tokens})
            tok = logits.argmax(-1)
            outs = []
            for i in range(decode_steps):
                outs.append(tok)
                logits, caches = bundle.decode_step(p, caches, tok, tokens.shape[1] + i)
                tok = logits.argmax(-1)
            gen = torch.stack(outs, dim=1)                          # (B, steps)
            # generated tokens feed the next stage (same prompt length)
            tokens = torch.cat([tokens, gen], dim=1)[:, -tokens.shape[1]:]
        return tokens.to(torch.int32)

    def tokens_of(batch) -> torch.Tensor:
        tokens = torch.as_tensor(batch["tokens"]).to(device=device, dtype=torch.int64)
        if tuple(tokens.shape) != shape:
            raise ValueError(f"tokens must be {shape}, got {tuple(tokens.shape)}")
        return tokens

    static_in = torch.zeros(shape, dtype=torch.int64, device=device)
    t0 = time.perf_counter()
    with torch.inference_mode():
        if device.type != "cuda":
            chained(static_in)
            eager = torch.inference_mode()(lambda batch: chained(tokens_of(batch)))
            return eager, time.perf_counter() - t0
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            chained(static_in)
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            static_out = chained(static_in)
        _sync(device)
    compile_s = time.perf_counter() - t0

    @torch.inference_mode()
    def replay(batch):
        static_in.copy_(tokens_of(batch))
        graph.replay()
        return static_out.clone()

    return replay, compile_s
