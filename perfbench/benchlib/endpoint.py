"""The system under test: ``repro_torch``'s ``ServerlessRouter`` with the
cell's endpoints registered, driven one ``invoke`` at a time.

The mix's ``router`` block sets the keep-alive (``ttl_s``, the router's
``FixedTTL``), whether cold starts restore from snapshots, and how many
replicas the memory budget holds, each replica sized as its weights plus its
KV cache at the invoke's shape (``work``).  A snapshot store lives in a
fresh directory under ``TMPDIR``, removed by ``close``.
"""
from __future__ import annotations

import contextlib
import shutil
import tempfile
from typing import Any, Callable, Optional

import numpy as np

from benchlib import traffic, work


class Endpoint:
    def __init__(self, cell, *, device: str, smoke: bool):
        from repro_torch.fleet.pool import EngineProfile
        from repro_torch.serving.engine import SnapshotStore
        from repro_torch.serving.router import FunctionDef, ServerlessRouter

        t, router = cell.traffic, cell.traffic["router"]
        dims = work.Dims.of(cell.config)
        replica_gb = (work.param_bytes(dims)
                      + work.kv_bytes(dims, t["batch"], t["prompt_len"])) / 2**30
        self.router = None
        self.snapdir: Optional[str] = None
        store = None
        if router["snapshots"]:
            self.snapdir = tempfile.mkdtemp(prefix="perfbench-snapshots-")
            store = SnapshotStore(self.snapdir)
        try:
            # half a replica of slack, so that float rounding never evicts early
            self.router = ServerlessRouter(
                ttl_s=float(router["ttl_s"]), use_snapshots=bool(router["snapshots"]),
                memory_budget_gb=replica_gb * (router["resident_replicas"] + 0.5),
                store=store, device=device)
        except BaseException:
            self.close()
            raise
        for name in traffic.functions(t):
            self.router.register(FunctionDef(name, cell.config["program_arch"],
                                             max_seq=t["prompt_len"], batch=t["batch"],
                                             memory_gb=replica_gb,
                                             decode_steps=t["output_tokens"]))
            self.router.backend.profiles[name] = EngineProfile(
                arch=cell.config["program_arch"], max_seq=t["prompt_len"], batch=t["batch"],
                decode_steps=t["output_tokens"], smoke=smoke)

    def invoke(self, name: str, tokens: np.ndarray):
        return self.router.invoke(name, tokens)

    def trace_spans(self, span: Callable[[str], Any]) -> None:
        """Wrap the router's replica start and each replica bundle's
        ``prefill`` and ``decode_step`` in ``span(<name>)`` ranges (the
        traced run only)."""
        pool, backend = self.router.pool, self.router.backend
        start_replica, serve = pool.start_replica, backend.serve

        def wrap(fn, name):
            def spanned(*a, **k):
                with span(name):
                    return fn(*a, **k)
            spanned.perfbench_span = name
            return spanned

        def serve_spanned(replica, *a, **k):
            bundle = replica.engine.bundle
            if not hasattr(bundle.prefill, "perfbench_span"):
                bundle.prefill = wrap(bundle.prefill, "prefill")
                bundle.decode_step = wrap(bundle.decode_step, "decode")
            return serve(replica, *a, **k)

        pool.start_replica = wrap(start_replica, "cold_start")
        backend.serve = serve_spanned

    def close(self) -> None:
        """Release every replica (the engines drop their device state) and
        remove the snapshot directory."""
        if self.router is not None:
            for replica in list(self.router.pool.replicas.values()):
                self.router.pool.release(replica)
            self.router = None
        if self.snapdir is not None:
            shutil.rmtree(self.snapdir, ignore_errors=True)
            self.snapdir = None


@contextlib.contextmanager
def opened(cell, *, device: str, smoke: bool):
    endpoint = Endpoint(cell, device=device, smoke=smoke)
    try:
        yield endpoint
    finally:
        endpoint.close()
