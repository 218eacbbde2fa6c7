"""One run of one cell: set-up, the measured window, the check, the line.

Set-up is everything before the window: the CUDA context, the kernel
libraries (built into ``build/repro_torch/`` inside the checkout by the
first run, loaded by the others), the router with the cell's endpoints and
the mix's ``setup`` invokes, which cold-start the first replica from the
seed and warm every shape the window uses.  In the window an open loop
sends each invoke when it is due (sleeping until then) and times it from
then; a closed loop sends them back to back while the window's seconds
last, and the window ends when the last one returns.  After it, the peak
memory is read, the program's replicas are released, and the reference
judges a sample of what was served.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from benchlib import check, spec, trace, traffic, work
from benchlib.traffic import Request

FOREIGN = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Served:
    request: Request
    prompt: np.ndarray
    due: float                    # seconds after the window opened
    done: float
    tokens: Optional[np.ndarray] = None
    record: Any = None            # the router's RequestRecord
    error: Optional[str] = None

    @property
    def latency(self) -> float:
        return self.done - self.due if self.error is None else float("inf")


@dataclass
class RunView:
    """What a metric's reader reads."""

    cell: spec.Cell
    dims: work.Dims
    setup_s: float
    window_s: float
    served: List[Served]
    trace: Optional[trace.Trace] = None
    untraced: List[Served] = field(default_factory=list)   # sent after the stretch
    timed: Dict[str, List[float]] = field(default_factory=dict)  # seconds a call


class Tracer:
    """The traced run's instruments.  torch.profiler, recording device
    activity alone, starts at the end of set-up and stops at the end of the
    mix's stretch (``trace``: ``start_s`` to ``start_s + seconds`` into the
    window, each edge taken at the first request boundary, or in an idle
    wait, that reaches it, the last at the window's close at the latest); a
    marker kernel on an idle device opens and closes the stretch, and the
    benchmark's spans inside it are on the host's clock.  Its results are
    read once the window has closed.

    The profiler slows every launch it records, so what the per-layer
    metrics take from the request loop comes from after the stretch: each
    ``prefill`` and ``decode`` call of the replica bundle there, between a
    pair of CUDA events, and the invokes sent once the profiler has stopped
    (``closed_s``).  On the CPU there is no device to profile or time: the
    stretch keeps its spans alone."""

    TIMED = ("prefill", "decode")

    def __init__(self, stretch: Optional[Dict[str, float]], device: str):
        self.stretch = stretch
        self.cuda = device == "cuda"
        self.state = "off" if stretch is None else "before"   # -> active -> after
        self.prof = None
        self.spans: List[trace.Span] = []
        self.markers: List[int] = []
        self.events: List[Tuple[str, Any, Any]] = []
        self.closed_s = 0.0           # window seconds at which the stretch closed
        self.trace: Optional[trace.Trace] = None
        self.timed: Dict[str, List[float]] = {}

    def _mark(self) -> None:
        """A marker kernel launched on an idle device; its launch's host
        time is kept."""
        import torch

        if self.cuda:
            torch.cuda.synchronize()
        self.markers.append(time.perf_counter_ns())
        if self.cuda:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()

    def begin(self) -> None:
        """Start the profiler at the end of set-up: a process's first start
        loads CUPTI, which takes seconds and grows with the kernels loaded
        (14 s once, after five cold starts)."""
        if self.stretch is not None and self.cuda:
            from torch.profiler import ProfilerActivity, profile
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.start()

    def _edge(self) -> Optional[float]:
        """The window second at which the stretch next opens or closes."""
        if self.state == "before":
            return float(self.stretch["start_s"])
        if self.state == "active":
            return float(self.stretch["start_s"]) + float(self.stretch["seconds"])
        return None

    def boundary(self, elapsed: float) -> None:
        edge = self._edge()
        if edge is None or elapsed < edge:
            return
        if self.state == "before":
            self._mark()
            self.state = "active"
        else:
            self._close(elapsed)

    def _close(self, elapsed: float) -> None:
        t = time.perf_counter()
        self._mark()
        if self.prof is not None:
            self.prof.stop()
        self.state = "after"
        self.closed_s = elapsed + time.perf_counter() - t

    def untraced(self, served: List["Served"]) -> List["Served"]:
        """The invokes sent while no profiler ran: all of an untraced run's,
        those sent after the stretch in a traced one."""
        if self.state == "off":
            return list(served)
        return [s for s in served if self.state == "after" and s.due >= self.closed_s]

    def wait(self, t0: float, due: float) -> None:
        """Sleep until ``due`` seconds into the window, opening or closing
        the stretch on the way where an edge falls in the wait."""
        while True:
            edge = self._edge()
            if edge is None or edge >= due:
                break
            time.sleep(max(0.0, edge - (time.perf_counter() - t0)))
            self.boundary(time.perf_counter() - t0)
        time.sleep(max(0.0, due - (time.perf_counter() - t0)))

    @contextlib.contextmanager
    def span(self, name: str):
        if self.state == "active":
            t0 = time.perf_counter_ns()
            try:
                yield
            finally:
                self.spans.append((name, t0, time.perf_counter_ns()))
        elif self.state == "after" and self.cuda and name in self.TIMED:
            import torch

            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            try:
                yield
            finally:
                end.record()
                self.events.append((name, start, end))
        else:
            yield

    def finish(self, elapsed: float) -> None:
        """After the window: close the stretch if it is still open, read the
        profiler's results and the CUDA events."""
        if self.state == "active":
            self._close(elapsed)
        if self.prof is not None:
            self.trace = trace.read(self.prof, self.spans, self.markers)
            self.prof = None
        elif len(self.markers) == 2:
            w0, w1 = self.markers
            self.trace = trace.Trace(window=(0, w1 - w0), device=[],
                                     spans=[(n, a - w0, b - w0) for n, a, b in self.spans])
        if self.events:
            import torch

            torch.cuda.synchronize()
            for name, start, end in self.events:
                self.timed.setdefault(name, []).append(start.elapsed_time(end) / 1e3)
            self.events = []


def _invoke(endpoint, request: Request, prompt: np.ndarray, due: float, t0: float,
            tracer: Tracer) -> Served:
    served = Served(request, prompt, due, due)
    try:
        with tracer.span("request"):
            served.tokens, served.record = endpoint.invoke(request.function, prompt)
    except Exception:        # a failed invoke is counted, and the window goes on
        served.error = traceback.format_exc(limit=4)
        print(f"invoke {request.index} failed:\n{served.error}", file=sys.stderr)
    served.done = time.perf_counter() - t0
    return served


def run_window(endpoint, cell: spec.Cell, seed: int, seconds: float,
               tracer: Tracer) -> Tuple[List[Served], float]:
    """The measured window: (every invoke's outcome, the window's seconds)."""
    t, vocab = cell.traffic, cell.config["vocab_size"]
    out: List[Served] = []
    if traffic.is_closed(t):
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            tracer.boundary(time.perf_counter() - t0)
            req = traffic.closed_request(t, len(out))
            prompt = traffic.prompt(t, vocab, seed, req.index)
            out.append(_invoke(endpoint, req, prompt, time.perf_counter() - t0, t0, tracer))
    else:
        plan = traffic.schedule(t, seed, seconds)
        prompts = [traffic.prompt(t, vocab, seed, r.index) for r in plan]
        t0 = time.perf_counter()
        for req, prompt in zip(plan, prompts):
            tracer.boundary(time.perf_counter() - t0)
            tracer.wait(t0, req.due)
            out.append(_invoke(endpoint, req, prompt, req.due, t0, tracer))
    window_s = time.perf_counter() - t0
    tracer.finish(window_s)
    return out, window_s


def set_up(endpoint, cell: spec.Cell, seed: int) -> None:
    """The mix's ``setup`` invokes, with prompts of their own."""
    t = cell.traffic
    for k, name in enumerate(t["setup"]["invokes"]):
        endpoint.invoke(name, traffic.prompt(t, cell.config["vocab_size"], seed, 10**9 + k))


def check_program(cell: spec.Cell, smoke: bool) -> None:
    """The program's configuration has the configuration file's sizes."""
    import importlib
    from repro_torch.config import canonical_arch_id

    mod = importlib.import_module(
        f"repro_torch.configs.{canonical_arch_id(cell.config['program_arch'])}")
    cfg = mod.SMOKE if smoke else mod.CONFIG
    c = cell.config
    got = dict(num_hidden_layers=cfg.num_layers, hidden_size=cfg.d_model,
               num_attention_heads=cfg.num_heads, num_key_value_heads=cfg.num_kv_heads,
               head_dim=cfg.head_dim, intermediate_size=cfg.d_ff, vocab_size=cfg.vocab_size,
               tie_word_embeddings=cfg.tie_embeddings, rope_theta=cfg.rope_theta,
               torch_dtype=cfg.param_dtype, norm=cfg.norm,
               hidden_act="silu" if cfg.act == "swiglu" else "gelu_pytorch_tanh")
    wrong = {k: (v, c[k]) for k, v in got.items() if v != c[k]}
    if wrong or cfg.dtype != cfg.param_dtype or cfg.qkv_bias or cfg.sliding_window:
        raise SystemExit(f"the program's {cfg.name} differs from the configuration file "
                         f"(program, file): {wrong}")


def summary(served: List[Served]) -> str:
    """The window's invokes in a line of standard error: how many, how many
    cold, and whether latencies grew from the first half to the second."""
    if not served:
        return "no invokes"
    lat = sorted(s.latency for s in served)
    half = max(1, len(served) // 2)
    first, second = (np.mean([s.latency for s in part])
                     for part in (served[:half], served[half:] or served))
    cold = sum(bool(s.record and s.record.cold) for s in served)
    return (f"{len(served)} invokes ({cold} cold), latency ms p50 {1e3 * lat[len(lat) // 2]:.1f} "
            f"max {1e3 * lat[-1]:.1f}, mean of the first half {1e3 * first:.1f} and of the "
            f"second {1e3 * second:.1f}")


def foreign_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FOREIGN)


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--smoke", action="store_true",
                   help="the program's SMOKE configuration and the mix's smoke block")
    args = p.parse_args(argv)
    if args.device == "cpu" and not args.smoke:
        p.error("--device cpu runs only with --smoke")
    return args


def device_check(cell: spec.Cell, device: str) -> Optional[str]:
    import torch

    if device == "cpu":
        return None
    if not torch.cuda.is_available():
        return "no CUDA device"
    if torch.cuda.device_count() < cell.chips:
        return f"{torch.cuda.device_count()} CUDA devices, the cell asks for {cell.chips}"
    return None


def free_device(device: str) -> None:
    gc.collect()
    if device == "cuda":
        import torch
        torch.cuda.empty_cache()


def main(argv, *, t_start: float) -> int:
    args = parse(argv)
    cell = spec.load_cell(args.workload, smoke=args.smoke)
    import torch

    torch.set_num_threads(2)
    refused = device_check(cell, args.device)
    if refused:
        print(f"perfbench: {refused}; no result", file=sys.stderr)
        return 2
    from benchlib.endpoint import opened

    check_program(cell, args.smoke)
    tracer = Tracer(cell.traffic["trace"] if args.trace else None, args.device)
    with opened(cell, device=args.device, smoke=args.smoke) as endpoint:
        if args.trace:
            endpoint.trace_spans(tracer.span)
        set_up(endpoint, cell, args.seed)
        tracer.begin()
        gc.collect()
        setup_s = time.perf_counter() - t_start
        served, window_s = run_window(endpoint, cell, args.seed, args.seconds, tracer)
        peak = torch.cuda.max_memory_allocated() if args.device == "cuda" else 0
    free_device(args.device)
    view = RunView(cell, work.Dims.of(cell.config), setup_s, window_s, served, tracer.trace,
                   tracer.untraced(served), tracer.timed)
    metrics = {}
    for m in (cell.per_layer if args.trace else cell.end_to_end):
        value = m.read(view)
        if value is not None:
            metrics[m.name] = {"value": value, "unit": m.unit}
    t_check = time.perf_counter()
    checks = check.judge(served, cell, args.seed, device=args.device)
    print(f"perfbench: set-up {setup_s:.3f} s, window {window_s:.3f} s, {summary(served)}; "
          f"check {time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    result: Dict[str, Any] = {
        "correct": check.is_correct(checks),
        "attempted": len(served),
        "failed": sum(s.error is not None for s in served),
        "metrics": metrics,
        "device": {"platform": "gpu" if args.device == "cuda" else "cpu",
                   "kind": torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu",
                   "count": cell.chips, "memory_peak_bytes": int(peak)},
    }
    if tracer.trace is not None:
        tr = tracer.trace
        print(f"perfbench: trace of {tr.window_ns / 1e9:.3f} s, {len(tr.device)} device "
              f"activities, {len(tr.spans)} spans, the markers' clocks {tr.skew_ns} ns apart",
              file=sys.stderr)
        result["device"]["busy_s"] = tr.busy_ns() / 1e9
        result["device"]["window_s"] = tr.window_ns / 1e9
        result["breakdown"] = {"device_ops": [list(x) for x in tr.by_name()[:10]],
                               "idle_gaps": [list(x) for x in tr.idle_gaps()[:10]]}
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    foreign = foreign_modules()
    if foreign:
        print(f"perfbench: the run loaded {foreign}; no result", file=sys.stderr)
        return 3
    for k, (v, lim) in checks.items():
        print(f"check {k}: {v!r} (limit {lim!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0
