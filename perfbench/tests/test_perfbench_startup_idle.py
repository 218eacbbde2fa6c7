"""``startup_idle.cold``: the device's idle share inside the traced
stretch's replica starts, read from a trace built by hand, and absent where
there is no device trace or no cold start in the stretch."""
import types

import pytest

from _harness import PERFBENCH  # noqa: F401  (puts the benchmark on the path)


def _read(trace):
    from benchlib import spec

    return spec._reader("startup_idle.cold")(types.SimpleNamespace(trace=trace))


def _trace(device, spans, window=(0, 1000)):
    from benchlib import trace

    return trace.Trace(window=window, device=device, spans=spans)


def test_idle_share_inside_the_replica_starts():
    # busy 100-200 and 150-300 (union 100-300) and 700-800; the start spans
    # 0-400 and 600-1000, the request 0-1000 around both
    tr = _trace([("gemm", 100, 200), ("gemm", 150, 300), ("copy", 700, 800),
                 ("copy", 900, 1200)],
                [("request", 0, 1000), ("cold_start", 0, 400), ("cold_start", 600, 1200)])
    # inside: 200 of 400, then 100 + 100 of 400 (the second clipped to the window)
    assert _read(tr) == pytest.approx(100.0 * (1 - 400 / 800))


def test_a_start_the_device_never_left_idle_reads_zero():
    tr = _trace([("init", 0, 500)], [("cold_start", 100, 400)])
    assert _read(tr) == 0.0


@pytest.mark.parametrize("trace", [
    None,                                                       # an untraced run
    _trace([], [("cold_start", 0, 400)]),                       # no device (the CPU)
    _trace([("gemm", 0, 10)], [("request", 0, 400)]),           # a warm stretch
    _trace([("gemm", 0, 10)], [("cold_start", 1000, 1400)]),    # a start past the stretch
])
def test_nothing_to_read(trace):
    assert _read(trace) is None
