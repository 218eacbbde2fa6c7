"""The device's idle share inside the traced stretch's cold starts, in
percent: 1 - (the union of the device's activities inside each replica
start) / (the replica starts' time).  A replica start is the benchmark's
``cold_start`` span around the router's ``pool.start_replica``, which holds
the engine's whole cold start (the build check, the weight draw, the
warm-up).  Nothing to read where the device was not traced or the stretch
holds no cold start."""


def read(run):
    tr = run.trace
    if tr is None or not tr.device:
        return None
    w0, w1 = tr.window
    starts = [(max(a, w0), min(b, w1)) for _, a, b in tr.spans_named("cold_start")]
    starts = [(a, b) for a, b in starts if b > a]
    total = sum(b - a for a, b in starts)
    if total <= 0:
        return None
    busy = tr.busy_intervals()
    inside = sum(max(0, min(b, s1) - max(a, s0)) for s0, s1 in starts for a, b in busy)
    return 100.0 * (1.0 - inside / total)
