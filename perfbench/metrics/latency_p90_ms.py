"""The 90th percentile (nearest rank) of every invoke's milliseconds from
when it was due on the open-loop schedule to when ``invoke`` returned; a
failed invoke lies beyond every limit (read as 1e12 where the percentile
falls on it)."""
import math


def read(run):
    lat = sorted(s.latency for s in run.served)
    if not lat:
        return None
    v = lat[max(0, math.ceil(0.9 * len(lat)) - 1)]
    return 1e3 * v if math.isfinite(v) else 1e12
