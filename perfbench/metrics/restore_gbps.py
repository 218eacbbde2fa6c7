"""Snapshot bytes (the configuration's weights) over the ``deps_load`` phase
of each cold start sent after the traced stretch, which restores them: GB/s, total over
total."""
from benchlib import readers, work


def read(run):
    startups = readers.cold_startups(run)
    seconds = sum(bd.seconds.get("deps_load", 0.0) for bd in startups)
    if not startups or seconds <= 0:
        return None
    return len(startups) * work.param_bytes(run.dims) / seconds / 1e9
