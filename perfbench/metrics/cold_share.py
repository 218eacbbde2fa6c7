"""Cold invokes over all invokes of the window, in percent (the router's
records' cold flags)."""


def read(run):
    recs = [s.record for s in run.served if s.record is not None]
    return 100.0 * sum(r.cold for r in recs) / len(recs) if recs else None
