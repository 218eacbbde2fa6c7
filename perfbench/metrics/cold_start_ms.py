"""Mean milliseconds from a cold invoke's arrival at the router to its
replica being ready (the router's ``RequestRecord``: start - arrival), over
the window's cold invokes."""


def read(run):
    colds = [s.record.start - s.record.arrival for s in run.served
             if s.record is not None and s.record.cold]
    return 1e3 * sum(colds) / len(colds) if colds else None
