"""Mean milliseconds of the replica bundle's ``prefill`` after the traced
stretch, from the call to the end of the last device work it launched
(CUDA events)."""
from benchlib import readers


def read(run):
    return readers.timed_ms(run, "prefill")
