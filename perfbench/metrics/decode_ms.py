"""Mean milliseconds of one ``decode_step`` of the replica bundle after the
traced stretch, from the call to the end of the last device work it
launched (CUDA events)."""
from benchlib import readers


def read(run):
    return readers.timed_ms(run, "decode")
