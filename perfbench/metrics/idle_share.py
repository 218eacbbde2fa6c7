"""The device's idle share of the traced stretch, in percent:
1 - (the union of its activities' intervals) / (the stretch)."""
from benchlib import readers


def read(run):
    return readers.idle_percent(run)
