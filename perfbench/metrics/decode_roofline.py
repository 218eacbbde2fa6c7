"""The decode-attention kernels' share of their roofline, in percent: the
least time of the traced decode steps' attention (one call a layer over the
prompt's cache rows, ``work.decode_work``) over the device time of the
activities named ``decode_split`` and ``decode_combine``."""
from benchlib import readers, work


def read(run):
    return readers.roofline_percent(run, "decode", ("decode_split", "decode_combine"),
                                    work.decode_work)
