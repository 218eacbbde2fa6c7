"""The flash-attention kernels' share of their roofline, in percent: the
least time of the traced prefills' causal self-attention (one call a layer,
``work.flash_work`` at the invoke's shape) over the device time of the
activities named ``flash_fwd``."""
from benchlib import readers, work


def read(run):
    return readers.roofline_percent(run, "prefill", ("flash_fwd",), work.flash_work)
