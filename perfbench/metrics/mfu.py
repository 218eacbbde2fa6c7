"""The whole step's share of the chip's peak, in percent: the model FLOPs of
the invokes sent after the traced stretch, which opens the warm cells'
windows (``work.request_flops``), over the seconds from the first one's
sending to the last one's return, times 989e12.  Read only where the
device was traced, so never on the CPU."""
from benchlib import work


def read(run):
    done = [s for s in run.untraced if s.tokens is not None]
    if run.trace is None or not run.trace.device or not done:
        return None
    seconds = max(s.done for s in done) - min(s.due for s in done)
    t = run.cell.traffic
    flops = len(done) * work.request_flops(run.dims, t["batch"], t["prompt_len"],
                                           t["output_tokens"])
    return 100.0 * flops / (seconds * work.PEAK_FLOPS)
