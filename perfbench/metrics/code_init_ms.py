"""Mean ``code_init`` phase (kernel libraries and the warm-up prefill and
decode) of the cold starts sent after the traced stretch, in milliseconds."""
from benchlib import readers


def read(run):
    return readers.mean_phase_ms(run, "code_init")
