"""Seconds from the process's start to the window's opening: imports, the
CUDA context, kernel libraries, the router and the set-up invokes."""


def read(run):
    return run.setup_s
