"""Seconds from the process's start to the window's: imports, the kernels'
load (and their build, in a checkout's first run), the weights, the warm-up
prefill and the decode graph's capture."""


def read(run):
    return run.setup_s
