"""Seconds from the process's start to the window's: imports, data and weights
made from the seed, the kernel build or load, the warm-up steps."""


def read(run):
    return run.setup_s
