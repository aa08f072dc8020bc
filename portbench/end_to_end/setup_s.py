"""Seconds from the start of the process to the window: imports, the
program's kernels built or loaded, the inputs, one warm unit."""


def read(units, window_s, setup_s):
    return setup_s
