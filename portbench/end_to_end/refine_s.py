"""The window over the refinements it ran: seconds a refinement."""


def read(units, window_s, setup_s):
    return window_s / len(units)
