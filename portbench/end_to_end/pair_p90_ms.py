"""The 90th percentile over all requests of the window, each from its start
to its return, in milliseconds (linear between order statistics)."""

import statistics


def read(units, window_s, setup_s):
    ms = [(b - a) * 1e3 for a, b, _ in units]
    if len(ms) == 1:
        return ms[0]
    return statistics.quantiles(ms, n=10, method="inclusive")[8]
