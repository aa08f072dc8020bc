"""Scan pairs whose final poses the window's units delivered, over the whole
window."""


def read(units, window_s, setup_s):
    return sum(w for _, _, w in units) / window_s
