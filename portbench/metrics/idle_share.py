"""Share of the traced window in which nothing ran on the device:
1 - busy / window.  One reader for every ``idle_share.<suffix>`` entry (each
cell's own end-to-end metric is what it moves)."""


def read(trace):
    if trace.busy_s <= 0:
        return None
    return 1.0 - trace.busy_s / trace.window_s
