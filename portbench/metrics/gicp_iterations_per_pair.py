"""Gauss-Newton iterations of GICP per pair delivered: the program's own
counter ``gicp.iterations`` (``models/gicp.registration_gicp`` adds each
call's iterations, every scale of the M-GICP and every retry) over the
window.  One reader for every ``gicp_iterations_per_pair.<suffix>`` entry."""

from portbench import program

WRAPS = dict(program.ENTRIES)


def read(trace):
    snap = program.snapshot()
    if snap is None or "gicp.iterations" not in snap.counters or trace.work <= 0:
        return None
    return snap.counters["gicp.iterations"] / trace.work
