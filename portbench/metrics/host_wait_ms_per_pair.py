"""Host milliseconds spent waiting on device reads per pair delivered: the
program's ``sync`` spans (GICP's convergence flag, the pair reads of the
streamed loops and ``run_pair``, the gate, information and stage-3 reads,
the pose graph's cost) over the window.  One reader for every
``host_wait_ms_per_pair.<suffix>`` entry."""

from portbench import program

WRAPS = dict(program.ENTRIES)


def read(trace):
    snap = program.snapshot()
    if snap is None or not program.has(snap, "sync") or trace.work <= 0:
        return None
    return program.host_ms(snap, "sync") / trace.work
