"""Host milliseconds in rank 0's ``collective`` spans per pair delivered: the
program's span around every call of ``utils/collectives`` (the gathers of
stage 1's features and poses, stage 2's gather, stage 3's broadcast, the
barriers), the wait for the slowest rank included.  One reader for every
``collective_ms_per_pair.<suffix>`` entry."""

from portbench import program

WRAPS = dict(program.ENTRIES)


def read(trace):
    snap = program.snapshot()
    if snap is None or not program.has(snap, "collective") or trace.work <= 0:
        return None
    return program.host_ms(snap, "collective") / trace.work
