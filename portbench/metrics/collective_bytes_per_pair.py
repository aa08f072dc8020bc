"""Bytes rank 0 sent through the mesh's collectives per pair delivered: the
program's counter ``collective.bytes`` (``utils/collectives``: a tensor's
bytes, an object's pickled size, nothing for a barrier or a broadcast's
receiver) over the window.  One reader for every
``collective_bytes_per_pair.<suffix>`` entry."""

from portbench import program

WRAPS = dict(program.ENTRIES)


def read(trace):
    snap = program.snapshot()
    if snap is None or "collective.bytes" not in snap.counters or trace.work <= 0:
        return None
    return snap.counters["collective.bytes"] / trace.work
