"""Host milliseconds of an LM iteration of the pose graph spent waiting on
its cost read: the program's ``sync`` spans inside ``lm.iteration`` spans
(``pose_graph.optimize_pose_graph_once``) over its counter
``lm.iterations``."""

from portbench import program

WRAPS = dict(program.ENTRIES)


def read(trace):
    snap = program.snapshot()
    its = None if snap is None else snap.counters.get("lm.iterations")
    if not its or not program.has(snap, "lm.iteration"):
        return None
    return program.host_ms(snap, "sync", parent="lm.iteration") / its
