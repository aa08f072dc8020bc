"""LM iterations of ``pose_graph.global_optimization`` a refinement: its own
counter, pass1_iterations + pass2_iterations, averaged over the units."""


def read(trace):
    its = [o["info"]["pass1_iterations"] + o["info"]["pass2_iterations"]
           for o in trace.outputs if o.get("info")]
    if not its:
        return None
    return sum(its) / len(its)
