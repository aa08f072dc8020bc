"""Host milliseconds of ``pose_graph.global_optimization`` (which reads the
cost from the device every iteration) over its LM iterations."""

WRAPS = {"global_optimization": ("pcr_tpu_torch.models.global_refine.pose_graph",
                                 "global_optimization")}


def read(trace):
    span = trace.span("global_optimization")
    its = sum(o["info"]["pass1_iterations"] + o["info"]["pass2_iterations"]
              for o in trace.outputs if o.get("info"))
    if span is None or not its:
        return None
    return 1e3 * span.host_s / its
