"""Device operations that GICP launched per Gauss-Newton iteration: the
operations launched inside ``models/gicp.registration_gicp`` (the calls of
each ``gicp.scale`` span: the correspondence sweeps, the normal equations,
the pose update, the index and the final metrics) over the program's counter
``gicp.iterations``."""

from portbench import program

WRAPS = dict(program.ENTRIES,
             **{"gicp.registration": ("pcr_tpu_torch.models.gicp", "registration_gicp")})


def read(trace):
    snap = program.snapshot()
    span = trace.span("gicp.registration")
    its = None if snap is None else snap.counters.get("gicp.iterations")
    if span is None or not its:
        return None
    return span.device_ops / its
