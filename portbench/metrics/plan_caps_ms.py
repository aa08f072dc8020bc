"""Host milliseconds of ``utils/cloud.plan_scale_caps`` (the pyramid's
capacity planner) per unit."""

WRAPS = {"plan_caps": ("pcr_tpu_torch.utils.cloud", "plan_scale_caps")}


def read(trace):
    span = trace.span("plan_caps")
    if span is None or trace.units <= 0:
        return None
    return 1e3 * span.host_s / trace.units
