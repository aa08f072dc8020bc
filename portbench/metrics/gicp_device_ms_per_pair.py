"""Device milliseconds of what stage 2's M-GICP launched, per pair delivered
(the spans of ``gicp_launches_per_pair.pairs``)."""

WRAPS = {"gicp.pyramids": ("pcr_tpu_torch.models.multiscale", "multiscale_gicp_pyramids"),
         "gicp.batched": ("pcr_tpu_torch.parallel.pair_sharding", "batched_mgicp")}


def read(trace):
    spans = [s for s in (trace.span("gicp.pyramids"), trace.span("gicp.batched")) if s]
    if not spans or trace.work <= 0:
        return None
    return 1e3 * sum(s.device_s for s in spans) / trace.work
