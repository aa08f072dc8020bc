"""Device operations that stage 2's M-GICP launched, per pair delivered:
``multiscale.multiscale_gicp_pyramids`` (the circuit) and
``pair_sharding.batched_mgicp`` (the k-graph path)."""

WRAPS = {"gicp.pyramids": ("pcr_tpu_torch.models.multiscale", "multiscale_gicp_pyramids"),
         "gicp.batched": ("pcr_tpu_torch.parallel.pair_sharding", "batched_mgicp")}


def read(trace):
    spans = [s for s in (trace.span("gicp.pyramids"), trace.span("gicp.batched")) if s]
    if not spans or trace.work <= 0:
        return None
    return sum(s.device_ops for s in spans) / trace.work
