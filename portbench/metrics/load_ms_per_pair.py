"""Host milliseconds of ``utils/cloud.load_dataset`` (PCD parse through
``native/pcd_io.cc`` and the upload) per request."""

WRAPS = {"load": ("pcr_tpu_torch.utils.cloud", "load_dataset")}


def read(trace):
    span = trace.span("load")
    if span is None or trace.work <= 0:
        return None
    return 1e3 * span.host_s / trace.work
