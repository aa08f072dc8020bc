"""Device milliseconds of stage 1's features per scan featurised: the banded
features of the circuit (``pipeline._prep_features`` -> ``ops/fpfh_sorted``)
and the selection features of the k-graph path (``models/fgr.fgr_features``)."""

WRAPS = {"features.banded": ("pcr_tpu_torch.pipeline", "_prep_features"),
         "features.selection": ("pcr_tpu_torch.models.fgr", "fgr_features")}


def read(trace):
    spans = [s for s in (trace.span("features.banded"), trace.span("features.selection")) if s]
    calls = sum(s.count for s in spans)
    if not calls:
        return None
    return 1e3 * sum(s.device_s for s in spans) / calls
