"""K1 (``csrc/band_nn.cu``, banded 1-NN) against its roofline: the least
time its launches' work needs (``roofline.k1_bound_s`` from each launch's
shapes) over the device time of what ``nn_kernels.nn1_band`` launched, in
per cent."""

from portbench import roofline


def _shapes(starts_el, q, r, *, q_tile, band):
    return (int(starts_el.shape[0]), int(q.shape[0]), int(r.shape[0]), int(q_tile), int(band))


WRAPS = {"k1": ("pcr_tpu_torch.ops.kernels.nn_kernels", "nn1_band", _shapes)}


def read(trace):
    span = trace.span("k1")
    if span is None or span.device_s <= 0:
        return None
    least = sum(roofline.k1_bound_s(*s) for s in trace.shapes["k1"])
    return 100.0 * least / span.device_s
