"""K11 (``csrc/mutual_nn.cu``, mutual 1-NN of the FPFH features) against its
roofline: the least time of 71 float32 operations a row pair
(``roofline.k11_bound_s``) over the device time of what
``nn_kernels.nn1_mutual`` launched, in per cent."""

from portbench import roofline


def _shapes(a, a_mask, b, b_mask, **_):
    return (int(a.shape[0]), int(b.shape[0]))


WRAPS = {"k11": ("pcr_tpu_torch.ops.kernels.nn_kernels", "nn1_mutual", _shapes)}


def read(trace):
    span = trace.span("k11")
    if span is None or span.device_s <= 0:
        return None
    least = sum(roofline.k11_bound_s(*s) for s in trace.shapes["k11"])
    return 100.0 * least / span.device_s
