"""Host milliseconds of the three closed forms (``closed_form.refine_lum``,
``refine_slerp``, ``refine_slerp_lum``) per refinement."""

_M = "pcr_tpu_torch.models.global_refine.closed_form"
WRAPS = {"closed.lum": (_M, "refine_lum"), "closed.slerp": (_M, "refine_slerp"),
         "closed.slerp_lum": (_M, "refine_slerp_lum")}


def read(trace):
    spans = [trace.span(k) for k in WRAPS]
    if any(s is None for s in spans) or trace.units <= 0:
        return None
    return 1e3 * sum(s.host_s for s in spans) / trace.units
