"""The program's own spans and counters (``pcr_tpu_torch.utils.trace``) in a
traced run, for the per-layer readers that read them.

The harness installs the readers' ``WRAPS`` for the traced window alone, so
the wrapper of each kind's unit entry point (``ENTRIES``) marks the window's
start: the first call of one inside it resets the program's tracer and turns
it on, before the unit runs.  The first reader that asks for ``snapshot()``
turns it off and keeps what it recorded; the rest read the same snapshot.
The harness runs no program code between the window's end and its readers.

A program without the tracer gives ``None`` here, and every reader of it
then returns ``None``.
"""

from __future__ import annotations

_state: dict = {"on": False, "snap": None}


def _tracer():
    try:
        from pcr_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace


def _start(*_args, **_kwargs):
    """A ``WRAPS`` shapes function: turns the tracer on at the window's first
    unit (its result is kept as the call's shapes, and read by nobody)."""
    t = _tracer()
    if t is not None and not _state["on"]:
        t.reset()
        t.enable()
        _state["on"] = True


ENTRIES = {
    "unit.run_full": ("pcr_tpu_torch.pipeline", "run_full", _start),
    "unit.run_pair": ("pcr_tpu_torch.pipeline", "run_pair", _start),
    "unit.graph": ("pcr_tpu_torch.models.graph_builder", "full_registration_batched", _start),
    "unit.refine": ("pcr_tpu_torch.models.global_refine.closed_form", "refine_lum", _start),
}


def snapshot():
    """The tracer's snapshot of the window (spans, counters, shapes), or
    ``None`` when the program has no tracer or the window never started it."""
    if _state["snap"] is None and _state["on"]:
        t = _tracer()
        t.disable()
        _state["snap"] = t.snapshot()
    return _state["snap"]


def host_ms(snap, name: str, parent: str | None = None) -> float:
    """Summed host milliseconds of the spans ``name`` (only those whose
    parent span is ``parent``, when given)."""
    spans = snap.spans
    return 1e-6 * sum(b - a for n, a, b, p, _, _ in spans
                      if n == name and (parent is None or (p >= 0 and spans[p][0] == parent)))


def has(snap, name: str) -> bool:
    return any(s[0] == name for s in snap.spans)
