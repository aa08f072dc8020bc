"""Spans and counters of the port, on the clock of ``torch.profiler``'s host
events.

    from pcr_tpu_torch.utils import trace
    trace.reset()
    trace.enable()
    ...                                  # run_full, run_pair, ...
    trace.disable()
    snap = trace.snapshot()              # spans, counters, launch shapes
    trace.write_chrome(snap, "run.json")

Off by default.  Off, ``span`` returns one shared no-op context after one
check of a module-level flag, and ``count``, ``record``, ``shape`` and a
function decorated with ``spanned`` return (or call through) after the same
check.  On, ``span(name, **attrs)`` keeps (name, start_ns,
end_ns, parent, root, attrs) in memory, nested by the order in which spans
open and close on the calling thread (the port runs its work on one): the
parent is the span open around it, the root the outermost one (its own
index when nothing is open).  ``record`` keeps a span whose two times the
caller read itself, nested in the span open when it is recorded; a pair
read ``inflight`` pairs after its submission is one.  Nothing is written out
unless asked.

Nothing here reads the device: a span reads the host's clock, and a count
takes a number the host holds already.  The clock is ``time.time_ns()``:
Kineto converts its own clock to Unix time and sets CUPTI's device times
against it, so a span lies over a profiler trace without an anchor.

The kernels' launch counters stay where they are (``LAUNCHES`` in
``ops/kernels``): ``snapshot`` reads them in place, as their change since
``reset``, under ``launches.<kernel>``; with tracing on each kernel wrapper
also gives its launch shape to ``shape``.
"""

from __future__ import annotations

import contextlib
import functools
import json
import time
from typing import NamedTuple

_on = False
_spans: list[list] = []          # [name, start_ns, end_ns, parent, root, attrs]
_open: list[int] = []            # indices of the open spans, innermost last
_counters: dict[str, int] = {}
_shapes: dict[str, list] = {}
_launches0: dict[str, int] = {}  # LAUNCHES at the last reset
_OFF = contextlib.nullcontext()


class Snapshot(NamedTuple):
    spans: list        # (name, start_ns, end_ns, parent, root, attrs); -1: no parent
    counters: dict     # name -> count, and launches.<kernel> since reset
    shapes: dict       # kernel -> [launch shape, ...]


def _launch_counters() -> dict[str, int]:
    from ..ops.kernels import (feature_kernels, gicp_kernels, graph_kernels, loop_kernels,
                               nn_kernels)

    return {k: v for m in (nn_kernels, feature_kernels, loop_kernels, graph_kernels,
                           gicp_kernels)
            for k, v in m.LAUNCHES.items()}


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    """True while the tracer is on: the one check of a site that must
    compute a span's attribute before it opens the span."""
    return _on


def reset() -> None:
    """Forget every span, counter and shape; call it with no span open."""
    _spans.clear()
    _open.clear()
    _counters.clear()
    _shapes.clear()
    _launches0.clear()
    _launches0.update(_launch_counters())


def _append(name: str, start: int, end: int, attrs: dict) -> int:
    parent = _open[-1] if _open else -1
    i = len(_spans)
    _spans.append([name, start, end, parent, _spans[parent][4] if parent >= 0 else i, attrs])
    return i


class _Span:
    __slots__ = ("name", "attrs", "rec")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        i = _append(self.name, time.time_ns(), 0, self.attrs)
        self.rec = _spans[i]
        _open.append(i)
        return self

    def __exit__(self, *exc):
        self.rec[2] = time.time_ns()
        if _open:
            _open.pop()
        return False


def span(name: str, **attrs):
    """A context that times its block as span ``name`` (no-op when off)."""
    if not _on:
        return _OFF
    return _Span(name, attrs)


def spanned(name: str):
    """Decorator: every call of the function is span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            with _Span(name, {}):
                return fn(*args, **kwargs)
        return call
    return wrap


def record(name: str, start_ns: int, end_ns: int, **attrs) -> None:
    """Keep a span timed by the caller (``time.time_ns()`` reads)."""
    if _on:
        _append(name, start_ns, end_ns, attrs)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name``."""
    if _on:
        _counters[name] = _counters.get(name, 0) + n


def counter(name: str) -> int:
    """Counter ``name`` as it stands (0 when nothing was counted)."""
    return _counters.get(name, 0)


def shape(kernel: str, *dims: int) -> None:
    """Keep the shape of one launch of ``kernel`` (its wrapper counts it in
    ``LAUNCHES``)."""
    if _on:
        _shapes.setdefault(kernel, []).append(dims)


def snapshot() -> Snapshot:
    """The spans, counters and launch shapes kept since ``reset``; the
    counter ``syncs`` is the number of ``sync`` spans."""
    counters = dict(_counters)
    syncs = sum(1 for s in _spans if s[0] == "sync")
    if syncs:
        counters["syncs"] = syncs
    for k, v in _launch_counters().items():
        counters[f"launches.{k}"] = v - _launches0.get(k, 0)
    return Snapshot([tuple(s) for s in _spans], counters,
                    {k: list(v) for k, v in _shapes.items()})


def write_chrome(snap: Snapshot, path: str) -> None:
    """Write ``snap`` as Chrome trace-event JSON (Perfetto, chrome://tracing):
    one complete event a span on the host thread, ``pair`` spans, which
    overlap one another, as async events on a track of their own.  ``ts`` is
    Unix time in microseconds, the clock of the spans; a ``torch.profiler``
    export states its times against its ``baseTimeNanoseconds`` instead.
    The counters and launch shapes go under ``otherData``."""
    events = []
    for i, (name, a, b, parent, root, attrs) in enumerate(snap.spans):
        args = dict(attrs, span=i, parent=parent, root=root)
        if name == "pair":
            for ph, t in (("b", a), ("e", b)):
                events.append({"name": name, "cat": "pair", "ph": ph, "id": i, "ts": t / 1e3,
                               "pid": 0, "tid": 1, "args": args})
        else:
            events.append({"name": name, "ph": "X", "ts": a / 1e3, "dur": (b - a) / 1e3,
                           "pid": 0, "tid": 0, "args": args})
    with open(path, "w") as fh:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                   "otherData": {"counters": snap.counters, "shapes": snap.shapes}}, fh)
