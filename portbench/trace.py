"""The traced run: spans around the program's functions, the device trace of
``torch.profiler``, and what the per-layer readers take from them.

Spans are the benchmark's own: in a ``--trace 1`` run each function that a
metric names in its ``WRAPS`` is replaced, for the run, by a wrapper that
opens ``torch.profiler.record_function(<span>)`` around the call and, where
the metric gives a ``shapes`` function, records the call's shapes.  A device
operation belongs to a span when the host launched it inside the span (the
launch and the device operation share the profiler's correlation id), so a
span's device time is the work it enqueued, wherever the device ran it.

The busy time is the union of the intervals of every kernel, copy and fill
on the device (the arithmetic of ``tools/profile_circuit.py``'s
``_union_us``, copied), the window the profiled span of whole units.  The
profiler records no operator of the program on the host (``profiler``), so
the traced window stays near the untraced one.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import functools
import importlib

SPAN_PREFIX = "pb."


def union_s(intervals) -> float:
    """Total length of the union of (start, end) intervals (seconds in,
    seconds out); a frozen copy of ``tools/profile_circuit._union_us``."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


@dataclasses.dataclass
class SpanStat:
    count: int = 0          # calls
    host_s: float = 0.0     # summed host durations
    device_s: float = 0.0   # device time of what the calls launched
    device_ops: int = 0     # device operations they launched


@dataclasses.dataclass
class Trace:
    """What one traced window recorded; the per-layer readers read it."""

    window_s: float
    busy_s: float
    units: int                                   # whole units traced
    work: int                                    # pairs (or requests) in them
    spans: dict[str, SpanStat]
    shapes: dict[str, list]                      # span -> recorded call shapes
    outputs: list                                # the units' outputs

    def span(self, name: str) -> SpanStat | None:
        s = self.spans.get(name)
        return s if s is not None and s.count else None


class Wraps:
    """Installs the span wrappers of a set of ``WRAPS`` for a block."""

    def __init__(self, wraps: dict):
        self.wraps = wraps                       # span -> (module, attr[, shapes_fn])
        self.shapes: dict[str, list] = {k: [] for k in wraps}

    @contextlib.contextmanager
    def installed(self):
        import torch

        saved = []
        try:
            for span, spec in self.wraps.items():
                module = importlib.import_module(spec[0])
                original = getattr(module, spec[1])
                shapes_fn = spec[2] if len(spec) > 2 else None

                def wrapper(*args, _orig=original, _span=span, _fn=shapes_fn, **kwargs):
                    if _fn is not None:
                        self.shapes[_span].append(_fn(*args, **kwargs))
                    with torch.profiler.record_function(SPAN_PREFIX + _span):
                        return _orig(*args, **kwargs)

                functools.update_wrapper(wrapper, original)
                setattr(module, spec[1], wrapper)
                saved.append((module, spec[1], original))
            yield self
        finally:
            for module, attr, original in reversed(saved):
                setattr(module, attr, original)


@contextlib.contextmanager
def profiler():
    """``torch.profiler`` over the device's operations, the runtime calls
    that launched them and the benchmark's own spans, but none of the
    program's operators on the host: the profiler observes only the
    ``record_function`` user scope.  Recording every operator stretched a
    traced circuit to twice its untraced time, and so the idle share."""
    import torch
    from torch.autograd import profiler as autograd_profiler
    from torch._C._profiler import RecordScope

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    enable = autograd_profiler._enable_profiler

    def enable_user_scope(config, activities, scopes=None):
        return enable(config, activities, {RecordScope.USER_SCOPE})

    autograd_profiler._enable_profiler = enable_user_scope
    try:
        with torch.profiler.profile(activities=acts) as prof:
            yield prof
    finally:
        autograd_profiler._enable_profiler = enable


def reduce(prof, span_names) -> tuple:
    """(busy_s, spans, kernels, idle_gaps) of the raw profiler events inside
    the window, which the harness marks with ``record_function("pb.window")``
    (the profiler keeps its own clock)."""
    events = prof.profiler.kineto_results.events()
    cpu, dev, marks = [], [], []
    for e in events:
        name = e.name()
        dtype = str(e.device_type())
        a = e.start_ns()
        b = a + e.duration_ns()
        if dtype.endswith("CPU"):
            if name.startswith(SPAN_PREFIX):
                marks.append((name[len(SPAN_PREFIX):], a, b))
            elif name.startswith("cu"):          # the runtime call that launched it
                cpu.append((e.correlation_id(), a))
        elif dtype.endswith("CUDA"):
            if name.startswith(SPAN_PREFIX) or (hasattr(e, "is_user_annotation")
                                                and e.is_user_annotation()):
                continue
            dev.append((name, a, b, e.correlation_id()))
    _, t0_ns, t1_ns = next(m for m in marks if m[0] == "window")
    launch_at = {}
    for corr, a in cpu:
        if corr > 0 and corr not in launch_at:
            launch_at[corr] = a
    inside = [(n, max(a, t0_ns), min(b, t1_ns), c) for n, a, b, c in dev
              if b > t0_ns and a < t1_ns]
    busy = union_s([(a * 1e-9, b * 1e-9) for _, a, b, _ in inside])
    kernels: dict[str, list] = {}
    for n, a, b, _ in inside:
        k = kernels.setdefault(n, [0.0, 0])
        k[0] += (b - a) * 1e-9
        k[1] += 1
    spans = {s: SpanStat() for s in span_names}
    by_span = {}
    for s, a, b in marks:
        if s in spans:
            spans[s].count += 1
            spans[s].host_s += (b - a) * 1e-9
            by_span.setdefault(s, []).append((a, b))
    for s, ivs in by_span.items():
        ivs.sort()
        starts = [a for a, _ in ivs]
        for n, a, b, corr in inside:
            t = launch_at.get(corr)
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and ivs[i][1] >= t:
                spans[s].device_s += (b - a) * 1e-9
                spans[s].device_ops += 1
    # idle gaps between device operations, named by the innermost span the
    # host was in when the gap opened
    ivs = sorted((a, b) for _, a, b, _ in inside)
    gaps, end = [], t0_ns
    for a, b in ivs:
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if t1_ns > end:
        gaps.append((end, t1_ns))
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for a, b in gaps[:10]:
        host = [(s, sa, sb) for s, sa, sb in marks if s != "window" and sa <= a < sb]
        label = min(host, key=lambda m: m[2] - m[1])[0] if host else "host"
        named.append((label, (b - a) * 1e-9))
    return busy, spans, {k: tuple(v) for k, v in kernels.items()}, named
