#!/usr/bin/env python3
"""A benchmark cell's units on the card with the port's tracer
(``pcr_tpu_torch.utils.trace``) laid over ``torch.profiler``'s device trace.

    python3 tools/trace_report.py <workload> [--units 8] [--seed 1] [--out FILE]

Builds the cell's inputs and runner as ``python3 -m portbench`` does
(``portbench/``: its configuration, traffic and seed), runs one warm unit,
then ``--units`` units under the benchmark's profiler (device operations,
runtime calls and user spans), the tracer off and on in turns (off, on, on,
off, ...).  Prints one JSON object (and writes it to ``--out``):

* ``unit_s``: the host seconds of each unit, tracer off and on, and their
  medians: the tracer's cost under the profiler;
* ``site_us``: host microseconds of one span site, tracer off and on
  (``span`` entered and left 200,000 times), and ``sites_per_work``: spans
  and launch shapes the tracer kept per pair (or request);
* ``gaps``: the ten longest stretches in which the device ran nothing
  while the tracer stayed on (two units in turn, and the host's work
  between them), each with its length, the innermost span the
  host was in when it opened (``sync`` and ``pair`` spans end at the read
  that opens a gap, so their parent names it), and the span whose own code
  (its time less its children's) the host ran longest during it;
* ``device_ops_by_span``: device operations each span name launched (by
  launch time, through the correlation id), and ``counters``.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import json
import os
import statistics
import sys
import tempfile
import time
import timeit
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
OPENERS = ("sync", "pair")       # spans that end as the read they wait for returns


def _gaps(device, t0, t1):
    """Idle stretches between the device intervals inside [t0, t1]."""
    gaps, end = [], t0
    for a, b in sorted(device):
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if t1 > end:
        gaps.append((end, t1))
    return gaps


def _names(spans, a, b):
    """(innermost span open at ``a``, skipping OPENERS; the span with the most
    own time inside [a, b]) of the tracer's spans."""
    open_at = [s for s in spans if s[1] <= a < s[2] and s[0] not in OPENERS]
    at_open = min(open_at, key=lambda s: s[2] - s[1])[0] if open_at else "host"
    own = collections.Counter()
    for i, s in enumerate(spans):
        lo, hi = max(s[1], a), min(s[2], b)
        if hi > lo and s[0] != "pair":
            own[i] += hi - lo
            if s[3] >= 0:
                own[s[3]] -= hi - lo
    most = max(own, key=own.get) if own else None
    return at_open, ("host" if most is None else spans[most][0])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tools/trace_report.py")
    ap.add_argument("workload")
    ap.add_argument("--units", type=int, default=8)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    from pcr_tpu_torch.utils import trace
    from portbench import run, work
    from portbench import trace as pb_trace

    if not torch.cuda.is_available():
        print("trace_report: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = run.load_spec(ROOT, args.workload)
    workdir = tempfile.mkdtemp(prefix="trace-report-")
    os.environ["PCR_REFERENCE_ROOT"] = os.path.join(workdir, "reference")
    runner = work.make(spec["base"], spec["config"], spec["traffic"], args.seed,
                       torch.device("cuda", 0), workdir)
    runner.setup()
    runner.unit(0)
    torch.cuda.synchronize()
    modes = [(k % 4) in (1, 2) for k in range(args.units)]
    units, work_on = [], 0
    trace.reset()
    with pb_trace.profiler() as prof:
        for k, on in enumerate(modes):
            (trace.enable if on else trace.disable)()
            a = time.time_ns()
            out = runner.unit(k + 1)
            units.append((a, time.time_ns(), on))
            work_on += runner.work(out) if on else 0
        trace.disable()
    snap = trace.snapshot()
    spans = snap.spans

    device, launch_at = [], {}
    for e in prof.profiler.kineto_results.events():
        dtype, name = str(e.device_type()), e.name()
        if dtype.endswith("CPU") and name.startswith("cu"):
            launch_at.setdefault(e.correlation_id(), e.start_ns())
        elif dtype.endswith("CUDA") and not name.startswith(pb_trace.SPAN_PREFIX) and not (
                hasattr(e, "is_user_annotation") and e.is_user_annotation()):
            device.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.correlation_id()))
    # the stretches in which the tracer stayed on: runs of units traced in turn
    stretches = []
    for k, (a, b, on) in enumerate(units):
        if on and k and units[k - 1][2]:
            stretches[-1][1] = b
        elif on:
            stretches.append([a, b])
    gaps = [g for g in _gaps([d[:2] for d in device], units[0][0], units[-1][1])
            if any(a <= g[0] and g[1] <= b for a, b in stretches)]
    gaps.sort(key=lambda g: g[0] - g[1])
    named = [[(b - a) * 1e-9, *_names(spans, a, b)] for a, b in gaps[:10]]

    ops = collections.Counter()
    by_name = collections.defaultdict(list)
    for s in spans:
        by_name[s[0]].append((s[1], s[2]))
    for name, ivs in by_name.items():
        ivs.sort()
        starts = [a for a, _ in ivs]
        for _, _, corr in device:
            t = launch_at.get(corr)
            i = -1 if t is None else bisect.bisect_right(starts, t) - 1
            if i >= 0 and ivs[i][1] >= t:
                ops[name] += 1

    def site():
        with trace.span("sync", site="x"):
            pass

    site_us = {}
    for on in (False, True):
        (trace.enable if on else trace.disable)()
        trace.reset()
        site_us["on" if on else "off"] = timeit.timeit(site, number=200_000) / 0.2
    trace.disable()
    trace.reset()
    secs = {m: [(b - a) * 1e-9 for a, b, on in units if on == (m == "on")] for m in ("off", "on")}
    n_sites = len(spans) + sum(len(v) for v in snap.shapes.values())
    report = {
        "workload": args.workload, "seed": args.seed,
        "device": torch.cuda.get_device_name(0),
        "unit_s": secs, "unit_s_median": {m: statistics.median(v) for m, v in secs.items()},
        "site_us": site_us, "sites_per_work": n_sites / max(work_on, 1),
        "gaps": named, "device_ops_by_span": dict(ops.most_common()),
        "counters": snap.counters,
        "span_ms": {n: 1e-6 * sum(b - a for a, b in ivs) for n, ivs in by_name.items()},
        "spans": dict(collections.Counter(s[0] for s in spans)),
    }
    runner.release()
    line = json.dumps(report)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
