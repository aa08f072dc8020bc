#!/usr/bin/env python3
"""Device busy share of the port's warm stage-1 or stage-2 circuit on one GPU.

    python3 tools/profile_circuit.py [1|2]     (default: 2)

Runs the synthetic 8-scan circuit of chip_smoke.py through
``pipeline.run_stage1_fgr`` (1) or ``pipeline.run_stage2_mgicp`` (2, from
the real NCLT FGR errors) once cold, REPS times warm without the profiler
(wall: host clock around a synchronized run), then once warm under
``torch.profiler``.  Prints the unprofiled walls, the profiled wall, the
device time (union of the intervals of every GPU kernel, memcpy and memset
the profiler recorded), the busy share under the profiler (device time /
profiled wall), the device time of the 12 largest kernels and that of each
of the port's hand-written kernels.

The profiled run's device time divided by the median unprofiled wall is
printed too, labelled as an estimate: it mixes two runs, and the profiler
changes neither the kernels' work nor their number.
"""

from __future__ import annotations

import collections
import re
import statistics
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
REPS = 5
# csrc/*.cu keep their kernels in anonymous namespaces (a template's name
# starts with its return type); so do a few of PyTorch's, under at::
OWN_KERNEL = re.compile(r"(void )?\(anonymous namespace\)::")


def _union_us(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_circuit: no CUDA device", file=sys.stderr)
        return 1
    stage = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    import chip_smoke
    from pcr_tpu_torch import pipeline
    from pcr_tpu_torch.utils import cloud

    dev = torch.device("cuda", 0)
    print(chip_smoke.gpu_line(), f"| stage {stage}")
    scans, _, init = chip_smoke.make_circuit()
    clouds = [cloud.from_numpy(s, chip_smoke.CAPACITY, device=dev) for s in scans]

    with tempfile.TemporaryDirectory() as tmp:
        def run(tag: str) -> float:
            out = str(Path(tmp) / tag)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if stage == 1:
                pipeline.run_stage1_fgr(chip_smoke.stage1_config(out), clouds=clouds,
                                        n=chip_smoke.N_SCANS)
            else:
                pipeline.run_stage2_mgicp(chip_smoke.stage2_config(out), init_poses=init.copy(),
                                          clouds=clouds, n=chip_smoke.N_SCANS)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        print(f"cold run: {run('cold'):.4f} s")
        walls = [run(f"warm{i}") for i in range(REPS)]
        print("unprofiled warm walls (s):", " ".join(f"{w:.4f}" for w in walls))
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            wall_p = run("profiled")

    intervals, per_name = [], collections.Counter()
    counts = collections.Counter()
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        a, b = e.time_range.start, e.time_range.end
        intervals.append((a, b))
        per_name[e.name] += b - a
        counts[e.name] += 1
    if not intervals:
        raise AssertionError("the profiler recorded no device activity")
    busy_s = _union_us(intervals) * 1e-6
    median = statistics.median(walls)
    print(f"profiled warm wall: {wall_p:.4f} s; device time {busy_s:.4f} s in "
          f"{len(intervals)} device events")
    print(f"busy share under the profiler: {busy_s / wall_p:.4f}")
    print(f"estimate, profiled device time / median unprofiled wall "
          f"({median:.4f} s): {busy_s / median:.4f}")
    for name, us in per_name.most_common(12):
        print(f"  {us * 1e-3:10.3f} ms  {counts[name]:6d}x  {name[:100]}")
    print("the port's own kernels:")
    for name, us in per_name.most_common():
        if OWN_KERNEL.match(name) and "at::" not in name:
            print(f"  {us * 1e-3:10.3f} ms  {counts[name]:6d}x  {name[:100]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
