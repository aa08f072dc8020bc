#!/usr/bin/env python3
"""Block geometry, bisection levels a pass and K5's consumer of kernels K4
and K5, and the block size of K6 (``pcr_tpu_torch/csrc/fpfh.cu``), measured
on one GPU.

    python3 tools/tune_features.py [k4k5|k6]       (default: both)

fpfh.cu fixes eight constants: lanes a query (team), warps a block, queries
a team takes in turn, bisection levels a pass, how many candidate rows (those
within the bisection's top bound) a team of K4 and of K5 can list in one
sweep and reduce over instead of the slab and, for K5, whether the kept
pairs are compacted over the team before their features are evaluated and
whether the neighbours' normals are staged in shared memory.  This script
compiles the same source once for each combination in VARIANTS (a small
file that includes it and exports its launch templates at that combination,
one nvcc a file, all at once), then, at chip_smoke.py's two feature shapes
(scan 0 at its bucket with band 2048, the stage-1 path's shape, and a
4096-row compaction with band 1024), runs every combination on the tensors
``fgr_features_sorted`` hands K4 and K5, holds each result to the plain
versions with chip_smoke's checks (K4's counts, K5's tau and histograms
bit-equal), and prints the median time of 20 launches (CUDA events) of each
kernel at each shape and what ptxas reports (the most registers of any
kernel in the file, spill bytes).  It also prints how many slab rows the
queries have within the top bounds, which is what the candidate lists hold.

K6 has one constant of its own, the warps of a block (each a query at a
time).  K6_VARIANTS are compiled and run the same way on the tensors
``fgr_features_sorted`` hands K6 (K5's plain tau and SPFH) at both shapes
and at band 4096, each result held to the plain version with chip_smoke's
2.4e-5 check and to the first combination's sums bit for bit.
"""

from __future__ import annotations

import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from tune_preprocess import build_variants, tag  # noqa: E402  (tools/, beside this file)

NAMES = ("team", "warps", "qpt", "levels", "k4list", "k5list", "compact", "stagenormals")
EXPORTS = {"tune_k4": "pcr_moments", "tune_k5": "pcr_spfh"}
# (team, warps, queries a team, levels a pass, K4's and K5's candidate-list
# capacity (0: every pass sweeps the slab), compacted consumer, staged normals)
LISTED = (256, 1024, True, False)
SWEPT = (0, 0, True, False)
VARIANTS = ([(32, w, q, 2, *LISTED) for w in (8, 16, 32) for q in (1, 2, 4)]
            + [(32, 4, 1, 2, *LISTED)]
            + [(32, 16, 1, m, *LISTED) for m in (1, 3, 4)]
            + [(16, w, 1, 2, *LISTED) for w in (8, 16)]
            + [(32, w, 1, 2, 128, 512, True, False) for w in (8, 16)]
            + [(32, 16, 1, 2, 512, 2048, True, False)]
            + [(32, 16, 1, 2, 256, 1024, False, False), (32, 16, 1, 2, 256, 1024, True, True)]
            + [(32, w, 1, 2, *SWEPT) for w in (8, 16)]
            + [(32, 16, 1, 3, *SWEPT), (32, 16, 2, 2, *SWEPT), (16, 16, 1, 2, *SWEPT)]
            + [(32, 16, 1, 2, 0, 0, False, False), (32, 16, 1, 2, 0, 0, True, True)])

K6_NAMES = ("warps",)
K6_EXPORTS = {"tune_k6": "pcr_fpfh"}
K6_VARIANTS = [(32,), (16,), (8,)]        # warps a block

K6_TEMPLATE = """#include "fpfh.cu"
extern "C" int tune_k6(const int* starts, const float* q, const float* r, const float* tau,
                       const float* spfh, int n_pad, int q_tile, int band, float* out,
                       cudaStream_t stream) {{
  return launch_fpfh<{0}>(starts, q, r, tau, spfh, n_pad, q_tile, band, out, stream);
}}
"""

TEMPLATE = """#include "fpfh.cu"
extern "C" int tune_k4(const int* starts, const float* q, const float* r,
                       const float* center, int n_pad, int q_tile, int band, int normal_k,
                       float log_lo, float log_hi, float* out, cudaStream_t stream) {{
  return launch_moments<{0}, {1}, {2}, {3}, {4}>(starts, q, r, center, n_pad, q_tile, band,
                                                 normal_k, log_lo, log_hi, out, stream);
}}
extern "C" int tune_k5(const int* starts, const float* q, const float* nq, const float* r,
                       const float* nr, int n_pad, int q_tile, int band, int k, float log_lo,
                       float log_hi, float radius2, float lo3, float scale12, float scale3,
                       float* spfh_out, float* tau_out, cudaStream_t stream) {{
  return launch_spfh<{0}, {1}, {2}, {3}, {5}, {6}, {7}>(starts, q, nq, r, nr, n_pad, q_tile,
                                                        band, k, log_lo, log_hi, radius2, lo3,
                                                        scale12, scale3, spfh_out, tau_out,
                                                        stream);
}}
"""


def run_k4(lib, inp, q_tile: int):
    import torch

    from pcr_tpu_torch.ops.kernels import common
    from pcr_tpu_torch.ops.kernels import feature_kernels as fk

    starts, q, r, center, voxel = inp.k4_args
    out = torch.empty((q.shape[0], 10), dtype=torch.float32, device=q.device)
    lo, hi = fk._log_bounds(voxel, 0.05, 2.0)
    err = lib.tune_k4(starts.data_ptr(), q.data_ptr(), r.data_ptr(), center.data_ptr(),
                      q.shape[0], q_tile, inp.band, 20, lo, hi, out.data_ptr(),
                      common.stream_of(q))
    if err:
        raise RuntimeError(f"K4 launch failed with error {err}")
    return out


def run_k5(lib, inp, q_tile: int):
    import torch

    from pcr_tpu_torch.ops.kernels import common
    from pcr_tpu_torch.ops.kernels import feature_kernels as fk

    starts, q, nq, r, nr, voxel = inp.k5_args
    n_pad = q.shape[0]
    hist = torch.empty((n_pad, fk.FEATURE_DIM), dtype=torch.float32, device=q.device)
    tau = torch.empty(n_pad, dtype=torch.float32, device=q.device)
    lo, hi = fk._log_bounds(voxel, 0.05, 10.0)
    err = lib.tune_k5(starts.data_ptr(), q.data_ptr(), nq.data_ptr(), r.data_ptr(),
                      nr.data_ptr(), n_pad, q_tile, inp.band, 201, lo, hi, fk._radius2(voxel),
                      *fk._bin_constants(), hist.data_ptr(), tau.data_ptr(),
                      common.stream_of(q))
    if err:
        raise RuntimeError(f"K5 launch failed with error {err}")
    return hist, tau


def run_k6(lib, inp, q_tile: int):
    import torch

    from pcr_tpu_torch.ops.kernels import common
    from pcr_tpu_torch.ops.kernels import feature_kernels as fk

    starts, q, r, tau, spfh = inp.k6_args
    out = torch.empty((q.shape[0], fk.FEATURE_DIM), dtype=torch.float32, device=q.device)
    err = lib.tune_k6(starts.data_ptr(), q.data_ptr(), r.data_ptr(), tau.data_ptr(),
                      spfh.data_ptr(), q.shape[0], q_tile, inp.band, out.data_ptr(),
                      common.stream_of(q))
    if err:
        raise RuntimeError(f"K6 launch failed with error {err}")
    return out


def tune_k6(c, shapes) -> None:
    """K6_VARIANTS at each shape: checked, timed, printed."""
    import torch

    import chip_smoke

    libs = build_variants("fpfh.cu", K6_TEMPLATE, K6_VARIANTS, K6_EXPORTS, K6_NAMES)
    qt = chip_smoke.FEATURE_Q_TILE
    times = {v: [] for v in libs}
    for label, bucket, band in shapes:
        inp = chip_smoke.feature_inputs(c, 0.1, bucket, band)
        first = None
        for v, (lib, _) in libs.items():
            name = f"{label} {tag(v, K6_NAMES)}"
            out = run_k6(lib, inp, qt)
            chip_smoke.check_k6_result(name, out, inp.k6_plain)
            first = out if first is None else first
            if not torch.equal(out, first):
                raise AssertionError(f"K6 {name}: sums differ from "
                                     f"{tag(K6_VARIANTS[0], K6_NAMES)}")
            times[v].append(chip_smoke.cuda_ms(lambda: run_k6(lib, inp, qt), 20))
        kept = chip_smoke.slab_work(inp.k6_args[0], inp.k6_args[1], inp.k6_args[2], qt, band,
                                    1.0, tau=inp.k6_args[3], exclude_self=True)
        kept -= 9.0 * inp.k6_args[1].shape[0] * 2 * band
        print(f"{label}: {inp.k6_args[1].shape[0]} rows, band {band}, {kept:.0f} kept pairs; "
              f"every combination within 2.4e-5 of the plain version and bit-equal to the "
              f"others")
    print("combination | K6 ms at " + " / ".join(s[0] for s in shapes) + " | ptxas")
    for v, rows in sorted(times.items(), key=lambda kv: kv[1][0]):
        print(f"{tag(v, K6_NAMES)} | " + " / ".join(f"{t:.4f}" for t in rows)
              + f" | {libs[v][1]}")


def listed_rows(inp, q_tile: int) -> str:
    """How many slab rows a query has within K4's and K5's top bounds (what a
    team lists), and how many queries have more than fpfh.cu's lists hold."""
    import torch

    from pcr_tpu_torch.ops.kernels import build, common
    from pcr_tpu_torch.ops.kernels import feature_kernels as fk

    source = (build.CSRC / "fpfh.cu").read_text()
    starts, q, r, _, voxel = inp.k4_args
    n_tiles = starts.shape[0]
    q_t = q.view(n_tiles, q_tile, 3)
    out = []
    for name, top, const in (("K4", 2.0, "kMomentsList"), ("K5", 10.0, "kSpfhList")):
        cap = int(re.search(rf"constexpr int {const} = (\d+);", source).group(1))
        t = torch.exp(torch.tensor(fk._log_bounds(voxel, 0.05, top)[1], device=q.device))
        counts = torch.cat([
            (common.sqdist_tiles(q_t[g], common.slabs(starts[g], r, inp.band)) <= t).sum(-1)
            for g in common.tile_groups(n_tiles, q_tile * 2 * inp.band)]).reshape(-1)
        cloud_rows = counts[:inp.valid].float()
        out.append(f"{name} rows within the top bound, over the cloud's {inp.valid} queries: "
                   f"median {int(cloud_rows.median())}, 99% "
                   f"{int(torch.quantile(cloud_rows, 0.99))}, max {int(cloud_rows.max())}; "
                   f"queries with more than the list's {cap}: "
                   f"{int((counts[:inp.valid] > cap).sum())} of the cloud, "
                   f"{int((counts[inp.valid:] > cap).sum())} of the "
                   f"{counts.shape[0] - inp.valid} past it")
    return "; ".join(out)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("tune_features: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from pcr_tpu_torch.utils import cloud

    which = sys.argv[1] if len(sys.argv) > 1 else "both"
    if which not in ("k4k5", "k6", "both"):
        print(__doc__, file=sys.stderr)
        return 2
    print(chip_smoke.gpu_line())
    dev = torch.device("cuda", 0)
    scans, _, _ = chip_smoke.make_circuit()
    c = cloud.from_numpy(scans[0], chip_smoke.CAPACITY, device=dev)
    qt = chip_smoke.FEATURE_Q_TILE
    shapes = [("scan 0", cloud.bucket_capacity(c, 4096), chip_smoke.FEATURE_BAND),
              ("4096 rows", 4096, 1024)]
    if which != "k4k5":
        tune_k6(c, shapes + [("scan 0, band 4096", cloud.bucket_capacity(c, 4096), 4096)])
    if which == "k6":
        return 0
    libs = build_variants("fpfh.cu", TEMPLATE, VARIANTS, EXPORTS, NAMES)
    times = {v: [] for v in libs}
    for label, bucket, band in shapes:
        inp = chip_smoke.feature_inputs(c, 0.1, bucket, band)
        for v, (lib, _) in libs.items():
            name = f"{label} {tag(v, NAMES)}"
            chip_smoke.check_k4_result(name, run_k4(lib, inp, qt), inp.k4_plain)
            chip_smoke.check_k5_result(name, run_k5(lib, inp, qt), inp.k5_plain)
            times[v].append((chip_smoke.cuda_ms(lambda: run_k4(lib, inp, qt), 20),
                             chip_smoke.cuda_ms(lambda: run_k5(lib, inp, qt), 20)))
        print(f"{label}: {inp.k4_args[1].shape[0]} rows, band {band}; every combination "
              f"bit-equal")
        print(f"{label}: {listed_rows(inp, qt)}")
    print("combination | K4 ms at " + " / ".join(s[0] for s in shapes) + " | K5 ms | ptxas")
    for v, rows in sorted(times.items(), key=lambda kv: sum(kv[1][0])):
        print(f"{tag(v, NAMES)} | " + " / ".join(f"{a:.4f}" for a, _ in rows) + " | "
              + " / ".join(f"{b:.4f}" for _, b in rows) + f" | {libs[v][1]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
