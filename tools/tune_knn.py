#!/usr/bin/env python3
"""Geometry of kernel K13 (``pcr_tpu_torch/csrc/knn.cu``), measured on one GPU.

    python3 tools/tune_knn.py [--reps N]

knn.cu fixes three constants: the queries a warp (kQueries) and the ref rows
a tile where k takes a candidate buffer of at most 256 keys (kTileSmall) and
of 512 keys (kTileLarge).  This script compiles the same source once for
each combination in VARIANTS (a small file that includes it and exports the
selection at that combination, one nvcc a file, all at once; see
tools/tune_preprocess.build_variants), then runs each through
``nn_kernels.knn_select`` at the k-NN's shapes on the port's paths, holds
every result to this checkout's kernel bit for bit, and prints the median
time of the launches (CUDA events, behind chip_smoke's device spin).

Shapes: chip_smoke's Facade scans 0 and 6 in the 90112-row bucket and the
NCLT circuit's scan 0 in its 24576-row bucket at k = 200, exclude_self (the
selection features); NCLT scan 0 at k = 30, exclude_self and k = 20 (the
unfused pyramid's outlier statistics and normals at full size) and at k = 1
(viz).  A variant whose shared memory a block cannot hold at the shape's
buffer is reported as not fitting.
"""

from __future__ import annotations

import argparse
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from tune_preprocess import build_variants, tag  # noqa: E402  (tools/, beside this file)

NAMES = ("q", "t")
VARIANTS = [(2, 64), (2, 128), (2, 256), (4, 64), (4, 128), (4, 256), (8, 64), (8, 128)]
TEMPLATE = """#include "knn.cu"
extern "C" int tune_knn_select(const float* q, const long long* qperm, int nq, const float* r,
                               const long long* rperm, const int* n_valid,
                               const unsigned char* rmask, int nr, int k, int exclude_self,
                               float* rows, float* box, float* out_d, long long* out_i,
                               cudaStream_t stream) {{
  float4* rows4 = reinterpret_cast<float4*>(rows);
  const SelectArgs a{{q, qperm, nq, rows4, n_valid, rmask, nr, box, 0,
                     k, exclude_self, out_d, out_i}};
  return static_cast<int>(select_at<{0}, {1}, {1}>(a, r, rperm, rows4, box, stream));
}}
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from pcr_tpu_torch.ops.kernels import build
    from pcr_tpu_torch.ops.kernels import nn_kernels as nk
    from pcr_tpu_torch.utils import cloud

    print(cs.gpu_line(), flush=True)
    libs = build_variants("knn.cu", TEMPLATE, VARIANTS,
                          {"tune_knn_select": "pcr_knn_select",
                           "pcr_knn_morton": "pcr_knn_morton"}, names=NAMES)
    for v, (_, ptxas) in libs.items():
        print(f"{tag(v, NAMES)}: {ptxas}", flush=True)
    dev = torch.device("cuda", 0)
    facade, _ = cs.make_facade_circuit()
    nclt = cloud.from_numpy(cs.make_circuit()[0][0], cs.NCLT_BUCKET, device=dev)
    cases = [(f"Facade scan {i}, k = 200",
              cloud.from_numpy(facade[i], cs.FACADE_CAPACITY, device=dev), 200, True)
             for i in (0, cs.FACADE_SCANS - 1)]
    cases += [("NCLT scan 0, k = 200", nclt, 200, True), ("NCLT scan 0, k = 30", nclt, 30, True),
              ("NCLT scan 0, k = 20", nclt, 20, False), ("NCLT scan 0, k = 1", nclt, 1, True)]
    tuned = build.library
    for label, c, k, excl in cases:
        def run():
            return nk.knn_select(c.points, c.points, c.mask, k, exclude_self=excl)

        build.library = tuned
        d0, i0 = run()
        cells = [f"this checkout {cs.cuda_ms(run, args.reps):.3f} ms"]
        for v, (lib, _) in libs.items():
            build.library = lambda lib=lib: types.SimpleNamespace(
                pcr_knn_morton=lib.pcr_knn_morton, pcr_knn_select=lib.tune_knn_select)
            try:
                d, i = run()
            except RuntimeError:
                cells.append(f"{tag(v, NAMES)} does not fit")
                continue
            torch.cuda.synchronize()
            same = "" if torch.equal(d, d0) and torch.equal(i, i0) else " DIFFERS"
            cells.append(f"{tag(v, NAMES)} {cs.cuda_ms(run, args.reps):.3f}{same}")
        build.library = tuned
        print(f"{label} ({int(c.mask.sum())} of {c.capacity} rows valid): " + "; ".join(cells),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
