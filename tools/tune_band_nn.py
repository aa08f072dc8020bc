#!/usr/bin/env python3
"""Geometry of kernel K1 (``pcr_tpu_torch/csrc/band_nn.cu``), measured on one
GPU.

    python3 tools/tune_band_nn.py

band_nn.cu fixes four constants: lanes a query (split), queries a thread,
warps a block and the slab rows staged in shared memory at a time (chunk).
This script compiles the same source once for each combination in VARIANTS
(a small file that includes it and exports its launch template at that
combination, one nvcc a file, all at once), then, at the main path's shapes
on chip_smoke.py's circuit (the first pair at ground truth: the GICP call of
the coarsest and of the finest pyramid scale, band 1024 where the scale's
capacity gives it, and the gate's 32768-row clouds at band 2048), runs every
combination on the tensors ``nn1_band_query`` hands K1, holds each result to
the plain version (d2 bit-equal, every row the first minimum), and prints
the median time of 20 launches (CUDA events, behind chip_smoke's device
spin) of each combination at each shape, their sum, and what ptxas reports
(registers, spill bytes).  The first row of VARIANTS with split 1 and one
query a thread is the former one-thread-a-query design over a float4 slab.
"""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from tune_preprocess import build_variants, tag  # noqa: E402  (tools/, beside this file)

NAMES = ("split", "qpt", "warps", "chunk")
EXPORTS = {"tune_k1": "pcr_nn1_band"}
# (lanes a query, queries a thread, warps a block, slab rows staged at a time)
VARIANTS = ([(1, 1, 4, 4096)]
            + [(s, q, w, 4096) for s in (4, 8, 16, 32) for q in (1, 2, 4) for w in (4, 8)]
            + [(s, 2, 4, 2048) for s in (8, 16)] + [(8, 4, 4, 2048)])

TEMPLATE = """#include "band_nn.cu"
extern "C" int tune_k1(const int* starts, const float* q, const float* r, int nq_pad,
                       int q_tile, int band, float* out_d, int* out_row,
                       cudaStream_t stream) {{
  return launch_nn1_band<{0}, {1}, {2}, {3}>(starts, q, r, nq_pad, q_tile, band, out_d,
                                             out_row, stream);
}}
"""


def run_k1(lib, starts, q, r, band: int):
    import torch

    from pcr_tpu_torch.ops.kernels import common

    d = torch.empty(q.shape[0], dtype=torch.float32, device=q.device)
    rows = torch.empty(q.shape[0], dtype=torch.int32, device=q.device)
    err = lib.tune_k1(starts.data_ptr(), q.data_ptr(), r.data_ptr(), q.shape[0], 1024, band,
                      d.data_ptr(), rows.data_ptr(), common.stream_of(q))
    if err:
        raise RuntimeError(f"K1 launch failed with error {err}")
    return d, rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("tune_band_nn: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from pcr_tpu_torch.models import gicp, multiscale
    from pcr_tpu_torch.ops.kernels import nn_kernels as nk
    from pcr_tpu_torch.utils import cloud

    print(chip_smoke.gpu_line())
    libs = build_variants("band_nn.cu", TEMPLATE, VARIANTS, EXPORTS, NAMES)
    dev = torch.device("cuda", 0)
    scans, gt, _ = chip_smoke.make_circuit()
    clouds = [cloud.from_numpy(s, chip_smoke.CAPACITY, device=dev) for s in scans]
    scales = multiscale.create_scales(5)
    dists = multiscale.max_correspondence_distances(scales)
    caps = cloud.plan_scale_caps(clouds, scales)
    src_pyr = multiscale.build_pyramid(clouds[1], 5, caps)
    tgt_pyr = multiscale.build_pyramid(clouds[0], 5, caps)
    T = torch.as_tensor(gt[0], dtype=torch.float32, device=dev)
    shapes = []
    for s in (0, len(scales) - 1):
        band = gicp._band_width(caps[s], 1024)
        shapes.append((f"GICP {scales[s]:.1f} m", band,
                       chip_smoke.k1_inputs(src_pyr[s], tgt_pyr[s], T, dists[s], band)))
    shapes.append(("gate", 2048, chip_smoke.k1_inputs(clouds[1], clouds[0], T, 0.2, 2048)))
    times = {v: [] for v in libs}
    for label, band, (starts, q, r) in shapes:
        d_p, _ = nk.nn1_band_reference(starts, q, r, q_tile=1024, band=band)
        first = chip_smoke.first_min_rows(starts, q, r, 1024, band, d_p)
        for v, (lib, _) in libs.items():
            d_k, i_k = run_k1(lib, starts, q, r, band)
            if not (torch.equal(d_k, d_p) and torch.equal(i_k, first)):
                raise AssertionError(f"K1 {label} {tag(v, NAMES)}: differs from the plain "
                                     f"version")
            times[v].append(chip_smoke.cuda_ms(lambda: run_k1(lib, starts, q, r, band), 20))
        print(f"{label}: {q.shape[0]} q, band {band}; every combination bit-equal")
    print("combination | K1 ms at " + " / ".join(f"{s[0]} ({s[2][1].shape[0]} q, band {s[1]})"
                                                for s in shapes) + " | sum | ptxas")
    for v, rows in sorted(times.items(), key=lambda kv: sum(kv[1])):
        print(f"{tag(v, NAMES)} | " + " / ".join(f"{t:.4f}" for t in rows)
              + f" | {sum(rows):.4f} | {libs[v][1]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
