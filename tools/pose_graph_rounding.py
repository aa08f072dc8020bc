#!/usr/bin/env python3
"""How far float32 rounding moves the n=901 NCLT pose graph's LM: the same
graph on the plain block-Thomas loops on the CPU and on the card, and
through kernel K9 on the card.

    python3 tools/pose_graph_rounding.py [--device cpu|cuda] [identity|test]

The circuit of outputs/NCLT_poses.npz (relative_FGR_GICP, nodes on the
standard chain), every edge with identity information (chip_smoke.py's
phase 12) or with tests/test_torch_pose_graph.py's (rotation diagonal 2e6,
translation 2e4); both cases by default.  ``pose_graph.global_optimization``
runs on the plain loops (``loop_kernels.block_thomas_reference``, LAPACK's
solve a step) and, with ``--device cuda`` (the default where a card is
present), again through K9.  Prints each run's iterations, final costs and
circuit consistency.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
INFO = {"identity": np.eye(6, dtype=np.float32),
        "test": np.diag([2e6, 2e6, 2e6, 2e4, 2e4, 2e4]).astype(np.float32)}


def main() -> int:
    import argparse

    import torch

    from pcr_tpu_torch.models import evaluate
    from pcr_tpu_torch.models.global_refine import pose_graph
    from pcr_tpu_torch.ops.kernels import loop_kernels as lk
    from pcr_tpu_torch.utils import se3

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cpu", "cuda"),
                    default="cuda" if torch.cuda.is_available() else "cpu")
    ap.add_argument("cases", nargs="*", help=f"of {sorted(INFO)} (default: all)")
    args = ap.parse_args()
    cases = args.cases or sorted(INFO)
    if set(cases) - set(INFO):
        ap.error(f"unknown cases {sorted(set(cases) - set(INFO))}")
    rel = np.load(ROOT / "outputs" / "NCLT_poses.npz")["relative_FGR_GICP"]
    n = len(rel)
    wrapper = lk.block_thomas
    solvers = [("plain loops", lk.block_thomas_reference)]
    if args.device == "cuda":
        solvers.append(("K9", wrapper))
        where = torch.cuda.get_device_name(0)
    else:
        where = f"{torch.get_num_threads()} CPU threads"
    for case in cases:
        graph = pose_graph.build_circuit_graph(
            se3.relative_to_absolute_standard(rel), rel, np.tile(INFO[case], (n, 1, 1)),
            device=args.device)
        for name, solve in solvers:
            lk.block_thomas = solve
            try:
                t0 = time.perf_counter()
                out, info = pose_graph.global_optimization(
                    graph, max_correspondence_distance=0.2, return_info=True)
                sec = time.perf_counter() - t0
            finally:
                lk.block_thomas = wrapper
            c = evaluate.circuit_edge_consistency(out.nodes.double().cpu().numpy(), rel,
                                                  convention="standard")
            print(f"{case} information, {name} ({sec:.1f} s on {where}): iterations "
                  f"{info['pass1_iterations']} + {info['pass2_iterations']}, final costs "
                  f"{info['pass1_final_cost']:.7g} / {info['pass2_final_cost']:.7g}, pruned "
                  f"{info['pruned_edges']}; "
                  + ", ".join(f"{k} {v:.6g}" for k, v in c.items() if isinstance(v, float)),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
