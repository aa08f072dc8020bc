#!/usr/bin/env python3
"""Where an LM iteration of the port's pose graph spends its time, on one GPU.

    python3 tools/profile_stage3.py

Two circuit graphs from outputs/NCLT_poses.npz (relative_FGR_GICP, nodes
on the standard chain, identity information matrices): the whole 901-node
circuit and the circuit of its first 8 relative poses (the size of
chip_smoke.py's stage 3).  For each, the median of REPS synchronized walls
(host clock, the card drained before and after) of every piece of one
iteration of ``optimize_pose_graph_once(solver="tridiag")``: the Jacobians,
the Hessian blocks (Jacobians included), one block-Thomas solve (an
iteration runs two), the band product of the refinement, the joint cost
(residuals included), the line-process update and the pose update; then a
whole iteration (``max_iterations=1`` less the starting cost), and a 6x7
``torch.linalg.solve_ex`` and a 6x6 product alone (100 in a row, per
call), the floor of a Thomas step.  Under ``torch.profiler``, the number
of device kernels one block-Thomas solve and one Jacobian call launch.
"""

from __future__ import annotations

import statistics
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
REPS = 5


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_stage3: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from pcr_tpu_torch.models.global_refine import pose_graph as pg
    from pcr_tpu_torch.utils import se3

    dev = torch.device("cuda", 0)
    print(chip_smoke.gpu_line())

    def wall(fn) -> float:
        """Median milliseconds of fn() over REPS synchronized runs (after one)."""
        fn()
        times = []
        for _ in range(REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    def kernels(fn) -> str:
        """Device kernels fn() launches, counted by torch.profiler."""
        fn()
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        n = sum(1 for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA)
        return str(n) if n else "not measured"

    rel_all = np.load(ROOT / "outputs" / "NCLT_poses.npz")["relative_FGR_GICP"]
    for n in (8, len(rel_all)):
        rel = rel_all[:n]
        graph = pg.build_circuit_graph(se3.relative_to_absolute_standard(rel), rel,
                                       np.tile(np.eye(6, dtype=np.float32), (n, 1, 1)),
                                       device=dev)
        nodes, mu = graph.nodes, 0.04
        l = torch.ones(n, device=dev)
        src, dst, Tinv = graph.edge_src, graph.edge_dst, se3.invert(graph.edge_T)
        diag, off, b = pg._build_tridiag(graph, nodes, l)
        D, U, rhs = diag[1:], off[1 : n - 1], b[1:]
        x = pg._block_thomas_solve(D, U, rhs)
        delta = torch.cat([nodes.new_zeros((1, 6)), -x])
        start = wall(lambda: pg._total_cost(graph, nodes, l, mu).item())
        one = wall(lambda: pg.optimize_pose_graph_once(graph, mu=mu, max_iterations=1,
                                                       solver="tridiag"))
        pieces = {
            "Jacobians": wall(lambda: pg._edge_jacobians(nodes[src], nodes[dst], Tinv)),
            "Hessian blocks": wall(lambda: pg._build_tridiag(graph, nodes, l)),
            "one block-Thomas solve": wall(lambda: pg._block_thomas_solve(D, U, rhs)),
            "band product": wall(lambda: pg._band_matvec(D, U, x)),
            "joint cost": wall(lambda: pg._total_cost(graph, nodes, l, mu).item()),
            "line process": wall(lambda: pg._line_process_update(graph, nodes, mu)),
            "pose update": wall(lambda: se3.se3_exp(delta) @ nodes),
        }
        S, B = D[0].contiguous(), torch.cat([U[0], rhs[0][:, None]], dim=1)
        floor = {"solve_ex 6x7": wall(lambda: [torch.linalg.solve_ex(S, B)
                                                for _ in range(100)]) / 100,
                 "6x6 product": wall(lambda: [S @ S for _ in range(100)]) / 100}
        print(f"n={n}: one LM iteration {one - start:.2f} ms (max_iterations=1: {one:.2f} ms, "
              f"less the starting cost {start:.2f} ms); "
              + "; ".join(f"{k} {v:.2f} ms" for k, v in pieces.items()))
        print(f"n={n}: a Thomas step's floor: "
              + "; ".join(f"{k} {v * 1e3:.1f} us" for k, v in floor.items())
              + f"; kernels launched: one block-Thomas solve "
              f"{kernels(lambda: pg._block_thomas_solve(D, U, rhs))}, Jacobians "
              f"{kernels(lambda: pg._edge_jacobians(nodes[src], nodes[dst], Tinv))}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
