#!/usr/bin/env python3
"""Does the dense pose graph give the same bits when run twice on the card?

    python3 tools/pose_graph_repeat.py [REPEATS]

The pose graph sums every edge's Gauss-Newton blocks into the node blocks
of its Hessian and gradient.  Summed by scatter-adds on the card
(``index_add_`` / ``index_put_(accumulate=True)``, which use float atomics),
a node that several edges touch may see its terms added in a different
order from one run to the next (ROADMAP F8).  On one GPU this script

  1. builds chip_smoke.py's Facade-scale k = 2 graph
     (``graph_builder.full_registration_batched`` with phase 22's call) and
     runs ``global_optimization`` on it REPEATS times (default 5): the
     nodes and the edge mask of every run against the first, bit for bit;
     one LM pass (``optimize_pose_graph_once``, dense) REPEATS times: the
     nodes and the line process against the first;
  2. assembles that graph's dense Hessian and gradient
     (``pose_graph._build_dense``) 200 times at its first nodes, and the
     same for chip_smoke.k_graph's seeded k = 4 graph of 64 nodes (every
     node the source of 4 edges and the target of 4): each against the
     first, bit for bit, and against the same graph's blocks and assembly
     on the CPU;
  3. prints the largest difference of each and whether any run differed.

It reads only the package's public graph functions and ``_build_dense``,
so it runs on a checkout before or after the assembly changed.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
ASSEMBLY_REPEATS = 200


def _chip_smoke():
    if "chip_smoke" not in sys.modules:
        spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
        sys.modules["chip_smoke"] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(sys.modules["chip_smoke"])
    return sys.modules["chip_smoke"]


def biggest(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def repeat_assembly(label: str, graph) -> bool:
    import torch

    from pcr_tpu_torch.models.global_refine import pose_graph

    l = torch.linspace(0.3, 1.0, graph.edge_src.shape[0], device=graph.nodes.device)
    H0, b0 = pose_graph._build_dense(graph, graph.nodes, l)
    worst, differing = 0.0, 0
    for _ in range(ASSEMBLY_REPEATS - 1):
        H, b = pose_graph._build_dense(graph, graph.nodes, l)
        same = torch.equal(H, H0) and torch.equal(b, b0)
        differing += not same
        worst = max(worst, biggest(H, H0), biggest(b, b0))
    cpu = pose_graph.PoseGraph(*(x.cpu() for x in graph))
    Hc, bc = pose_graph._build_dense(cpu, cpu.nodes, l.cpu())
    print(f"{label}: dense assembly x {ASSEMBLY_REPEATS}: {differing} runs differ from the "
          f"first, largest difference {worst:.3e} (|H| max {float(H0.abs().max()):.3e}); "
          f"the same graph's blocks and assembly on the CPU (blocks rounded otherwise) "
          f"within {biggest(H0.cpu(), Hc):.3e} (H), {biggest(b0.cpu(), bc):.3e} (b)")
    return differing == 0


def repeat_optimization(label: str, graph, repeats: int) -> bool:
    import torch

    from pcr_tpu_torch.models.global_refine import pose_graph

    outs = [pose_graph.global_optimization(graph, max_correspondence_distance=0.2,
                                           edge_prune_threshold=0.25) for _ in range(repeats)]
    d_nodes = max(biggest(o.nodes, outs[0].nodes) for o in outs)
    masks = all(torch.equal(o.edge_mask, outs[0].edge_mask) for o in outs)
    mu = pose_graph.line_process_weight(graph, 1.0, 0.2)
    once = [pose_graph.optimize_pose_graph_once(graph, mu=mu, solver="dense")
            for _ in range(repeats)]
    d_once = max(biggest(o.nodes, once[0].nodes) for o in once)
    d_l = max(biggest(o.line_process, once[0].line_process) for o in once)
    its = sorted({o.iterations_used for o in once})
    ok = d_nodes == 0 and masks and d_once == 0 and d_l == 0
    print(f"{label}: global_optimization x {repeats}: nodes within {d_nodes:.3e} of the "
          f"first run, edge masks {'equal' if masks else 'DIFFER'}; one dense LM pass x "
          f"{repeats} (iterations {its}): nodes within {d_once:.3e}, line process within "
          f"{d_l:.3e}; {'bit for bit' if ok else 'NOT bit for bit'}")
    return ok


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("pose_graph_repeat: needs a CUDA device", file=sys.stderr)
        return 1
    repeats = int(sys.argv[1]) if len(sys.argv) > 1 else 5
    cs = _chip_smoke()
    print(cs.gpu_line())
    import pcr_tpu_torch  # noqa: F401  (sets the f32 matmul policy)
    from pcr_tpu_torch.models import graph_builder
    from pcr_tpu_torch.utils import cloud

    dev = torch.device("cuda", 0)
    scans, _ = cs.make_facade_circuit()
    clouds = [cloud.from_numpy(sc, cs.FACADE_CAPACITY, device=dev) for sc in scans]
    facade = graph_builder.full_registration_batched(clouds, batch_size=cs.FACADE_BATCH,
                                                     **cs.FACADE_CALL)
    print(f"Facade k=2 graph: {facade.nodes.shape[0]} nodes, {facade.edge_src.shape[0]} "
          f"edges, sources {facade.edge_src.tolist()}, targets {facade.edge_dst.tolist()}")
    k4 = cs.k_graph(64, 4, dev)
    ok = [repeat_optimization("Facade k=2", facade, repeats),
          repeat_assembly("Facade k=2", facade),
          repeat_optimization("k=4, n=64", k4, repeats),
          repeat_assembly("k=4, n=64", k4)]
    print(f"pose graph repeat: {'every run bit for bit' if all(ok) else 'runs differ'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
