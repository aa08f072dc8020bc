"""Distributed pose-graph solve (port of pcr_tpu/parallel/distributed_pg.py):
the edges sharded over the 'pairs' axis, the normal equations summed over
the ranks.

Each rank holds its block of the edges (padded with dead edges) and the
replicated nodes, builds its share of the normal equations inside
``optimize_pose_graph_once(group=)`` and sums them with the other ranks',
and every rank takes the identical LM step, so the result equals the
single-device solve up to the summation order.
"""

from __future__ import annotations

import torch

from ..models.global_refine import pose_graph as pg
from ..utils.collectives import all_gather_rows
from .mesh import Mesh, pad_to_multiple


def pad_edges(graph: pg.PoseGraph, multiple: int) -> pg.PoseGraph:
    """Pad the edge arrays to a multiple of the mesh axis with dead edges
    (identity transform, zero information, masked off)."""
    E = graph.edge_src.shape[0]
    pad = pad_to_multiple(E, multiple) - E
    if pad == 0:
        return graph

    def padded(x, fill):
        return torch.cat([x, fill.to(x).expand((pad,) + x.shape[1:])])

    dev = graph.edge_T.device
    zero = torch.zeros((), device=dev)
    return graph._replace(
        edge_src=padded(graph.edge_src, zero), edge_dst=padded(graph.edge_dst, zero),
        edge_T=padded(graph.edge_T, torch.eye(4, device=dev)),
        edge_info=padded(graph.edge_info, torch.zeros((6, 6), device=dev)),
        uncertain=padded(graph.uncertain, zero), edge_mask=padded(graph.edge_mask, zero))


def distributed_optimize(mesh: Mesh, graph: pg.PoseGraph, mu=1.0, max_iterations: int = 100,
                         solver: str | None = None) -> pg.LMResult:
    """Edge-sharded LM pass; returns an ``LMResult`` whose nodes, cost and
    iteration count are replicated and whose line-process weights cover the
    (padded) edge set.

    For circuit graphs the block-tridiagonal path sums only the band blocks
    and the gradient ((2n 6x6 + 6n) floats, ~0.26 MB at n=901) an LM step
    instead of the dense (6n)^2 Hessian (117 MB)."""
    if solver is None:
        solver = "tridiag" if pg.is_circuit_graph(graph) else "dense"
    graph = pad_edges(graph, mesh.shape["pairs"])
    sl = mesh.block("pairs", graph.edge_src.shape[0])
    shard = graph._replace(**{k: getattr(graph, k)[sl] for k in pg.PoseGraph._fields
                              if k != "nodes"})
    res = pg.optimize_pose_graph_once(shard, mu=mu, max_iterations=max_iterations,
                                      solver=solver, group=mesh.group("pairs"))
    return res._replace(line_process=all_gather_rows(res.line_process, mesh.group("pairs")))


def distributed_global_optimization(mesh: Mesh, graph: pg.PoseGraph,
                                    max_correspondence_distance: float = 0.2,
                                    edge_prune_threshold: float = 0.25,
                                    preference_loop_closure: float = 1.0,
                                    max_iterations: int = 100) -> pg.PoseGraph:
    """Distributed ``pose_graph.global_optimization``: optimise, prune the
    uncertain edges by the final line-process weights, re-optimise
    (re-seeded with the exact chain when pruning left a pure odometry
    circuit, as the single-device path does)."""
    mu = pg.line_process_weight(graph, preference_loop_closure, max_correspondence_distance)
    E = graph.edge_src.shape[0]
    res = distributed_optimize(mesh, graph, mu=mu, max_iterations=max_iterations)
    keep = (~graph.uncertain) | (res.line_process[:E] >= edge_prune_threshold)
    pruned = graph._replace(nodes=res.nodes, edge_mask=graph.edge_mask & keep)
    if bool(torch.any(graph.edge_mask & ~keep)) and pg.is_circuit_graph(graph):
        if not bool(torch.any(pruned.uncertain & pruned.edge_mask)):
            pruned = pruned._replace(nodes=pg.chain_nodes_from_edges(pruned))
    res = distributed_optimize(mesh, pruned, mu=mu, max_iterations=max_iterations)
    return pruned._replace(nodes=res.nodes)
