"""Pose-graph global optimisation (port of
pcr_tpu/models/global_refine/pose_graph.py): non-linear least squares over
SE(3) with a line process on the loop-closure edges, Levenberg-Marquardt
damping.

The Choi-Zhou-Koltun objective that Open3D's ``global_optimization``
(the reference's "g2o" step) minimises:

    E(X, l) = sum_odometry r^T Info r
            + sum_loop     [ l * r^T Info r + mu * (sqrt(l) - 1)^2 ]

with the closed-form line-process update l = (mu / (mu + r^T Info r))^2 and
the edge residual r = log(T_edge^-1 * X_j^-1 * X_i) (edge (i, j) maps frame
i into frame j).

The line process is an ALTERNATING variable, as in Open3D's LM: it starts
at 1 on every uncertain edge and is re-estimated in closed form only after
an accepted pose update.  This order is load-bearing: a loop edge whose
initial residual is large (the NCLT circuit opens by metres) must pull the
trajectory at full weight on the first Gauss-Newton step; weighting it from
its initial residual would zero it at once and it would be pruned.

Conventions: node poses X_i map cloud i -> world; node 0 is the reference
and stays fixed; twist and block order (omega, t), as in ``utils/se3`` and
the information matrices of ``models/evaluate``.

Design on the card, float32 throughout:
  * Per-edge Jacobians and Gauss-Newton blocks in one launch of kernel K12
    (``ops/kernels/graph_kernels.edge_blocks``): the residual and its 12
    directional derivatives in forward mode through the port's
    ``se3_exp`` / ``se3_log``, the function the JAX package differentiates
    with ``jax.vmap(jax.jacfwd(...))``, so both packages linearise the
    identical function.  The plain version, the CPU path, is
    ``torch.func.jvp`` vmapped over the 12 basis directions
    (``_edge_jacobians``); forward mode passes only the selected branch's
    tangent, so the small-angle branches at zero residual (every odometry
    edge of the standard-chain start) leak no NaN from the branch not taken.
  * The blocks are summed into the normal equations in a fixed order (K12's
    second launch, ``graph_kernels.assemble_band`` / ``assemble_dense``): each
    node's terms sorted once a graph by (target, kind, edge), the order of
    the CPU's sequential ``index_add_``, so the card's assembly has the CPU
    assembly's bits, run after run (the scatter-adds it replaces used float
    atomics on the card).
  * Circuit graphs (edges (i, i+1) and the loop edge (n-1, 0)) are solved
    by 6x6 block-Thomas elimination in O(n): the forward and the backward
    sweep (the counterpart of two ``lax.scan``s) are one launch of kernel K9
    on the card, run twice an LM iteration for one step of iterative
    refinement.  Other graphs take the dense (6n)^2 solve.
  * The LM loop is a host loop with one device read an iteration (the new
    joint cost); accept / reject, the damping and the stopping tests run on
    the host in float32, as the JAX package's ``lax.while_loop`` does on
    the device.
  * ``group=`` (pcr_tpu's ``axis_name``): the graph's edges are this rank's
    shard and its nodes are replicated (``parallel/distributed_pg``).  The
    normal equations (dense H and b, or the circuit's bands and b) and the
    joint cost are summed over the group's ranks, which all get the same
    bits, so every rank reads the same cost and takes the same LM decisions.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ...ops.kernels import graph_kernels, loop_kernels
from ...utils import collectives
from ...utils import se3, trace
from ...utils.cloud import _placement


class PoseGraph(NamedTuple):
    """Fixed-shape pose graph: n nodes, E edges, all on one device."""

    nodes: torch.Tensor       # (n, 4, 4) absolute poses
    edge_src: torch.Tensor    # (E,) int64 i
    edge_dst: torch.Tensor    # (E,) int64 j
    edge_T: torch.Tensor      # (E, 4, 4) transform frame i -> frame j
    edge_info: torch.Tensor   # (E, 6, 6) information matrices
    uncertain: torch.Tensor   # (E,) bool, loop-closure edges
    edge_mask: torch.Tensor   # (E,) bool, live edges (pruning clears)


def build_circuit_graph(absolute_poses, relative_poses, info_matrices,
                        device: torch.device | str | None = None) -> PoseGraph:
    """The stage-3 circuit graph: odometry edges (i, i+1) carrying the
    INVERTED relative poses, one uncertain loop edge (n-1, 0).
    ``relative_poses[i]`` is pose_{i+1}_{i} (maps frame i+1 -> i), as in the
    pose files.  Built on ``device`` (default: the CUDA card)."""
    device = _placement(device)
    n = len(absolute_poses)
    edge_T = se3.invert(np.asarray(relative_poses))

    def f32(x):
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                               dtype=torch.float32, device=device)

    dst = torch.cat([torch.arange(1, n), torch.zeros(1, dtype=torch.int64)])
    return PoseGraph(
        nodes=f32(absolute_poses), edge_src=torch.arange(n, device=device),
        edge_dst=dst.to(device), edge_T=f32(edge_T), edge_info=f32(info_matrices),
        uncertain=torch.arange(n, device=device) == n - 1,
        edge_mask=torch.ones(n, dtype=torch.bool, device=device))


# the residual and the Jacobians' plain version live beside K12; the tests
# and tools name them here, as pcr_tpu does
_edge_residual = graph_kernels.edge_residual
_edge_jacobians = graph_kernels.edge_jacobians


def _edge_rTr(graph: PoseGraph, nodes):
    Tinv = se3.invert(graph.edge_T)
    r = _edge_residual(nodes[graph.edge_src], nodes[graph.edge_dst], Tinv)
    return r, torch.einsum("ei,eij,ej->e", r, graph.edge_info, r)


def _line_process_update(graph: PoseGraph, nodes, mu):
    """Closed-form minimiser of the line process GIVEN the poses:
    l = (mu / (mu + r^T Info r))^2 on uncertain edges, 1 elsewhere.  Called
    only after pose updates, never to seed the weights."""
    _, rTr = _edge_rTr(graph, nodes)
    return torch.where(graph.uncertain, torch.square(mu / (mu + rTr)), torch.ones_like(rTr))


def _total_cost(graph: PoseGraph, nodes, l, mu, group=None):
    """Joint objective at (nodes, l): data term + line-process prior, summed
    over ``group``'s edge shards."""
    _, rTr = _edge_rTr(graph, nodes)
    m = graph.edge_mask.to(torch.float32)
    prior = m * graph.uncertain.to(torch.float32) * mu * torch.square(torch.sqrt(l) - 1.0)
    return _psum(torch.sum(m * l * rTr) + torch.sum(prior), group)


def _psum(x, group):
    return x if group is None else collectives.all_reduce_sum(x, group)


def _band_matvec(D, U, x):
    """y = A x for the symmetric block-tridiagonal A with diagonal blocks D
    (m, 6, 6) and super-diagonal blocks U (m-1, 6, 6); sub-diagonal U^T."""
    y = torch.einsum("nij,nj->ni", D, x)
    z = x.new_zeros((1, 6))
    up = torch.einsum("nij,nj->ni", U, x[1:])
    down = torch.einsum("nji,nj->ni", U, x[:-1])
    return y + torch.cat([up, z]) + torch.cat([z, down])


def _block_thomas_solve(D, U, rhs):
    """Solve the SPD block-tridiagonal system with 6x6 blocks: D (m, 6, 6)
    diagonal blocks, U (m-1, 6, 6) super-diagonal blocks (block j to j+1;
    the sub-diagonal is U^T), rhs (m, 6).  Block-Thomas elimination, O(m)
    against the O(m^3) dense solve: one launch of kernel K9 on the card
    (``loop_kernels.block_thomas``), its plain loops on the CPU.  Kept as a
    name of its own because it is pcr_tpu's ``_block_thomas_solve``'s
    counterpart (PARITY.md), which the tests hold it to."""
    return loop_kernels.block_thomas(D, U, rhs)


class LMResult(NamedTuple):
    """Result of one LM pass, with why it stopped."""

    nodes: torch.Tensor        # (n, 4, 4) optimised absolute poses
    final_cost: float          # joint objective at the solution (float32 value)
    iterations_used: int       # LM iterations run
    line_process: torch.Tensor  # (E,) final line-process weights l


def _edge_blocks(graph: PoseGraph, nodes, l):
    """Per-edge Gauss-Newton blocks at (nodes, l): H_ii, H_jj, H_ij (E, 6, 6)
    and b_i, b_j (E, 6), each edge weighted by l * mask (K12's first launch
    on the card)."""
    return graph_kernels.edge_blocks(nodes, graph.edge_src, graph.edge_dst, graph.edge_T,
                                     graph.edge_info, l * graph.edge_mask.to(torch.float32))


def _plan(graph: PoseGraph, dense: bool) -> graph_kernels.AssemblyPlan:
    return graph_kernels.assembly_plan(graph.nodes.shape[0], graph.edge_src, graph.edge_dst,
                                       dense=dense)


def _build_dense(graph: PoseGraph, nodes, l, group=None, plan=None):
    """The (6n, 6n) Hessian and (6n,) gradient of the whole graph (summed
    over ``group``'s edge shards); ``plan``: the graph's dense
    ``assembly_plan``, built here if not given."""
    n = graph.nodes.shape[0]
    plan = _plan(graph, dense=True) if plan is None else plan
    H, b = graph_kernels.assemble_dense(plan, *_edge_blocks(graph, nodes, l))
    if group is None:
        return H, b
    Hb = _psum(torch.cat([H.reshape(-1), b]), group)
    return Hb[:36 * n * n].reshape(6 * n, 6 * n), Hb[36 * n * n:]


def _build_tridiag(graph: PoseGraph, nodes, l, group=None, plan=None):
    """(n, 6, 6) diagonal and super-diagonal Hessian bands and the (n, 6)
    gradient of a circuit graph (summed over ``group``'s edge shards); only
    consecutive couplings enter the super-diagonal (the loop edge's coupling
    to node 0 is removed exactly by the gauge fix).  ``plan``: the graph's
    ``assembly_plan``, built here if not given."""
    n = graph.nodes.shape[0]
    plan = _plan(graph, dense=False) if plan is None else plan
    diag, off, b = graph_kernels.assemble_band(plan, *_edge_blocks(graph, nodes, l))
    if group is None:
        return diag, off, b
    flat = _psum(torch.cat([diag.reshape(-1), off.reshape(-1), b.reshape(-1)]), group)
    return (flat[:36 * n].reshape(n, 6, 6), flat[36 * n:72 * n].reshape(n, 6, 6),
            flat[72 * n:].reshape(n, 6))


def _solve_dense(graph: PoseGraph, nodes, l, lam: float, group=None, plan=None):
    """LM step of nodes 1..n-1 (node 0, the reference, is gauge-fixed)."""
    n = graph.nodes.shape[0]
    H, b = _build_dense(graph, nodes, l, group, plan)
    Hr, br = H[6:, 6:], b[6:]
    Hd = Hr + torch.diag(lam * (torch.diagonal(Hr) + 1e-12))
    # one step of iterative refinement: the gauge-fixed chain Hessian has
    # condition ~n^2, so a single f32 solve carries a visible error
    x = torch.linalg.solve(Hd, br)
    x = x + torch.linalg.solve(Hd, br - Hd @ x)
    return -x.reshape(n - 1, 6)


def _solve_tridiag(graph: PoseGraph, nodes, l, lam: float, group=None, plan=None):
    """LM step of nodes 1..n-1 of a circuit graph by block-Thomas."""
    n = graph.nodes.shape[0]
    diag, off, b = _build_tridiag(graph, nodes, l, group, plan)
    D = diag[1:]                                      # nodes 1..n-1
    D = D + torch.diag_embed(lam * (torch.diagonal(D, dim1=-2, dim2=-1) + 1e-12))
    U = off[1 : n - 1]                                # node j -> j+1, j = 1..n-2
    rhs = b[1:]
    x = _block_thomas_solve(D, U, rhs)
    # iterative refinement against the band system (as the dense path)
    x = x + _block_thomas_solve(D, U, rhs - _band_matvec(D, U, x))
    return -x


def optimize_pose_graph_once(graph: PoseGraph, mu=1.0, max_iterations: int = 100,
                             rel_tol: float = 1e-9, solver: str = "dense",
                             group=None) -> LMResult:
    """One line-process LM pass.

    ``group``: the edges are this rank's shard of an edge-sharded graph
    (nodes replicated); the normal equations and the cost are summed over
    the group, so every rank returns the same nodes, cost and iteration
    count, and the line-process weights of its own edges.

    ``solver='tridiag'`` exploits the circuit structure (edges (i, i+1) and
    the single loop edge (n-1, 0), as ``build_circuit_graph`` makes them):
    after gauge-fixing node 0 the reduced Hessian is block-tridiagonal and is
    solved in O(n) by block-Thomas elimination.  Valid ONLY for such graphs
    (other couplings would be dropped); ``global_optimization`` checks the
    structure.  ``solver='dense'`` builds and solves the (6n)^2 system."""
    if solver not in ("dense", "tridiag"):
        raise ValueError(f"unknown solver {solver!r}")
    solve = _solve_dense if solver == "dense" else _solve_tridiag
    # the assembly's summation order depends on the graph alone
    plan = _plan(graph, dense=solver == "dense")
    f32 = np.float32
    # the line process starts at 1 on every edge (module docstring)
    nodes = graph.nodes
    l = torch.ones_like(graph.edge_mask, dtype=torch.float32)
    cost = _total_cost(graph, nodes, l, mu, group)
    with trace.span("sync", site="lm.cost"):
        lam, cost = f32(1e-6), f32(cost.item())
    it = 0
    while it < max_iterations:
        with trace.span("lm.iteration"):
            # pose update with the line process HELD FIXED...
            delta = torch.cat([nodes.new_zeros((1, 6)),
                               solve(graph, nodes, l, float(lam), group, plan)])
            new_nodes = se3.se3_exp(delta) @ nodes
            # ...then its closed-form re-estimate from the NEW residuals: new_l
            # minimises the joint objective given new_nodes, so comparing the
            # joint costs is a valid descent test
            new_l = _line_process_update(graph, new_nodes, mu)
            new_cost = _total_cost(graph, new_nodes, new_l, mu, group)
            with trace.span("sync", site="lm.cost"):
                new_cost = f32(new_cost.item())
        it += 1
        improved = new_cost < cost
        converged = improved and (cost - new_cost) < f32(rel_tol) * (cost + f32(1e-12))
        if improved:
            nodes, l, cost = new_nodes, new_l, new_cost
        lam = np.clip(lam * f32(0.5 if improved else 4.0), f32(1e-12), f32(1e8))
        if converged or lam >= f32(1e8):
            break
    trace.count("lm.iterations", it)
    return LMResult(nodes, float(cost), it, l)


def is_circuit_graph(graph: PoseGraph) -> bool:
    """Host-side structure check: edges exactly (i, i+1) for i < n-1 plus the
    loop edge (n-1, 0), whose gauge-fixed Hessian is block-tridiagonal."""
    src = graph.edge_src.cpu().numpy()
    dst = graph.edge_dst.cpu().numpy()
    n = int(graph.nodes.shape[0])
    if src.shape[0] != n:
        return False
    return bool(np.array_equal(src, np.arange(n))
                and np.array_equal(dst, np.concatenate([np.arange(1, n), [0]])))


def line_process_weight(graph: PoseGraph, preference_loop_closure: float,
                        max_correspondence_distance: float) -> torch.Tensor:
    """Open3D's ComputeLineProcessWeight: mu = preference * max_corr_dist^2 *
    mean(n_corr over uncertain edges), n_corr read off the information
    matrix (translation diagonal = n_corr * I)."""
    tr = torch.einsum("eii->e", graph.edge_info[:, 3:6, 3:6]) / 3.0
    unc = graph.uncertain.to(torch.float32)
    n_corr_mean = torch.sum(tr * unc) / torch.clamp(torch.sum(unc), min=1.0)
    n_corr_mean = torch.clamp(n_corr_mean, min=1.0)
    return preference_loop_closure * max_correspondence_distance ** 2 * n_corr_mean


def chain_nodes_from_edges(graph: PoseGraph) -> torch.Tensor:
    """Exact zero-residual node poses of a circuit graph whose loop edge was
    pruned: X_0 = I, X_{j+1} = X_j @ edge_T_j^-1, sequentially (the
    remaining odometry edges form a tree, so this chain IS the optimum)."""
    T = se3.invert(graph.edge_T[:-1])
    X = torch.eye(4, dtype=torch.float32, device=T.device)
    out = [X]
    for j in range(T.shape[0]):
        X = X @ T[j]
        out.append(X)
    return torch.stack(out)


@trace.spanned("pose_graph")
def global_optimization(graph: PoseGraph, max_correspondence_distance: float = 0.2,
                        edge_prune_threshold: float = 0.25,
                        preference_loop_closure: float = 1.0, max_iterations: int = 100,
                        solver: str | None = None, return_info: bool = False):
    """Open3D-style pass: optimise, prune the uncertain edges whose final
    line-process weight fell below ``edge_prune_threshold``, re-optimise.

    ``solver=None`` picks block-tridiagonal elimination for circuit graphs
    and the dense solve otherwise.  If pruning leaves a pure odometry
    chain, the second pass starts from the exact chain solution (the
    unique zero-residual optimum) instead of descending from pass 1's
    trajectory.  With ``return_info=True`` also returns a dict of
    convergence diagnostics (iterations, final costs, mu, pruned edges)."""
    if solver is None:
        solver = "tridiag" if is_circuit_graph(graph) else "dense"
    mu = line_process_weight(graph, preference_loop_closure, max_correspondence_distance)
    res1 = optimize_pose_graph_once(graph, mu=mu, max_iterations=max_iterations, solver=solver)
    keep = (~graph.uncertain) | (res1.line_process >= edge_prune_threshold)
    pruned = graph._replace(nodes=res1.nodes, edge_mask=graph.edge_mask & keep)
    n_pruned = int(torch.sum(graph.edge_mask & ~keep))
    reseeded = False
    if n_pruned and solver == "tridiag" and not bool(torch.any(pruned.uncertain
                                                               & pruned.edge_mask)):
        pruned = pruned._replace(nodes=chain_nodes_from_edges(pruned))
        reseeded = True
    res2 = optimize_pose_graph_once(pruned, mu=mu, max_iterations=max_iterations, solver=solver)
    out = pruned._replace(nodes=res2.nodes)
    if not return_info:
        return out
    unc = graph.uncertain
    info = {
        "mu": float(mu),
        "pruned_edges": n_pruned,
        "reseeded_from_chain": reseeded,
        "pass1_iterations": res1.iterations_used,
        "pass1_final_cost": res1.final_cost,
        "pass1_line_process_min": (float(torch.min(res1.line_process[unc]))
                                   if bool(torch.any(unc)) else 1.0),
        "pass2_iterations": res2.iterations_used,
        "pass2_final_cost": res2.final_cost,
    }
    return out, info
