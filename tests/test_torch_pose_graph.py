"""Stage 3b: pcr_tpu_torch.models.global_refine.pose_graph held against
pcr_tpu's, piece by piece on the same float32 inputs, then whole runs.

The flagship graph is the 901-node NCLT circuit of outputs/NCLT_poses.npz
(relative_FGR_GICP, nodes from the standard chain, as stage 3 starts them)
with the information shape of tests/test_global_refine.py's n=901 cases:
rotation diagonal 2e6, translation diagonal 2e4.

Tolerances, and why:
  * residuals: 1e-4 absolute on the odometry edges, whose residuals are
    themselves float32 round-off of poses hundreds of metres from the
    origin (2^-23 * 300 m = 3.6e-5 m a rounding); 1e-5 on the loop edge's
    7 m residual;
  * Jacobians and Hessian blocks: 1e-6 and 1e-5 of the largest entry
    (float32 round-off through a few dozen operations); the gradient 1e-4
    of its largest entry, since it carries the odometry residuals' own
    round-off times the 2e6 information;
  * block-Thomas on a well-conditioned system: 1e-5 relative;
  * one to three LM iterations on the 901 circuit: a step solves a system
    of condition ~n^2 (~8e5) in float32, so round-off in its inputs may
    move it by ~kappa * 2^-24 ~ 5% in the worst direction.  Nodes within 1%
    of the largest node displacement and the joint cost within 1%;
  * whole runs at n=901: the same pruning decision and chain re-seeding,
    final costs within 1% (at the float32 noise floor, below 1e-3, once the
    loop edge is pruned), the consistency summaries within 1e-4 relative
    plus 1e-4 absolute; iteration counts are printed, not compared;
  * the small synthetic graphs: 1e-4 (well conditioned)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcr_tpu.models import evaluate as j_eval
from pcr_tpu.models.global_refine import pose_graph as j_pg
from pcr_tpu.utils import se3 as j_se3
from pcr_tpu_torch.models import evaluate as t_eval
from pcr_tpu_torch.models.global_refine import pose_graph as t_pg
from pcr_tpu_torch.utils import se3 as t_se3
from tests.test_global_refine import make_pose_graph

torch.set_num_threads(1)

INFO = np.diag([2e6, 2e6, 2e6, 2e4, 2e4, 2e4]).astype(np.float32)


def to_port(graph) -> t_pg.PoseGraph:
    """A pcr_tpu PoseGraph's leaves as a port PoseGraph on the CPU."""
    leaves = [torch.as_tensor(np.array(x)) for x in graph]
    leaves[1], leaves[2] = leaves[1].long(), leaves[2].long()
    return t_pg.PoseGraph(*leaves)


def nclt_graphs(bad_loop: bool = False):
    rel = np.load("outputs/NCLT_poses.npz")["relative_FGR_GICP"].copy()
    if bad_loop:                                  # tests/test_global_refine.py's 300 m fault
        rel[-1][:3, 3] += np.array([300.0, -300.0, 200.0])
    n = len(rel)
    std = t_se3.relative_to_absolute_standard(rel)
    infos = np.tile(INFO, (n, 1, 1))
    return (j_pg.build_circuit_graph(std, rel, infos),
            t_pg.build_circuit_graph(std, rel, infos, device="cpu"), rel)


@pytest.fixture(scope="module")
def nclt():
    return nclt_graphs()


def _jax_build_tridiag(graph, nodes, l):
    """pcr_tpu's build_tridiag (a closure inside its jitted LM), rebuilt
    from its module-level pieces with the same einsums and scatters."""
    n = nodes.shape[0]
    z6 = jnp.zeros((graph.edge_src.shape[0], 6), jnp.float32)
    r, _ = j_pg._edge_rTr(graph, nodes)
    w = l * graph.edge_mask.astype(jnp.float32)
    Ji, Jj = j_pg._edge_jacobians(z6, z6, nodes[graph.edge_src], nodes[graph.edge_dst],
                                  j_se3.invert(graph.edge_T))
    LJi = jnp.einsum("e,eij,ejk->eik", w, graph.edge_info, Ji)
    LJj = jnp.einsum("e,eij,ejk->eik", w, graph.edge_info, Jj)
    Hii = jnp.einsum("eji,ejk->eik", Ji, LJi)
    Hjj = jnp.einsum("eji,ejk->eik", Jj, LJj)
    Hij = jnp.einsum("eji,ejk->eik", Ji, LJj)
    bi = jnp.einsum("eji,ej->ei", LJi, r)
    bj = jnp.einsum("eji,ej->ei", LJj, r)
    src, dst = graph.edge_src, graph.edge_dst
    diag = jnp.zeros((n, 6, 6), jnp.float32).at[src].add(Hii).at[dst].add(Hjj)
    adj = (dst == src + 1)[:, None, None]
    off = jnp.zeros((n, 6, 6), jnp.float32).at[src].add(jnp.where(adj, Hij, 0.0))
    b = jnp.zeros((n, 6), jnp.float32).at[src].add(bi).at[dst].add(bj)
    return diag, off, b


# --- pieces -----------------------------------------------------------------

def test_residuals_match_at_zero_residual_and_at_the_loop_edge(nclt):
    gj, gt, _ = nclt
    rj = np.asarray(jax.vmap(j_pg._edge_residual)(
        gj.nodes[gj.edge_src], gj.nodes[gj.edge_dst], j_se3.invert(gj.edge_T)))
    rt = t_pg._edge_residual(gt.nodes[gt.edge_src], gt.nodes[gt.edge_dst],
                             t_se3.invert(gt.edge_T)).numpy()
    np.testing.assert_allclose(rt[:-1], rj[:-1], atol=1e-4)
    assert np.abs(rt[-1, 3:]).max() > 5.0               # the circuit opens by metres
    np.testing.assert_allclose(rt[-1], rj[-1], atol=1e-5)


@pytest.mark.parametrize("where", ["exact_zero", "nclt"])
def test_jacobians_match_and_are_finite(nclt, rng, where):
    """Exactly zero residual (identity nodes and edges: so3_log's and
    se3_log's small-angle branches, no NaN from the branch not taken) and
    the 901 circuit (odometry edges at round-off, loop edge at 7 m)."""
    if where == "exact_zero":
        Xi = Xj = np.tile(np.eye(4, dtype=np.float32), (5, 1, 1))
        Tinv = Xi
    else:
        gj, _, _ = nclt
        Xi, Xj = np.array(gj.nodes[gj.edge_src]), np.array(gj.nodes[gj.edge_dst])
        Tinv = np.array(j_se3.invert(gj.edge_T))
    z6 = jnp.zeros((Xi.shape[0], 6), jnp.float32)
    want = j_pg._edge_jacobians(z6, z6, jnp.asarray(Xi), jnp.asarray(Xj), jnp.asarray(Tinv))
    got = t_pg._edge_jacobians(torch.as_tensor(Xi), torch.as_tensor(Xj), torch.as_tensor(Tinv))
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == np.float32 and np.isfinite(g).all()
        np.testing.assert_allclose(g, w, atol=1e-6 * np.abs(w).max())
    if where == "exact_zero":     # d log(exp(-dj) exp(di)) = di - dj at the identity
        np.testing.assert_allclose(got[0].numpy(), np.tile(np.eye(6), (5, 1, 1)), atol=1e-6)
        np.testing.assert_allclose(got[1].numpy(), -np.tile(np.eye(6), (5, 1, 1)), atol=1e-6)


def test_tridiag_blocks_match(nclt):
    gj, gt, _ = nclt
    n = gt.nodes.shape[0]
    l = np.ones(n, np.float32)
    l[-1] = 0.5
    want = _jax_build_tridiag(gj, gj.nodes, jnp.asarray(l))
    got = t_pg._build_tridiag(gt, gt.nodes, torch.as_tensor(l))
    for g, w, rel in zip(got, want, (1e-5, 1e-5, 1e-4)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, atol=rel * np.abs(w).max())
    # the dense builder's band is the tridiagonal one
    H, b = t_pg._build_dense(gt, gt.nodes, torch.as_tensor(l))
    H = H.reshape(n, 6, n, 6).permute(0, 2, 1, 3)
    idx = torch.arange(n - 1)
    torch.testing.assert_close(H[idx + 1, idx + 1], got[0][1:])
    torch.testing.assert_close(H[idx[1:], idx[1:] + 1], got[1][1 : n - 1])
    torch.testing.assert_close(b.reshape(n, 6), got[2])


def test_block_thomas_matches_pcr_tpu_and_a_dense_solve(rng):
    m = 40
    A = rng.normal(size=(m, 6, 6)).astype(np.float32)
    D = (np.einsum("mij,mkj->mik", A, A) + 12 * np.eye(6)).astype(np.float32)
    U = (0.3 * rng.normal(size=(m - 1, 6, 6))).astype(np.float32)
    rhs = rng.normal(size=(m, 6)).astype(np.float32)
    got = t_pg._block_thomas_solve(torch.as_tensor(D), torch.as_tensor(U), torch.as_tensor(rhs))
    want = np.asarray(j_pg._block_thomas_solve(jnp.asarray(D), jnp.asarray(U), jnp.asarray(rhs)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    dense = np.zeros((6 * m, 6 * m))
    for j in range(m):
        dense[6 * j:6 * j + 6, 6 * j:6 * j + 6] = D[j]
        if j < m - 1:
            dense[6 * j:6 * j + 6, 6 * j + 6:6 * j + 12] = U[j]
            dense[6 * j + 6:6 * j + 12, 6 * j:6 * j + 6] = U[j].T
    exact = np.linalg.solve(dense, rhs.reshape(-1).astype(np.float64)).reshape(m, 6)
    np.testing.assert_allclose(got.numpy(), exact, atol=1e-5 * np.abs(exact).max())
    y = t_pg._band_matvec(torch.as_tensor(D), torch.as_tensor(U), torch.as_tensor(exact,
                                                                                 dtype=torch.float32))
    np.testing.assert_allclose(y.numpy(), rhs, atol=1e-4)


@pytest.mark.parametrize("iterations", [1, 2, 3])
def test_lm_iterations_match_on_the_nclt_circuit(nclt, iterations):
    gj, gt, _ = nclt
    mu = 800.0
    rj = j_pg.optimize_pose_graph_once(gj, mu=mu, max_iterations=iterations, solver="tridiag")
    rt = t_pg.optimize_pose_graph_once(gt, mu=mu, max_iterations=iterations, solver="tridiag")
    assert rt.iterations_used == int(rj.iterations_used) == iterations
    nj, nt = np.asarray(rj.nodes), rt.nodes.numpy()
    moved = np.abs(nj - np.asarray(gj.nodes))[:, :3, 3].max()
    assert moved > 1.0                                   # the closure is being distributed
    assert np.abs(nt - nj)[:, :3, 3].max() < 0.01 * moved
    assert np.abs(nt - nj)[:, :3, :3].max() < 0.01 * np.abs(
        nj - np.asarray(gj.nodes))[:, :3, :3].max()
    np.testing.assert_allclose(rt.final_cost, float(rj.final_cost), rtol=1e-2)
    np.testing.assert_allclose(rt.line_process.numpy(), np.asarray(rj.line_process), atol=1e-3)


def test_line_process_starts_at_one_and_follows_accepted_steps(nclt):
    """The loop edge opens by 7 m: weighted from its initial residual it
    would start near 0 and never pull; the LM starts it at 1, so the first
    step distributes the closure, and only then is l re-estimated, from the
    NEW residuals (so it ends near 1)."""
    _, gt, _ = nclt
    mu = 800.0
    assert float(t_pg._line_process_update(gt, gt.nodes, mu)[-1]) < 1e-3
    res = t_pg.optimize_pose_graph_once(gt, mu=mu, max_iterations=1, solver="tridiag")
    torch.testing.assert_close(res.line_process, t_pg._line_process_update(gt, res.nodes, mu))
    assert float(res.line_process[-1]) > 0.5
    assert res.final_cost < float(t_pg._total_cost(gt, gt.nodes, torch.ones(901), mu))


# --- whole runs ---------------------------------------------------------------

@pytest.fixture(scope="module")
def nclt_runs(nclt):
    """global_optimization in both packages on the 901 circuit, as is and
    with its loop edge thrown 500 m off (pruned, pass 2 re-seeded)."""
    out = {}
    for case, graphs in (("keep", nclt), ("prune", nclt_graphs(bad_loop=True))):
        gj, gt, rel = graphs
        oj, ij = j_pg.global_optimization(gj, max_correspondence_distance=0.2,
                                          edge_prune_threshold=0.25, return_info=True)
        ot, it = t_pg.global_optimization(gt, max_correspondence_distance=0.2,
                                          edge_prune_threshold=0.25, return_info=True)
        print(f"{case}: iterations pcr_tpu {ij['pass1_iterations']} + {ij['pass2_iterations']},"
              f" port {it['pass1_iterations']} + {it['pass2_iterations']}")
        out[case] = (oj, ij, ot, it, rel)
    return out


@pytest.mark.parametrize("case", ["keep", "prune"])
def test_global_optimization_at_n901_matches(nclt_runs, case):
    oj, ij, ot, it, rel = nclt_runs[case]
    for key in ("pruned_edges", "reseeded_from_chain"):
        assert it[key] == ij[key], key
    assert it["pruned_edges"] == (1 if case == "prune" else 0)
    np.testing.assert_allclose(it["mu"], ij["mu"], rtol=1e-6)
    np.testing.assert_allclose(it["pass1_final_cost"], ij["pass1_final_cost"], rtol=1e-2)
    if case == "keep":
        np.testing.assert_allclose(it["pass2_final_cost"], ij["pass2_final_cost"], rtol=1e-2)
        assert it["pass1_line_process_min"] > 0.25
    else:                          # the zero-residual chain, at the float32 noise floor
        assert it["pass2_final_cost"] < 1e-3 and ij["pass2_final_cost"] < 1e-3
    np.testing.assert_array_equal(ot.edge_mask.numpy(), np.asarray(oj.edge_mask))
    cj = j_eval.circuit_edge_consistency(np.asarray(oj.nodes), rel, convention="standard")
    ct = t_eval.circuit_edge_consistency(ot.nodes.numpy(), rel, convention="standard")
    for key, value in cj.items():
        if isinstance(value, float):
            assert abs(ct[key] - value) <= 1e-4 * abs(value) + 1e-4, (key, ct[key], value)


def test_global_optimization_small_circuit_matches(rng):
    graph, _ = make_pose_graph(rng, 8, drift=0.03)
    oj, ij = j_pg.global_optimization(graph, max_correspondence_distance=0.5, return_info=True)
    ot, it = t_pg.global_optimization(to_port(graph), max_correspondence_distance=0.5,
                                      return_info=True)
    np.testing.assert_allclose(ot.nodes.numpy(), np.asarray(oj.nodes), atol=1e-4)
    assert it["pruned_edges"] == ij["pruned_edges"] == 0
    np.testing.assert_allclose(it["pass2_final_cost"], ij["pass2_final_cost"], rtol=1e-3,
                               atol=1e-6)


# --- twins of tests/test_global_refine.py:237-287 -----------------------------

def test_pose_graph_closes_loop(rng):
    graph, _ = make_pose_graph(rng, 12, drift=0.03)
    g = to_port(graph)
    out = t_pg.global_optimization(g, max_correspondence_distance=0.5)

    def loop_gap(nodes):
        r = np.linalg.inv(g.edge_T[-1].numpy()) @ np.linalg.inv(nodes[0]) @ nodes[-1]
        return np.linalg.norm(r[:3, 3])

    before, after = g.nodes.numpy(), out.nodes.numpy()
    assert loop_gap(after) < loop_gap(before) * 0.2, (loop_gap(before), loop_gap(after))
    np.testing.assert_allclose(after[0], np.eye(4), atol=1e-5)


def test_pose_graph_tridiag_matches_dense(rng):
    graph, _ = make_pose_graph(rng, 16, drift=0.03)
    g = to_port(graph)
    assert t_pg.is_circuit_graph(g)
    res_d = t_pg.optimize_pose_graph_once(g, mu=100.0, max_iterations=30, solver="dense")
    res_t = t_pg.optimize_pose_graph_once(g, mu=100.0, max_iterations=30, solver="tridiag")
    np.testing.assert_allclose(res_t.nodes.numpy(), res_d.nodes.numpy(), atol=5e-4)
    np.testing.assert_allclose(res_t.final_cost, res_d.final_cost, rtol=1e-3)
    want = j_pg.optimize_pose_graph_once(graph, mu=100.0, max_iterations=30, solver="dense")
    np.testing.assert_allclose(res_d.nodes.numpy(), np.asarray(want.nodes), atol=5e-4)


def test_is_circuit_graph_rejects_k_connectivity(rng):
    """An extra (0 -> 2) loop edge: not a circuit, so global_optimization
    takes the dense solve, which matches pcr_tpu's on the same graph."""
    graph, _ = make_pose_graph(rng, 8, drift=0.01)
    g2 = graph._replace(
        edge_src=jnp.concatenate([graph.edge_src, jnp.asarray([0], jnp.int32)]),
        edge_dst=jnp.concatenate([graph.edge_dst, jnp.asarray([2], jnp.int32)]),
        edge_T=jnp.concatenate([graph.edge_T, graph.edge_T[:1]]),
        edge_info=jnp.concatenate([graph.edge_info, graph.edge_info[:1]]),
        uncertain=jnp.concatenate([graph.uncertain, jnp.asarray([True])]),
        edge_mask=jnp.concatenate([graph.edge_mask, jnp.asarray([True])]),
    )
    assert t_pg.is_circuit_graph(to_port(graph)) and not t_pg.is_circuit_graph(to_port(g2))
    got = t_pg.global_optimization(to_port(g2), max_correspondence_distance=0.5)
    want = j_pg.global_optimization(g2, max_correspondence_distance=0.5)
    np.testing.assert_array_equal(got.edge_mask.numpy(), np.asarray(want.edge_mask))
    np.testing.assert_allclose(got.nodes.numpy(), np.asarray(want.nodes), atol=1e-4)


def test_pose_graph_prunes_bad_loop_edge(rng):
    graph, _ = make_pose_graph(rng, 10, drift=0.01)
    g = to_port(graph)
    bad_T = g.edge_T.clone()
    bad_T[-1, :3, 3] += torch.tensor([5.0, -3.0, 2.0])
    g = g._replace(edge_T=bad_T)
    out = t_pg.global_optimization(g, max_correspondence_distance=0.1)
    assert not bool(out.edge_mask[-1])
    np.testing.assert_allclose(out.nodes.numpy(), g.nodes.numpy(), atol=0.05)


def test_build_circuit_graph_matches(nclt):
    gj, gt, _ = nclt
    for name, a, b in zip(t_pg.PoseGraph._fields, gj, gt):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    with pytest.raises(ValueError, match="solver"):
        t_pg.optimize_pose_graph_once(gt, solver="cholesky")
