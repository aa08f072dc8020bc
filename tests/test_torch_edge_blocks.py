"""K12 (the pose graph's edge Jacobians, Gauss-Newton blocks and their
assembly): the plain versions beside the kernel,
``pcr_tpu_torch/ops/kernels/graph_kernels.py``, held against pcr_tpu's
``jacfwd`` blocks on k-connectivity graphs whose nodes repeat across edges,
and the kernel's fixed-order assembly, written in PyTorch
(``assemble_sorted_reference``), against the CPU's ``index_add_`` /
``index_put_(accumulate=True)`` (the kernels themselves run in
test_torch_kernels_cuda.py).

Tolerances, and why:
  * Jacobians and H blocks: 1e-6 of the largest entry, as
    test_torch_pose_graph.py's Jacobians (float32 round-off through a few
    dozen operations);
  * b blocks: 1e-6 of the largest entry plus the largest |L J| times 16
    roundings of the edge's largest translation: b = (L J)^T r carries the
    residual's own round-off (poses metres from the origin), which the two
    packages round differently;
  * the fixed-order assembly against the CPU's scatter-adds: bit for bit
    (the same additions in the same order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from pcr_tpu.models.global_refine import pose_graph as j_pg
from pcr_tpu.utils import se3 as j_se3
from pcr_tpu_torch.models.global_refine import pose_graph as t_pg
from pcr_tpu_torch.ops.kernels import graph_kernels as gk
from pcr_tpu_torch.utils import se3

torch.set_num_threads(1)

JAC_REL = 1e-6


def _graph(case: str):
    """A port PoseGraph on the CPU: chip_smoke.k_graph's k = 2 (every node
    the source of 2 edges and the target of 2) or k = 3 loop, the latter
    with a masked edge; or a k = 2 graph whose nodes and edges are exact
    identities (zero residual: the small-angle branches)."""
    if case == "k2":
        return chip_smoke.k_graph(9, 2, "cpu", seed=1)
    if case == "k3_masked":
        g = chip_smoke.k_graph(8, 3, "cpu", seed=2)
        mask = g.edge_mask.clone()
        mask[5] = False
        return g._replace(edge_mask=mask)
    g = chip_smoke.k_graph(6, 2, "cpu", seed=3)
    eye = torch.eye(4).expand(g.nodes.shape).contiguous()
    return g._replace(nodes=eye, edge_T=torch.eye(4).expand(g.edge_T.shape).contiguous())


def _weights(graph) -> torch.Tensor:
    return torch.linspace(0.3, 1.0, graph.edge_src.shape[0]) * graph.edge_mask.float()


def _jax_blocks(graph, w):
    """pcr_tpu's edge_blocks (a closure inside its jitted LM), rebuilt from
    its module-level pieces with the same einsums."""
    nodes, src, dst = (jnp.asarray(graph.nodes.numpy()), jnp.asarray(graph.edge_src.numpy()),
                       jnp.asarray(graph.edge_dst.numpy()))
    info, Tinv = jnp.asarray(graph.edge_info.numpy()), j_se3.invert(
        jnp.asarray(graph.edge_T.numpy()))
    z6 = jnp.zeros((src.shape[0], 6), jnp.float32)
    r = jax.vmap(j_pg._edge_residual)(nodes[src], nodes[dst], Tinv)
    Ji, Jj = j_pg._edge_jacobians(z6, z6, nodes[src], nodes[dst], Tinv)
    w = jnp.asarray(w.numpy())
    LJi = jnp.einsum("e,eij,ejk->eik", w, info, Ji)
    LJj = jnp.einsum("e,eij,ejk->eik", w, info, Jj)
    blocks = (jnp.einsum("eji,ejk->eik", Ji, LJi), jnp.einsum("eji,ejk->eik", Jj, LJj),
              jnp.einsum("eji,ejk->eik", Ji, LJj), jnp.einsum("eji,ej->ei", LJi, r),
              jnp.einsum("eji,ej->ei", LJj, r))
    return (np.asarray(Ji), np.asarray(Jj)), [np.asarray(x) for x in blocks]


def _args(graph):
    return (graph.nodes, graph.edge_src, graph.edge_dst, graph.edge_T, graph.edge_info,
            _weights(graph))


@pytest.mark.parametrize("case", ["k2", "k3_masked", "zero_residual"])
def test_plain_blocks_match_pcr_tpu_jacfwd(case):
    graph = _graph(case)
    nodes, src, dst, edge_T, info, w = _args(graph)
    (Ji_j, Jj_j), want = _jax_blocks(graph, w)
    Tinv = se3.invert(edge_T)
    got_J = gk.edge_jacobians(nodes[src], nodes[dst], Tinv)
    for g, x in zip(got_J, (Ji_j, Jj_j)):
        assert np.isfinite(g.numpy()).all()
        np.testing.assert_allclose(g.numpy(), x, atol=JAC_REL * np.abs(x).max())
    got = gk.edge_blocks(nodes, src, dst, edge_T, info, w)
    # the residual's round-off, as in chip_smoke.edge_block_errors
    t_max = max(float(nodes[:, :3, 3].abs().max()), float(edge_T[:, :3, 3].abs().max()))
    LJ = np.abs(np.einsum("e,eij,ejk->eik", w.numpy(), info.numpy(),
                          np.concatenate([Ji_j, Jj_j], -1))).max()
    rho = chip_smoke.EDGE_RESIDUAL_ROUNDINGS * 2.0 ** -23 * (1.0 + t_max)
    for name, g, x in zip(gk.BLOCKS_PER_EDGE, got, want):
        g = g.numpy()
        assert g.dtype == np.float32 and np.isfinite(g).all()
        atol = JAC_REL * np.abs(x).max() + (6 * LJ * rho if name[0] == "b" else 0.0)
        np.testing.assert_allclose(g, x, atol=atol, err_msg=name)
    if case == "k3_masked":
        assert all(float(x[5].abs().max()) == 0.0 for x in got)


GRAPHS = {
    "k2": lambda: chip_smoke.k_graph(9, 2, "cpu", seed=1),
    "k4": lambda: chip_smoke.k_graph(12, 4, "cpu", seed=4),
    "circuit": lambda: t_pg.build_circuit_graph(
        chip_smoke.k_graph(7, 1, "cpu", seed=5).nodes.numpy(),
        np.stack([np.eye(4, dtype=np.float32)] * 7), np.tile(np.eye(6, dtype=np.float32),
                                                             (7, 1, 1)), device="cpu"),
    "self_and_repeated_edges": lambda: chip_smoke.k_graph(5, 2, "cpu", seed=6)._replace(
        edge_src=torch.tensor([0, 0, 1, 1, 2, 2, 3, 3, 4, 4]),
        edge_dst=torch.tensor([1, 1, 2, 1, 3, 0, 4, 4, 0, 2])),
}


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_sorted_assembly_is_bit_equal_to_the_scatter_adds(name):
    """The kernel's order (target, kind, edge), summed one term at a time
    from 0, gives the bits of the CPU's index_add_ / index_put_ chain, for
    the circuit's bands and for the dense system; the wrappers on CPU
    tensors run the scatter-adds."""
    graph = GRAPHS[name]()
    n = graph.nodes.shape[0]
    blocks = gk.edge_blocks(*_args(graph))
    plan = gk.assembly_plan(n, graph.edge_src, graph.edge_dst, dense=True)
    for dense, reference, wrapper in ((False, gk.assemble_band_reference, gk.assemble_band),
                                      (True, gk.assemble_dense_reference, gk.assemble_dense)):
        want = reference(n, graph.edge_src, graph.edge_dst, *blocks)
        got = gk.assemble_sorted_reference(plan, *blocks, dense=dense)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), (name, dense)
        assert all(torch.equal(g, w) for g, w in zip(wrapper(plan, *blocks), want))


def test_plan_orders_by_target_kind_edge():
    """Node p's entries: the edges it is the source of, ascending, then
    those it is the target of; node pair (p, q)'s: H_ii, H_jj, H_ij, H_ij^T."""
    src, dst = torch.tensor([2, 0, 2, 1]), torch.tensor([0, 2, 1, 2])
    plan = gk.assembly_plan(3, src, dst, dense=True)
    off = plan.node_off
    node = [[(int(x) // 2, int(x) % 2) for x in plan.node_ent[off[p]:off[p + 1]]]
            for p in range(3)]
    assert node == [[(1, 0), (0, 1)], [(3, 0), (2, 1)], [(0, 0), (2, 0), (1, 1), (3, 1)]]
    pair = {(t // 3, t % 3): [(int(x) // 4, int(x) % 4)
                              for x in plan.block_ent[plan.block_off[t]:plan.block_off[t + 1]]]
            for t in range(9)}
    assert pair[(2, 2)] == [(0, 0), (2, 0), (1, 1), (3, 1)]
    assert pair[(2, 0)] == [(0, 2), (1, 3)]
    assert pair[(0, 2)] == [(1, 2), (0, 3)]
    assert pair[(0, 1)] == [] and pair[(1, 0)] == []


def test_lm_builds_the_plan_once_and_solves_as_before(monkeypatch):
    """optimize_pose_graph_once sorts the graph's terms once a pass; the
    dense and tridiagonal builders give the pieces' assembly."""
    graph = GRAPHS["circuit"]()
    calls = []
    plan_of = gk.assembly_plan
    monkeypatch.setattr(gk, "assembly_plan", lambda *a, **k: calls.append(1) or plan_of(*a, **k))
    res = t_pg.optimize_pose_graph_once(graph, mu=1.0, max_iterations=3, solver="tridiag")
    assert len(calls) == 1 and res.iterations_used >= 1
    l = _weights(graph)
    blocks = gk.edge_blocks(*_args(graph))
    n = graph.nodes.shape[0]
    want = gk.assemble_band_reference(n, graph.edge_src, graph.edge_dst, *blocks)
    got = t_pg._build_tridiag(graph, graph.nodes, l)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    H, b = t_pg._build_dense(graph, graph.nodes, l)
    H_w, b_w = gk.assemble_dense_reference(n, graph.edge_src, graph.edge_dst, *blocks)
    assert torch.equal(H, H_w) and torch.equal(b, b_w)
