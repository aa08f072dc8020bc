"""K12 — the pose graph's edge Jacobians and Gauss-Newton blocks, and their
assembly into the normal equations (CUDA source:
``pcr_tpu_torch/csrc/pose_graph.cu``).

Neither launch replaces a Pallas kernel: they are the port's counterpart of
``pcr_tpu/models/global_refine/pose_graph.py``'s ``_edge_jacobians`` (line
100, ``jax.vmap(jax.jacfwd(...))``) and of the assembly of its blocks (lines
243-266), which XLA compiles into the LM's ``lax.while_loop``.

``edge_blocks`` (launch 1, one thread an edge) evaluates every edge's
residual r = log(T_edge^-1 X_j^-1 X_i) and its 12 directional derivatives
at delta = 0 in forward mode, with the primal's branches, then H_ii, H_jj,
H_ij and b_i, b_j weighted by l * mask * Info.  ``assemble_band`` and
``assemble_dense`` (launch 2) sum them into the circuit's bands or the
dense system in a fixed order: each target's terms sorted once a graph
(``assembly_plan``) by (target, kind, edge) and added to 0 one at a time,
which is the order of the CPU's sequential ``index_add_`` /
``index_put_(accumulate=True)`` (and of pcr_tpu's ``.at[].add`` chain).  So
the card's assembly is bit-equal to the CPU's plain assembly of the same
blocks, run after run; the scatter-adds it replaces add with float atomics
on the card (ROADMAP F8).

The plain versions are the code the port ran before the kernels, moved
here unchanged: the Jacobians by ``torch.func.jvp`` and the blocks by
batched products (``edge_blocks_reference``), the assembly by
``index_add_`` / ``index_put_`` (``assemble_band_reference``,
``assemble_dense_reference``).  They are the CPU path and the oracle.
``assemble_sorted_reference`` is the kernel's fixed-order sum written in
PyTorch, for the tests.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jvp, vmap

from ...utils import se3, trace
from . import build, common

LAUNCHES = {"edge_blocks": 0, "edge_assembly": 0}
BLOCKS_PER_EDGE = ("Hii", "Hjj", "Hij", "bi", "bj")


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def edge_residual(X_i, X_j, T_edge_inv):
    """r = log(T_edge^-1 X_j^-1 X_i), (..., 6) in (omega, t) order."""
    return se3.se3_log(T_edge_inv @ se3.invert(X_j) @ X_i)


def _edge_residual_perturbed(delta_i, delta_j, X_i, X_j, T_edge_inv):
    return edge_residual(se3.se3_exp(delta_i) @ X_i, se3.se3_exp(delta_j) @ X_j, T_edge_inv)


def edge_jacobians(X_i, X_j, T_edge_inv):
    """(E, 6, 6) d r / d delta_i and d r / d delta_j of every edge at
    delta = 0, by forward-mode AD: one ``jvp`` of the batched residual for
    each of the 12 basis directions, vmapped over the directions (what
    ``jacfwd`` does, with the edges kept as a batch dimension inside; a
    per-edge vmap would make each edge's angle a 0-dim tensor, whose
    tangent torch promotes to float64 when it is scaled by a Python
    number).  Forward mode through ``torch.where`` passes only the
    selected branch's tangent, so the small-angle branches at zero residual
    leak no NaN from the branch not taken."""
    E = X_i.shape[0]
    zeros = X_i.new_zeros((E, 6))
    basis = torch.eye(12, dtype=X_i.dtype, device=X_i.device)[:, None, :].expand(12, E, 12)

    def column(t):
        return jvp(lambda di, dj: _edge_residual_perturbed(di, dj, X_i, X_j, T_edge_inv),
                   (zeros, zeros), (t[:, :6], t[:, 6:]))[1]

    J = vmap(column)(basis).permute(1, 2, 0)              # (E, 6 residual, 12)
    return J[..., :6], J[..., 6:]


def edge_blocks_reference(nodes, src, dst, edge_T, info, w):
    """Plain version of launch 1: per-edge Gauss-Newton blocks at ``nodes``
    (n, 4, 4) of the edges (src, dst) with transforms ``edge_T`` (E, 4, 4),
    information ``info`` (E, 6, 6) and weights ``w`` (E,) = l * mask:
    (H_ii, H_jj, H_ij (E, 6, 6), b_i, b_j (E, 6))."""
    Tinv = se3.invert(edge_T)
    X_i, X_j = nodes[src], nodes[dst]
    r = edge_residual(X_i, X_j, Tinv)
    Ji, Jj = edge_jacobians(X_i, X_j, Tinv)
    w = w[:, None, None]
    LJi = (w * info) @ Ji
    LJj = (w * info) @ Jj
    Hii = Ji.transpose(1, 2) @ LJi
    Hjj = Jj.transpose(1, 2) @ LJj
    Hij = Ji.transpose(1, 2) @ LJj
    bi = torch.einsum("eji,ej->ei", LJi, r)
    bj = torch.einsum("eji,ej->ei", LJj, r)
    return Hii, Hjj, Hij, bi, bj


def gradient_reference(n: int, src, dst, bi, bj):
    """(n, 6) gradient: b_i into each edge's source, then b_j into its target."""
    return bi.new_zeros((n, 6)).index_add_(0, src, bi).index_add_(0, dst, bj)


def assemble_band_reference(n: int, src, dst, Hii, Hjj, Hij, bi, bj):
    """Plain version of the circuit's assembly: (n, 6, 6) diagonal and
    super-diagonal Hessian bands and the (n, 6) gradient."""
    diag = Hii.new_zeros((n, 6, 6)).index_add_(0, src, Hii).index_add_(0, dst, Hjj)
    # only consecutive couplings enter the band; the loop edge's coupling to
    # node 0 is removed exactly by the gauge fix
    adj = (dst == src + 1)[:, None, None]
    off = Hii.new_zeros((n, 6, 6)).index_add_(0, src, torch.where(adj, Hij, torch.zeros_like(Hij)))
    return diag, off, gradient_reference(n, src, dst, bi, bj)


def assemble_dense_reference(n: int, src, dst, Hii, Hjj, Hij, bi, bj):
    """Plain version of the dense assembly: the (6n, 6n) Hessian and (6n,)
    gradient."""
    H = Hii.new_zeros((n, n, 6, 6))
    H.index_put_((src, src), Hii, accumulate=True)
    H.index_put_((dst, dst), Hjj, accumulate=True)
    H.index_put_((src, dst), Hij, accumulate=True)
    H.index_put_((dst, src), Hij.transpose(1, 2), accumulate=True)
    return (H.permute(0, 2, 1, 3).reshape(6 * n, 6 * n),
            gradient_reference(n, src, dst, bi, bj).reshape(6 * n))


# ---------------------------------------------------------------------------
# The fixed summation order, once a graph
# ---------------------------------------------------------------------------

class AssemblyPlan(NamedTuple):
    """Each target's contributions sorted by (target, kind, edge), as CSR
    lists on the graph's device: node p's entries node_ent[node_off[p]:
    node_off[p+1]] = 2 e + kind (0: p is edge e's source, 1: its target);
    node pair t = p n + q's entries block_ent[block_off[t]:block_off[t+1]]
    = 4 e + kind (H_ii, H_jj, H_ij, H_ij^T), or None without ``dense``."""

    n: int
    src: torch.Tensor          # (E,) int32
    dst: torch.Tensor          # (E,) int32
    node_off: torch.Tensor     # (n + 1,) int32
    node_ent: torch.Tensor     # (2E,) int32
    block_off: torch.Tensor | None   # (n * n + 1,) int32
    block_ent: torch.Tensor | None   # (4E,) int32


def _csr(targets: torch.Tensor, n_targets: int, n_kinds: int):
    """Entries kind-major over the edges, sorted by (target, kind, edge)."""
    n_edges = targets.shape[0] // n_kinds
    code = torch.arange(targets.shape[0], device=targets.device)   # kind * E + e
    kind, edge = code // max(n_edges, 1), code % max(n_edges, 1)
    order = torch.argsort(targets * targets.shape[0] + code)
    ent = (edge * n_kinds + kind)[order].to(torch.int32)
    counts = torch.bincount(targets, minlength=n_targets)
    off = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)]).to(torch.int32)
    return off, ent


def assembly_plan(n: int, src: torch.Tensor, dst: torch.Tensor,
                  dense: bool = False) -> AssemblyPlan:
    """The summation order of a graph of n nodes and edges (src, dst): it
    depends on the graph alone, so the LM builds it once, not once an
    iteration."""
    src, dst = src.long(), dst.long()
    node_off, node_ent = _csr(torch.cat([src, dst]), n, 2)
    block_off = block_ent = None
    if dense:
        block_off, block_ent = _csr(torch.cat([src * n + src, dst * n + dst, src * n + dst,
                                               dst * n + src]), n * n, 4)
    return AssemblyPlan(n, src.to(torch.int32).contiguous(), dst.to(torch.int32).contiguous(),
                        node_off, node_ent, block_off, block_ent)


def _sorted_sum(off, ent, n_kinds: int, terms) -> torch.Tensor:
    """Each target's terms added to 0 one at a time in the plan's order:
    ``terms(edge, kind)`` gives the (k, ...) contributions of the k entries.
    A slot past a target's last entry adds +0, which leaves its sum's bits
    unchanged (a sum started at +0 is never -0)."""
    counts = (off[1:] - off[:-1]).long()
    width = int(counts.max()) if counts.numel() else 0
    slot = torch.arange(width, device=off.device)
    live = slot[None, :] < counts[:, None]
    pos = torch.where(live, off[:-1, None].long() + slot[None, :], 0)
    ent = ent.long()[pos]
    vals = terms(ent // n_kinds, ent % n_kinds)            # (targets, width, ...)
    live = live.reshape(live.shape + (1,) * (vals.dim() - 2))
    acc = torch.zeros(vals.shape[:1] + vals.shape[2:], dtype=vals.dtype, device=vals.device)
    for s in range(width):
        acc = acc + torch.where(live[:, s], vals[:, s], 0.0)
    return acc


def assemble_sorted_reference(plan: AssemblyPlan, Hii, Hjj, Hij, bi, bj, dense: bool = False):
    """The kernel's fixed-order assembly in PyTorch: (diag, off, b) of the
    circuit's bands or, with ``dense``, the (6n, 6n) H and (6n,) b."""
    n = plan.n
    src, dst = plan.src.long(), plan.dst.long()
    b = _sorted_sum(plan.node_off, plan.node_ent, 2,
                    lambda e, k: torch.where(k[..., None] == 1, bj[e], bi[e]))
    if dense:
        H = _sorted_sum(plan.block_off, plan.block_ent, 4, lambda e, k: torch.where(
            (k == 0)[..., None, None], Hii[e], torch.where(
                (k == 1)[..., None, None], Hjj[e], torch.where(
                    (k == 2)[..., None, None], Hij[e], Hij[e].transpose(-1, -2)))))
        return H.reshape(n, n, 6, 6).permute(0, 2, 1, 3).reshape(6 * n, 6 * n), b.reshape(6 * n)
    diag = _sorted_sum(plan.node_off, plan.node_ent, 2,
                       lambda e, k: torch.where((k == 1)[..., None, None], Hjj[e], Hii[e]))
    adj = dst == src + 1
    off = _sorted_sum(plan.node_off, plan.node_ent, 2, lambda e, k: torch.where(
        ((k == 0) & adj[e])[..., None, None], Hij[e], 0.0))
    return diag, off, b


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def edge_blocks(nodes, src, dst, edge_T, info, w):
    """Per-edge Gauss-Newton blocks (H_ii, H_jj, H_ij (E, 6, 6), b_i, b_j
    (E, 6)) of ``edge_blocks_reference``.  f32 nodes (n, 4, 4), edge_T
    (E, 4, 4), info (E, 6, 6), w (E,); integer src, dst (E,).  CPU tensors
    run the plain version; CUDA tensors launch the kernel."""
    n_edges = src.shape[0]
    if not common.on_cuda(nodes, src, dst, edge_T, info, w):
        return edge_blocks_reference(nodes, src, dst, edge_T, info, w)
    common.check(nodes, "nodes", torch.float32, (nodes.shape[0], 4, 4))
    common.check(edge_T, "edge_T", torch.float32, (n_edges, 4, 4))
    common.check(info, "info", torch.float32, (n_edges, 6, 6))
    common.check(w, "w", torch.float32, (n_edges,))
    dev = nodes.device
    out = [torch.empty((n_edges, 6, 6), dtype=torch.float32, device=dev) for _ in range(3)]
    out += [torch.empty((n_edges, 6), dtype=torch.float32, device=dev) for _ in range(2)]
    if n_edges == 0:
        return tuple(out)
    src32 = src.to(torch.int32).contiguous()
    dst32 = dst.to(torch.int32).contiguous()
    lib = build.library()
    with torch.cuda.device(dev):
        err = lib.pcr_edge_blocks(nodes.data_ptr(), src32.data_ptr(), dst32.data_ptr(),
                                  edge_T.data_ptr(), info.data_ptr(), w.data_ptr(), n_edges,
                                  *(t.data_ptr() for t in out), common.stream_of(nodes))
    build.check_launch("edge_blocks", err)
    LAUNCHES["edge_blocks"] += 1
    trace.shape("edge_blocks", n_edges)
    return tuple(out)


def _check_blocks(blocks, n_edges: int) -> None:
    for name, t in zip(BLOCKS_PER_EDGE, blocks):
        common.check(t, name, torch.float32, (n_edges, 6, 6) if name[0] == "H" else (n_edges, 6))


def assemble_band(plan: AssemblyPlan, Hii, Hjj, Hij, bi, bj):
    """The circuit's (n, 6, 6) diagonal and super-diagonal bands and (n, 6)
    gradient from the blocks.  CPU tensors run ``index_add_``
    (``assemble_band_reference``); CUDA tensors launch the fixed-order sum."""
    n, blocks = plan.n, (Hii, Hjj, Hij, bi, bj)
    if not common.on_cuda(*blocks, plan.node_ent):
        return assemble_band_reference(n, plan.src.long(), plan.dst.long(), *blocks)
    _check_blocks(blocks, plan.src.shape[0])
    dev = Hii.device
    diag = torch.empty((n, 6, 6), dtype=torch.float32, device=dev)
    off = torch.empty((n, 6, 6), dtype=torch.float32, device=dev)
    b = torch.empty((n, 6), dtype=torch.float32, device=dev)
    lib = build.library()
    with torch.cuda.device(dev):
        err = lib.pcr_assemble_band(*(t.data_ptr() for t in blocks), plan.src.data_ptr(),
                                    plan.dst.data_ptr(), plan.node_off.data_ptr(),
                                    plan.node_ent.data_ptr(), n, diag.data_ptr(), off.data_ptr(),
                                    b.data_ptr(), common.stream_of(Hii))
    build.check_launch("assemble_band", err)
    LAUNCHES["edge_assembly"] += 1
    trace.shape("edge_assembly", n, plan.src.shape[0])
    return diag, off, b


def assemble_dense(plan: AssemblyPlan, Hii, Hjj, Hij, bi, bj):
    """The dense (6n, 6n) Hessian and (6n,) gradient from the blocks (a plan
    built with ``dense=True``).  CPU tensors run ``index_put_``
    (``assemble_dense_reference``); CUDA tensors launch the fixed-order
    sum."""
    n, blocks = plan.n, (Hii, Hjj, Hij, bi, bj)
    if not common.on_cuda(*blocks, plan.node_ent):
        return assemble_dense_reference(n, plan.src.long(), plan.dst.long(), *blocks)
    if plan.block_ent is None:
        raise ValueError("assemble_dense needs a plan built with dense=True")
    _check_blocks(blocks, plan.src.shape[0])
    dev = Hii.device
    H = torch.empty((6 * n, 6 * n), dtype=torch.float32, device=dev)
    b = torch.empty((6 * n,), dtype=torch.float32, device=dev)
    lib = build.library()
    with torch.cuda.device(dev):
        err = lib.pcr_assemble_dense(*(t.data_ptr() for t in blocks), plan.block_off.data_ptr(),
                                     plan.block_ent.data_ptr(), plan.node_off.data_ptr(),
                                     plan.node_ent.data_ptr(), n, H.data_ptr(), b.data_ptr(),
                                     common.stream_of(Hii))
    build.check_launch("assemble_dense", err)
    LAUNCHES["edge_assembly"] += 1
    trace.shape("edge_assembly", n, plan.src.shape[0])
    return H, b
