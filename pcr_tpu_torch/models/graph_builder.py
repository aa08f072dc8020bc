"""k-connectivity pose-graph builder (port of pcr_tpu/models/graph_builder.py):
the reference's ``full_registration`` and ``Coarse_to_fine_FGR_M_GICP``.

Each cloud is registered against its next k neighbours: odometry edges
(target == source+1, uncertain=False; the nodes accumulate inv(odometry))
and loop-closure edges (source+1 < target <= source+k, uncertain=True),
with the fitness > 0.40 success gate: k(2n-k-1)/2 edges for n clouds.

Each pair runs the coarse-to-fine chain: FGR (absolute scale) -> doubling
M-GICP -> information matrix at the refined pose.  The odometry chain is
accumulated on the host in float64.  The graph comes back as the port's
``PoseGraph`` on the clouds' device, ready for
``pose_graph.global_optimization``.

The tuple test draws from a ``torch.Generator`` seeded with each pair's
seed ``source*n + target``; ``uniforms`` (a function of that seed) replaces
the draws, so that the builders can replay another generator's stream.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..utils import trace
from ..utils.cloud import Cloud, stack_clouds
from . import evaluate as eval_mod
from . import fgr as fgr_mod
from . import multiscale as ms_mod
from .global_refine import pose_graph as pg_mod

Uniforms = Callable[[int], torch.Tensor] | None


def _pose(T: torch.Tensor) -> np.ndarray:
    return T.detach().to("cpu", torch.float64).numpy()


def coarse_to_fine(source: Cloud, target: Cloud, voxel_size: float, seed: int = 0,
                   n_scales: int = 3, iterations: int = 100,
                   retry: bool = True, fitness_gate: float = 0.40, uniforms: Uniforms = None):
    """``Coarse_to_fine_FGR_M_GICP``: FGR seed -> doubling M-GICP ->
    information matrix.  Returns (RegistrationResult, (6, 6) information
    matrix, gate fitness as a float).

    The gate fitness is the whole cloud's fitness at 2*voxel: the doubling
    schedule's finest correspondence distance derives from the extent, so
    ``res.fitness`` can score a wrong alignment above 0.5.  A gate failure
    re-seeds FGR (same voxel with the next seed, then coarser voxels) and
    keeps the best candidate by gate fitness.
    """
    def attempt(vmult: float, s: int):
        res_fgr = fgr_mod.registro_fgr(source, target, voxel_size * vmult,
                                       use_absolute_scale=True, seed=s,
                                       u=None if uniforms is None else uniforms(s))
        res = ms_mod.multiscale_gicp(source, target, res_fgr.transformation,
                                     n_scales=n_scales, iterations=iterations,
                                     schedule="doubling")
        with trace.span("gate"):
            fit, _, _ = eval_mod.evaluate_registration(source, target, 2 * voxel_size,
                                                       res.transformation)
        with trace.span("sync", site="gate"):
            return res, float(fit)

    res, gate_fit = attempt(1.0, seed)
    if retry and gate_fit <= fitness_gate:
        # the same voxel with another seed first (the tuple draws are the
        # usual failure), then coarser voxels
        for vmult, off in ((1.0, 101), (2.0, 202), (4.0, 303)):
            cand, cand_fit = attempt(vmult, seed + off)
            if cand_fit > gate_fit:
                res, gate_fit = cand, cand_fit
            if gate_fit > fitness_gate:
                break
    info = eval_mod.information_matrix(source, target, voxel_size, res.transformation)
    return res, info, gate_fit


def _graph(pairs, T_all, infos, gate_all, fitness_gate: float, log, device):
    """(PoseGraph, edges that pass the gate) of the k-connectivity edges
    ``pairs`` (source, target) with their poses and information matrices:
    odometry accumulated on the host in float64 (odometry = T @ odometry,
    node inv(odometry)), one log line an edge."""
    nodes = [np.eye(4)]
    odometry = np.eye(4)
    unc = []
    ok = 0
    for e, (s, t) in enumerate(pairs):
        if t == s + 1:
            odometry = T_all[e] @ odometry
            nodes.append(np.linalg.inv(odometry))
        unc.append(t != s + 1)
        ok += int(gate_all[e] > fitness_gate)
        if log:
            log(f"pair {s}->{t} {'loop' if unc[-1] else 'odom'} "
                f"fitness={gate_all[e]:.3f} "
                f"{'ok' if gate_all[e] > fitness_gate else 'FAILED'}")

    def f32(x):
        return torch.as_tensor(np.stack(x), dtype=torch.float32, device=device)

    return pg_mod.PoseGraph(
        nodes=f32(nodes),
        edge_src=torch.as_tensor([s for s, _ in pairs], dtype=torch.int64, device=device),
        edge_dst=torch.as_tensor([t for _, t in pairs], dtype=torch.int64, device=device),
        edge_T=f32(T_all), edge_info=f32(infos),
        uncertain=torch.as_tensor(unc, dtype=torch.bool, device=device),
        edge_mask=torch.ones(len(pairs), dtype=torch.bool, device=device)), ok


def _pairs(n: int, k: int) -> list[tuple[int, int]]:
    return [(s, t) for s in range(n) for t in range(s + 1, min(s + k + 1, n))]


def full_registration(clouds: list[Cloud], voxel_size: float, k: int,
                      fitness_gate: float = 0.40, log=print,
                      n_scales: int = 3, iterations: int = 100,
                      uniforms: Uniforms = None) -> pg_mod.PoseGraph:
    """The k-connectivity PoseGraph over ``clouds``, one pair after another.

    The pairwise result T registers cloud[source] onto cloud[target]; pair
    (source, target) runs ``coarse_to_fine`` with seed source*n + target.
    """
    n = len(clouds)
    pairs = _pairs(n, k)
    T_all, infos, gates = [], [], []
    for s, t in pairs:
        res, info, fit = coarse_to_fine(clouds[s], clouds[t], voxel_size, seed=s * n + t,
                                        n_scales=n_scales, iterations=iterations,
                                        fitness_gate=fitness_gate, uniforms=uniforms)
        with trace.span("sync", site="information"):
            T_all.append(_pose(res.transformation))
            infos.append(_pose(info))
        gates.append(fit)
    graph, ok = _graph(pairs, T_all, infos, gates, fitness_gate, log, clouds[0].device)
    if log:
        log(f"{ok}/{len(pairs)} successful registrations (gate {fitness_gate})")
    return graph


@trace.spanned("graph_builder")
def full_registration_batched(clouds: list[Cloud], voxel_size: float, k: int,
                              fitness_gate: float = 0.40, log=print,
                              n_scales: int = 3, iterations: int = 100,
                              batch_size: int = 4,
                              uniforms: Uniforms = None) -> pg_mod.PoseGraph:
    """``full_registration`` in chunks of ``batch_size`` pairs: FGR features
    once a cloud (``fgr.fgr_features``), one GNC over a chunk
    (``fgr.batched_registration_fgr``), the doubling M-GICP and the gate
    over the chunk's pairs, then information matrices in chunks.  A chunk
    short of ``batch_size`` repeats its last pair.

    Each pair keeps its serial seed source*n + target, and a pair whose
    first attempt fails the 2*voxel gate takes the serial ``coarse_to_fine``
    retry ladder, so the graph differs from the serial one only on pairs
    the serial builder would also have re-attempted.
    """
    from ..parallel import pair_sharding

    n = len(clouds)
    pairs = _pairs(n, k)
    E = len(pairs)
    B = max(batch_size, 1)

    feats: dict[int, tuple] = {}

    def feat(i):
        if i not in feats:
            feats[i] = fgr_mod.fgr_features(clouds[i], voxel_size)
        return feats[i]

    T_all = np.zeros((E, 4, 4))
    gate_all = np.zeros(E)
    for start in range(0, E, B):
        chunk = pairs[start:start + B]
        chunk_p = chunk + [chunk[-1]] * (B - len(chunk))
        src_f = [feat(s) for s, _ in chunk_p]
        tgt_f = [feat(t) for _, t in chunk_p]
        opts = fgr_mod.default_options(src_f[0][0], tgt_f[0][0], voxel_size,
                                       use_absolute_scale=True)
        seeds = [s * n + t for s, t in chunk_p]
        res_fgr = fgr_mod.batched_registration_fgr(
            stack_clouds([c for c, _ in src_f]), stack_clouds([c for c, _ in tgt_f]),
            torch.stack([f for _, f in src_f]), torch.stack([f for _, f in tgt_f]),
            opts, seeds, u=None if uniforms is None else torch.stack([uniforms(sd)
                                                                     for sd in seeds]))
        # the raw clouds for the doubling M-GICP (it preprocesses per scale)
        src_raw = stack_clouds([clouds[s] for s, _ in chunk_p])
        tgt_raw = stack_clouds([clouds[t] for _, t in chunk_p])
        res = pair_sharding.batched_mgicp(src_raw, tgt_raw, res_fgr.transformation,
                                          n_scales=n_scales, iterations=iterations,
                                          schedule="doubling")
        with trace.span("gate"):
            fit, _, _ = eval_mod.evaluate_registration_batch(src_raw, tgt_raw, 2 * voxel_size,
                                                             res.transformation)
        with trace.span("sync", site="gate"):
            T_np, fit_np = _pose(res.transformation), fit.cpu().numpy()
        T_all[start:start + len(chunk)] = T_np[:len(chunk)]
        gate_all[start:start + len(chunk)] = fit_np[:len(chunk)]

    infos = np.zeros((E, 6, 6))
    retried = 0
    for e, (s, t) in enumerate(pairs):
        if gate_all[e] <= fitness_gate:
            # the serial retry ladder, the serial builder's own path
            res, info, fit = coarse_to_fine(clouds[s], clouds[t], voxel_size, seed=s * n + t,
                                            n_scales=n_scales, iterations=iterations,
                                            fitness_gate=fitness_gate, uniforms=uniforms)
            with trace.span("sync", site="information"):
                T_all[e], infos[e], gate_all[e] = _pose(res.transformation), _pose(info), fit
            retried += 1
    # batched information matrices for the pairs not retried
    todo = [e for e in range(E) if not infos[e].any()]
    for start in range(0, len(todo), B):
        idx = todo[start:start + B]
        pad_idx = idx + [idx[-1]] * (B - len(idx))
        I = eval_mod.information_matrix_batch(
            stack_clouds([clouds[pairs[e][0]] for e in pad_idx]),
            stack_clouds([clouds[pairs[e][1]] for e in pad_idx]), voxel_size,
            torch.as_tensor(T_all[pad_idx], dtype=torch.float32, device=clouds[0].device))
        with trace.span("sync", site="information"):
            infos[idx] = _pose(I)[:len(idx)]
    graph, ok = _graph(pairs, T_all, infos, gate_all, fitness_gate, log, clouds[0].device)
    if log:
        log(f"{ok}/{E} successful registrations (gate {fitness_gate}, "
            f"{retried} retried serially)")
    return graph
