"""Within-pair point sharding over the ``points`` mesh axis (port of
pcr_tpu/parallel/point_sharding.py).

For TLS-scale clouds (Courtyard's 240k points) one pair fills a device, so
the rows of one cloud are split over ranks instead of the pairs:

  * ``sharded_nn1`` / ``sharded_knn``: the REFERENCE rows are sharded; every
    rank searches all queries in its shard (``ops/knn.nn1_exact`` /
    ``knn_exact``), and the shard winners are gathered and merged, ties to
    the lowest shard (the scan order of the unsharded merge);
  * ``point_sharded_gicp``: the SOURCE rows are sharded and the target
    replicated; the GICP loop sums its metric sums and normal equations over
    the ranks every iteration (``registration_gicp(group=)``), ~180 bytes an
    iteration, and every rank takes the same pose update.  The band sweep
    shards the rows after its sort (``models/gicp``'s docstring says why);
  * ``sharded_gicp_2d`` / ``sharded_mgicp_2d``: both axes at once, pairs over
    ``pairs`` and each pair's source rows over ``points``.

Inputs and outputs are replicated, as ``parallel/mesh`` states.
"""

from __future__ import annotations

import torch

from ..models import gicp as gicp_mod
from ..models import multiscale as ms_mod
from ..ops import knn as knn_ops
from ..utils.collectives import all_gather_rows
from .mesh import Mesh
from .pair_sharding import gather_result, stack_results


def _check_rows(mesh: Mesh, axis: str, rows: int, what: str) -> slice:
    n_dev = mesh.shape[axis]
    if rows % n_dev != 0:
        raise ValueError(f"{what} {rows} not divisible by mesh axis {n_dev}")
    return mesh.block(axis, rows)


def sharded_nn1(mesh: Mesh, query, ref, ref_mask, *, axis: str = "points",
                q_tile: int = 1024, r_chunk: int = 8192):
    """Exact nearest neighbour with the reference rows sharded over
    ``axis``: query (Nq, D), ref (Nr, D) and ref_mask (Nr,) replicated, Nr
    divisible by the axis size (pad with masked rows).  Returns (sqdist
    (Nq,), global ref index (Nq,)) replicated."""
    sl = _check_rows(mesh, axis, ref.shape[0], "ref rows")
    d_loc, i_loc = knn_ops.nn1_exact(query, ref[sl], ref_mask[sl], q_tile=q_tile,
                                     r_chunk=min(r_chunk, sl.stop - sl.start))
    group = mesh.group(axis)
    d_all = all_gather_rows(d_loc[None], group)                  # (n_dev, Nq)
    i_all = all_gather_rows((i_loc + sl.start)[None], group)
    best = torch.argmin(d_all, dim=0, keepdim=True)              # first minimum wins
    return d_all.gather(0, best)[0], i_all.gather(0, best)[0]


def sharded_knn(mesh: Mesh, query, ref, ref_mask, k: int, *, axis: str = "points",
                q_tile: int = 512):
    """Exact k-NN with the reference rows sharded over ``axis``: shard-local
    top k, then a gathered (n_dev * k)-candidate merge a query (stable, so
    ties keep shard order).  Matches ``ops/knn.knn_exact`` (ascending exact
    sqdists, global indices)."""
    sl = _check_rows(mesh, axis, ref.shape[0], "ref rows")
    d_loc, i_loc = knn_ops.knn_exact(query, ref[sl], ref_mask[sl], k, q_tile=q_tile)
    group = mesh.group(axis)
    nq = query.shape[0]
    d_all = all_gather_rows(d_loc[None], group).permute(1, 0, 2).reshape(nq, -1)
    i_all = all_gather_rows((i_loc + sl.start)[None], group).permute(1, 0, 2).reshape(nq, -1)
    order = torch.argsort(d_all, dim=1, stable=True)[:, :k]
    return d_all.gather(1, order), i_all.gather(1, order)


def point_sharded_gicp(mesh: Mesh, source, target, max_corr_dist, T_init, *,
                       axis: str = "points", **kw):
    """GICP with the SOURCE rows sharded over ``axis`` and the target
    replicated: every rank runs the whole loop on its block of the rows (of
    the sorted query tiles in the band sweep), the normal equations (6x6 +
    6) and the three metric sums summed over the ranks each iteration.  The
    source capacity must divide by the axis size (pcr_tpu's rule).  Returns
    the RegistrationResult of ``models/gicp.registration_gicp`` on one
    device, up to the summation order, on every rank."""
    _check_rows(mesh, axis, source.capacity, "source capacity")
    return gicp_mod.registration_gicp(source, target, max_corr_dist, T_init,
                                      group=mesh.group(axis), **kw)


def point_sharded_multiscale_gicp(mesh: Mesh, src_pyr, tgt_pyr, T_init, *,
                                  n_scales: int = 5, iterations: int = 100,
                                  loss: str = "l1", axis: str = "points", **kw):
    """M-GICP over precomputed pyramids with every scale's GICP
    point-sharded (``pipeline.run_pair(point_mesh=)``).  Pyramid scale
    capacities are bucket multiples (``cloud.plan_scale_caps``), so they
    divide by 2-, 4- and 8-rank axes.  The finest result carries every
    scale's iterations, as ``multiscale_gicp_pyramids``'s does."""
    dists = ms_mod.max_correspondence_distances(ms_mod.create_scales(n_scales))
    T, result, its = T_init, None, []
    for s in range(n_scales):
        result = point_sharded_gicp(mesh, src_pyr[s], tgt_pyr[s], dists[s], T, axis=axis,
                                    loss=loss, max_iteration=iterations, **kw)
        its.append(result.iterations)
        T = result.transformation
    return result._replace(scale_iterations=torch.stack(its))


def _check_2d(mesh: Mesh, batch: int) -> slice:
    n_pairs = mesh.shape["pairs"]
    if batch % n_pairs != 0:
        raise ValueError(f"pair batch {batch} not divisible by 'pairs' axis {n_pairs}")
    return mesh.block("pairs", batch)


def sharded_mgicp_2d(mesh: Mesh, source, target, T_init, *, n_scales: int = 5,
                     iterations: int = 100, loss: str = "l1", scale_capacities=None, **kw):
    """Multi-scale GICP over the (pairs, points) mesh: each rank builds the
    pyramids of its pair block (kernels K2/K3 on the card; replicated along
    'points'), then every scale's GICP runs with each pair's source rows
    split over 'points' (``kw``: ``registration_gicp``'s, e.g. ``q_tile``).

    source / target: stacked Clouds (B, N, ...); T_init (B, 4, 4).  B must
    divide by the 'pairs' axis and every scale capacity by the 'points'
    axis.  Matches ``pair_sharding.batched_mgicp`` up to the summation
    order, on every rank."""
    n_pts = mesh.shape["points"]
    if scale_capacities is not None:
        bad = [c for c in scale_capacities if c % n_pts != 0]
        if bad:
            raise ValueError(f"scale capacities {bad} not divisible by 'points' axis {n_pts}")
    sl = _check_2d(mesh, T_init.shape[0])
    results = []
    for b in range(sl.start, sl.stop):
        src_pyr, tgt_pyr = (ms_mod.build_pyramid(c[b], n_scales=n_scales,
                                                 scale_capacities=scale_capacities)
                            for c in (source, target))
        results.append(point_sharded_multiscale_gicp(mesh, src_pyr, tgt_pyr, T_init[b],
                                                     n_scales=n_scales, iterations=iterations,
                                                     loss=loss, **kw))
    return gather_result(stack_results(results), mesh.group("pairs"))


def sharded_gicp_2d(mesh: Mesh, source, target, max_corr_dist, T_init, **kw):
    """Single-scale GICP over the (pairs, points) mesh: the pair batch over
    'pairs' and every pair's source rows over 'points', the normal
    equations summed over 'points' each iteration.  source: stacked Cloud
    (B, N, ...); target (B, M, ...); T_init (B, 4, 4).  B must divide by the
    'pairs' axis, N by the 'points' axis.  Matches
    ``pair_sharding.batched_gicp`` up to the summation order."""
    sl = _check_2d(mesh, T_init.shape[0])
    results = [point_sharded_gicp(mesh, source[b], target[b], max_corr_dist, T_init[b], **kw)
               for b in range(sl.start, sl.stop)]
    return gather_result(stack_results(results), mesh.group("pairs"))
