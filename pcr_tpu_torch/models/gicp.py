"""Generalized-ICP (port of pcr_tpu/models/gicp.py: its band, brute and
hash-grid correspondence methods).

Per Gauss-Newton iteration:
  1. 1-NN correspondences of the transformed source in the target within
     max_dist (band sweep, kernel K1; brute force over the whole target,
     kernel K7; or the hash grid of ``ops/grid_nn``, built once per call);
  2. plane-disk GICP residuals d = q - T p with the Mahalanobis metric
     M = (C_q + R C_p R^T)^-1, both covariances clamped to eigenvalues
     (eps, 1, 1) with eps = 1e-3;
  3. a robust weight of the euclidean residual norm (L2, L1 or Geman-McClure);
  4. one damped Gauss-Newton step on xi = (omega, t): T <- exp(xi) T;
  5. convergence when |delta fitness| < relative_fitness and |delta rmse| <
     relative_rmse (Open3D's ICPConvergenceCriteria).

The band loop (the default, ``_gicp_band_sorted``) runs steps 2-5 as kernel
K10 around K1 (``ops/kernels/gicp_kernels``): on the card three launches and
K1's an iteration, the sums reduced in a fixed order, T and the convergence
state kept on the device; the host reads the flag once an iteration.  The
brute and grid loops and ``gicp_loss_log`` run ``gicp_step`` in plain
PyTorch.

``group=`` (pcr_tpu's ``axis_name``) is the point-sharded mode of
``parallel/point_sharding``: every rank passes the whole source and works on
its block of the source rows, and the metric sums and the normal equations
(H, g) are summed over the group's ranks every iteration before the damping
and the solve, so every rank takes the same pose update and leaves the loop
at the same iteration.  The band sweep splits the rows after its sort, into
blocks of the whole query tiles that hold real rows: a tile then meets the
slab it meets on one device, and the result is the one-device result up to
the summation order.
pcr_tpu shards the rows before its sort, which moves the slabs: done that
way, chip_smoke.py's two-rank stage 2 landed 9.9e-4 from the one-device
poses on an H100 80GB HBM3 (700 W).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import band_nn, eigen3, grid_nn
from ..ops import knn as knn_ops
from ..ops.kernels import gicp_kernels, nn_kernels
from ..ops.kernels.gicp_kernels import inv3 as _inv3
from ..ops.kernels.gicp_kernels import robust_weight
from ..utils import collectives
from ..utils import se3, trace
from ..utils.cloud import Cloud, pad_rows
from ..utils.linalg import solve6_cholesky

GICP_EPSILON = 1e-3


class RegistrationResult(NamedTuple):
    """Mirror of Open3D's RegistrationResult scalar surface (0-dim tensors).

    ``scale_iterations`` is set by the multiscale runner: the iteration count
    of every scale, coarse to fine."""

    transformation: torch.Tensor  # (4, 4)
    fitness: torch.Tensor         # inlier fraction of valid source points
    inlier_rmse: torch.Tensor     # euclidean rmse over inliers
    num_correspondences: torch.Tensor
    iterations: torch.Tensor
    scale_iterations: torch.Tensor | None = None


def regularize_covariances(cov: torch.Tensor, epsilon: float = GICP_EPSILON) -> torch.Tensor:
    """GICP covariance conditioning: eigenvalues replaced by (eps, 1, 1), the
    smallest eigendirection (the surface normal) getting eps."""
    _, V = eigen3.eigh3(cov)
    d = torch.tensor([epsilon, 1.0, 1.0], dtype=cov.dtype, device=cov.device)
    return torch.einsum("...ik,k,...jk->...ij", V, d, V)


def covariances_from_normals(normals: torch.Tensor,
                             epsilon: float = GICP_EPSILON) -> torch.Tensor:
    """Plane-disk covariance C = I - (1-eps) n n^T of a unit normal
    (eigenvalues (eps, 1, 1), n the eps-direction): Open3D's construction
    for a cloud with normals but no covariances."""
    eye = torch.eye(3, dtype=normals.dtype, device=normals.device)
    return eye.expand(normals.shape[:-1] + (3, 3)) - (1.0 - epsilon) * (
        normals[..., :, None] * normals[..., None, :])


def _metrics(valid: torch.Tensor, d2: torch.Tensor, src_mask: torch.Tensor, group=None):
    """(fitness, rmse, n_corr) reductions, as 0-dim f32 tensors; with
    ``group`` the three sums are summed over its ranks before dividing."""
    sums = torch.stack([torch.sum(valid.to(torch.float32)),
                        torch.sum(src_mask.to(torch.float32)),
                        torch.sum(torch.where(valid, d2, 0.0))])
    if group is not None:
        sums = collectives.all_reduce_sum(sums, group)
    n_corr, n_src, sum_d2 = sums
    fitness = n_corr / torch.clamp(n_src, min=1.0)
    rmse = torch.sqrt(sum_d2 / torch.clamp(n_corr, min=1.0))
    return fitness, rmse, n_corr


def _unit_normals(c: Cloud) -> torch.Tensor:
    """Unit normals for the plane-disk covariance: the cloud's normals if
    present, else the smallest eigenvector of its covariances."""
    if c.normals is not None:
        return c.normals
    if c.covariances is None:
        raise ValueError("GICP needs normals or covariances on both clouds")
    _, V = eigen3.eigh3(c.covariances)
    return V[..., :, 0]


def _regularized_covariances(c: Cloud) -> torch.Tensor:
    """The cloud's covariances clamped to (eps, 1, 1), or the plane-disk
    covariances of its normals when it carries none."""
    if c.covariances is not None:
        return regularize_covariances(c.covariances)
    if c.normals is None:
        raise ValueError("GICP needs normals or covariances on both clouds")
    return covariances_from_normals(c.normals)


def _band_width(nr0: int, cap: int) -> int:
    """Capacity-scaled band: nr/8 rows, rounded to 256, within [512, cap]."""
    return min(cap, max(512, -(-(nr0 // 8) // 256) * 256))


def iteration_band(nr0: int) -> int:
    """The band of the band loop's iterations for a target of ``nr0`` rows."""
    return _band_width(nr0, 1024)


def _correspond(src_pts, src_mask, tgt_pts, tgt_mask, T, max_dist: float, accel=None):
    """Correspondences at pose T: (moved source p, target index j, valid,
    exact d2).  ``accel`` None runs the brute-force ``knn.nn1`` (kernel K7
    on the card); a ``grid_nn.HashGrid`` of the target runs ``nn1_grid``."""
    p = se3.transform_points(T, src_pts)
    d2, j = (knn_ops.nn1(p, tgt_pts, tgt_mask) if accel is None
             else grid_nn.nn1_grid(accel, p, max_dist))
    valid = src_mask & (d2 <= knn_ops.sq_f32(max_dist)) & (d2 < knn_ops.BIG)
    return p, j, valid, d2


def _damped_step(H, g, n_corr, T, group):
    """The pose update from the normal equations: (H, g) summed over
    ``group``'s ranks, then the Levenberg damping and the 6x6 solve; no
    correspondence keeps T."""
    if group is not None:
        Hg = collectives.all_reduce_sum(torch.cat([H.reshape(36), g]), group)
        H, g = Hg[:36].reshape(6, 6), Hg[36:]
    H = H + 1e-6 * (torch.trace(H) / 6.0 + 1.0) * torch.eye(6, dtype=H.dtype, device=H.device)
    xi = torch.where(n_corr > 0, -solve6_cholesky(H, g), 0.0)
    return se3.compose(se3.se3_exp(xi), T)


def gicp_step(src_pts, src_cov, src_mask, tgt_pts, tgt_cov, tgt_mask, T, max_dist: float,
              loss: str = "l1", gm_k: float = 1.0, group=None, accel=None):
    """One correspondence search (``_correspond``'s ``accel``) and
    Gauss-Newton update with full covariances (regularized by the caller).
    Returns (T_new, fitness, rmse, n_corr), the metrics measured at the
    input pose."""
    p, j, valid, d2 = _correspond(src_pts, src_mask, tgt_pts, tgt_mask, T, max_dist, accel)
    fitness, rmse, n_corr = _metrics(valid, d2, src_mask, group)
    d = tgt_pts[j] - p
    R = se3.rot(T)
    M = _inv3(tgt_cov[j] + R @ src_cov @ R.T)                 # (N, 3, 3)
    r_norm = torch.sqrt(torch.clamp(d2, min=1e-16))
    w = robust_weight(loss, r_norm, gm_k) * valid.to(torch.float32)
    minus_eye = (-torch.eye(3, dtype=torch.float32, device=p.device)).expand(p.shape[0], 3, 3)
    G = torch.cat([se3.skew(p), minus_eye], dim=-1)           # (N, 3, 6)
    wG = G * w[:, None, None]
    H = torch.einsum("nij,nik->jk", wG, M @ G)
    g = torch.einsum("nij,ni->j", wG, (M @ d[:, :, None])[:, :, 0])
    return _damped_step(H, g, n_corr, T, group), fitness, rmse, n_corr


def registration_gicp(source: Cloud, target: Cloud, max_corr_dist, T_init,
                      corr_method: str = "auto", loss: str = "l1", gm_k: float = 1.0,
                      max_iteration: int = 100, relative_fitness: float = 1e-6,
                      relative_rmse: float = 1e-6, group=None,
                      q_tile: int = 1024) -> RegistrationResult:
    """GICP with ICPConvergenceCriteria semantics.  The clouds must carry
    normals or covariances.  ``group``: this rank works on its block of the
    source rows and every reduction is summed over the group (module
    docstring).

    ``corr_method``: 'auto', 'band' and 'band_pallas' run the band sweep
    (kernel K1) in sorted space, ``q_tile`` sorted queries a tile (with a
    group, the unit in which the rows are split); 'brute' runs the exact
    brute-force search (kernel K7) and 'grid' the hash grid of
    ``ops/grid_nn`` over the target (exact within max_dist), both with full
    covariances.  pcr_tpu resolves 'auto' to 'grid' off the TPU; the port
    runs the band sweep, the counterpart of its TPU default."""
    T0 = torch.as_tensor(T_init, dtype=torch.float32, device=source.device)
    max_dist = float(np.float32(max_corr_dist))
    args = (source, target, max_dist, T0, loss, gm_k, max_iteration, relative_fitness,
            relative_rmse, group)
    if corr_method in ("auto", "band", "band_pallas"):
        return _gicp_band_sorted(*args, q_tile=q_tile)
    if corr_method in ("brute", "grid"):
        return _gicp_nn1(*args, grid=corr_method == "grid")
    raise ValueError(f"unknown corr_method {corr_method!r}")


def _gicp_nn1(source: Cloud, target: Cloud, max_dist: float, T0: torch.Tensor, loss: str,
              gm_k: float, max_iteration: int, relative_fitness: float,
              relative_rmse: float, group=None, grid: bool = False) -> RegistrationResult:
    """GICP over brute-force or (``grid``) hash-grid correspondences
    (pcr_tpu's non-band loop), with the final metrics taken at the
    converged pose.  The grid is built once, over the whole target."""
    if group is not None:   # this rank's rows
        source = source[collectives.rank_block(source.capacity, group)]
    src_cov = _regularized_covariances(source)
    tgt_cov = _regularized_covariances(target)
    accel = grid_nn.build_grid(target.points, target.mask, max_dist) if grid else None

    def step(T):
        return gicp_step(source.points, src_cov, source.mask, target.points, tgt_cov,
                         target.mask, T, max_dist, loss=loss, gm_k=gm_k, group=group,
                         accel=accel)

    # the convergence flag is read on the host every iteration, as in the
    # band loop below; with a group it comes from the summed metrics, so
    # every rank leaves at the same iteration
    T = T0
    fit_prev, rmse_prev = -1.0, -1.0
    iters = 0
    for _ in range(max_iteration):
        T, fit, rmse, n_corr = step(T)
        iters += 1
        done = (((fit - fit_prev).abs() < relative_fitness)
                & ((rmse - rmse_prev).abs() < relative_rmse)) | (n_corr == 0)
        fit_prev, rmse_prev = fit, rmse
        with trace.span("sync", site="gicp"):
            stop = bool(done)
        if stop:
            break
    trace.count("gicp.iterations", iters)
    _, _, valid, d2 = _correspond(source.points, source.mask, target.points, target.mask,
                                  T, max_dist, accel)
    fitness, rmse, n_corr = _metrics(valid, d2, source.mask, group)
    return RegistrationResult(T, fitness, rmse, n_corr,
                              torch.tensor(iters, dtype=torch.int32, device=source.device))


def _gicp_band_sorted(
    source: Cloud,
    target: Cloud,
    max_dist: float,
    T0: torch.Tensor,
    loss: str,
    gm_k: float,
    max_iteration: int,
    relative_fitness: float,
    relative_rmse: float,
    group=None,
    q_tile: int = 1024,
) -> RegistrationResult:
    """Band-accelerated GICP that LIVES in sorted query space.

    Every loop output (H, g, fitness, rmse) is a permutation-invariant
    reduction, so the source arrays are permuted ONCE into the index's
    grouped order and the target arrays into ref-sorted order.  A regularized
    GICP covariance is exactly the plane-disk form I - (1-eps) n n^T, so
        C_q + R C_p R^T = 2I - (1-eps)(m m^T + u u^T),  u = R n_p,
    and the per-iteration gather is one packed (N, 8) row [q | m | 0 0].
    Each iteration is K10's three launches around K1's sweep (in the loop
    below); on CPU tensors their plain versions.
    """
    dev = source.device
    a = 1.0 - GICP_EPSILON
    src_n = _unit_normals(source)
    tgt_n = _unit_normals(target)
    max_d2 = float(np.float32(max_dist) * np.float32(max_dist))

    # band capped at 1024 for the iterations: the per-iteration sweep cost is
    # nq_pad x 2*band, and nr/8 rows either side already covers ~extent/4
    nr0 = target.points.shape[0]
    band = iteration_band(nr0)
    p0 = se3.transform_points(T0, source.points)
    index = band_nn.build_band_index(p0, source.mask, target.points, target.mask,
                                     band=band)

    nq = source.points.shape[0]
    nq_pad = -(-nq // q_tile) * q_tile
    mine = slice(None)      # the sorted rows this rank sweeps: all of them...
    if group is not None:
        # ...or its block of the tiles that hold real rows (masked rows sort
        # last), a whole tile or more for every rank
        n_tiles = max(-(-int(source.mask.sum()) // q_tile), collectives.group_size(group))
        nq_pad = max(nq_pad, n_tiles * q_tile)
        tiles = collectives.rank_block(n_tiles, group)
        mine = slice(tiles.start * q_tile, tiles.stop * q_tile)
    nr_pad = index.r_sorted.shape[0]
    qo = index.q_order
    src_pts_s = pad_rows(source.points[qo], nq_pad, band_nn.SENTINEL)
    src_n_s = pad_rows(src_n[qo], nq_pad, 0.0)
    src_mask_s = pad_rows(source.mask[qo], nq_pad, False)
    # packed target rows in sorted order: [x y z | nx ny nz | 0 0]
    tgt_n_sorted = pad_rows(tgt_n[index.r_order], nr_pad, 0.0)
    tgt_pack = torch.cat([index.r_sorted, tgt_n_sorted,
                          torch.zeros((nr_pad, 2), dtype=torch.float32, device=dev)], dim=1)

    pts_m, n_m, mask_m = src_pts_s[mine], src_n_s[mine], src_mask_s[mine]
    nr = index.ra_sorted.shape[0]

    def corr_step(T):
        p = se3.transform_points(T, pts_m)
        d2a, i_s = band_nn.nn1_band_query_sorted(index, p, mask_m, max_dist,
                                                 q_tile=q_tile, band=band)
        d = tgt_pack[i_s, :3] - p
        d2 = torch.sum(d * d, dim=1)
        valid = mask_m & (d2a < band_nn.BIG) & (d2 <= max_d2)
        return d2, valid

    # One iteration is K10 around K1 (ops/kernels/gicp_kernels): the rows
    # moved and their tiles' slab starts, the sweep, the normal equations'
    # and the metrics' sums over the rows (with a group, summed over its
    # ranks), then the update of T and of the loop's state on the device.
    # The host reads the convergence flag every iteration.  On the H100 that
    # measured faster than reading it every 4 iterations and freezing
    # converged state on the device (see PERF.md): registrations converge in
    # 3-8 iterations per scale, so the extra iterations cost more than the
    # reads.  The read also keeps the per-scale iteration counts pcr_tpu's,
    # and with a group the flag comes from the summed metrics, identical on
    # every rank, so the ranks leave the loop together and no rank leaves the
    # others waiting in a collective.
    T = T0.clone(memory_format=torch.contiguous_format)
    state = gicp_kernels.initial_state(dev)
    iters = 0
    for _ in range(max_iteration):
        q_sp, starts = gicp_kernels.gicp_move(T, pts_m, mask_m, index, max_dist,
                                              q_tile=q_tile, band=band)
        d2k, rows = nn_kernels.nn1_band(starts, q_sp, index.r_sorted, q_tile=q_tile, band=band)
        sums = gicp_kernels.gicp_rows(q_sp, n_m, mask_m, d2k, rows, tgt_pack, T, nr=nr,
                                      max_d2=max_d2, a=a, loss=loss, gm_k=gm_k)
        if group is not None:
            sums = collectives.all_reduce_sum(sums.sum(dim=0, keepdim=True), group)
        gicp_kernels.gicp_update(sums, T, state, relative_fitness, relative_rmse)
        iters += 1
        with trace.span("sync", site="gicp"):
            stop = bool(state[3])
        if stop:
            break
    trace.count("gicp.iterations", iters)

    # FINAL metrics over the un-capped band (the 1024 cap can truncate
    # in-radius correspondences at high density while the pose is unchanged);
    # its own index (the same sorted refs, the queries sorted again) groups
    # every row, so with a group each rank queries them all and no sum is
    # needed
    band_f = _band_width(nr0, 2048)
    if band_f != band:
        p_f = se3.transform_points(T, src_pts_s)
        index_f = band_nn.requery_band_index(index, p_f, src_mask_s, band=band_f)
        d2f, _ = band_nn.nn1_band_query(index_f, p_f, src_mask_s, max_dist, band=band_f)
        valid = src_mask_s & (d2f < band_nn.BIG)
        fitness, rmse, n_corr = _metrics(valid, d2f, src_mask_s)
    else:
        d2, valid = corr_step(T)
        fitness, rmse, n_corr = _metrics(valid, d2, mask_m, group)
    return RegistrationResult(T, fitness, rmse, n_corr,
                              torch.tensor(iters, dtype=torch.int32, device=dev))


def gicp_loss_log(source: Cloud, target: Cloud, max_corr_dist, T_init, loss: str = "l1",
                  gm_k: float = 1.0, max_iteration: int = 100, corr_method: str = "auto"):
    """Diagnostic GICP run with a per-iteration loss log (the reference plots
    Open3D's ``loss_log``, ``plot_rmse_vs_iteracoes``).

    Runs the full iteration budget, a fixed trip count with no early exit and
    no host read, and returns ``(RegistrationResult, log)`` with ``log =
    {"fitness": (I,), "inlier_rmse": (I,)}``, each entry measured at the pose
    its Gauss-Newton step started from.  ``corr_method``: 'grid' (the hash
    grid of ``ops/grid_nn``, built once) or 'brute' (``knn.nn1``, kernel K7
    on the card); both are exact within max_dist.  'auto', the default, is
    pcr_tpu's default 'grid' on CPU tensors and 'brute' on the card, where
    K7 takes about half the grid's time.  Not the hot path: use
    ``registration_gicp``."""
    if corr_method == "auto":
        corr_method = "grid" if source.points.device.type == "cpu" else "brute"
    if corr_method not in ("grid", "brute"):
        raise ValueError(f"unknown corr_method {corr_method!r}")
    max_dist = float(np.float32(max_corr_dist))
    T = torch.as_tensor(T_init, dtype=torch.float32, device=source.device)
    src_cov = _regularized_covariances(source)
    tgt_cov = _regularized_covariances(target)
    accel = (grid_nn.build_grid(target.points, target.mask, max_dist)
             if corr_method == "grid" else None)
    fits, rmses = [], []
    for _ in range(max_iteration):
        T, fit, rmse, _ = gicp_step(source.points, src_cov, source.mask, target.points, tgt_cov,
                                    target.mask, T, max_dist, loss=loss, gm_k=gm_k, accel=accel)
        fits.append(fit)
        rmses.append(rmse)
    _, _, valid, d2 = _correspond(source.points, source.mask, target.points, target.mask, T,
                                  max_dist, accel)
    fitness, rmse, n_corr = _metrics(valid, d2, source.mask)
    res = RegistrationResult(T, fitness, rmse, n_corr,
                             torch.tensor(max_iteration, dtype=torch.int32, device=source.device))
    return res, {"fitness": torch.stack(fits), "inlier_rmse": torch.stack(rmses)}
