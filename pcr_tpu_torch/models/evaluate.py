"""Registration evaluation and information matrices (port of
pcr_tpu/models/evaluate.py): Open3D ``evaluate_registration`` and
``get_information_matrix_from_point_clouds`` semantics.

Correspondence search: the band sweep (kernel K1) by default;
``method='exact'`` runs the brute-force ``ops/knn.nn1`` (kernel K7 on the
card), the oracle the band path is held to.  Twist/block order is
(omega, t), rotation first.  The trajectory scores ``aligned_ate`` and
``circuit_edge_consistency`` run on the host in float64.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import band_nn
from ..ops import knn as knn_ops
from ..utils import se3
from ..utils.cloud import Cloud


def _nn_within(p, p_mask, target: Cloud, max_dist: float, method: str, band: int):
    """(sqdist, index) of each source point's nearest target within
    max_dist; out-of-range entries get sqdist >= BIG."""
    if method == "band":
        return band_nn.nn1_band(p, p_mask, target.points, target.mask, max_dist, band=band)
    if method != "exact":
        raise ValueError(f"unknown evaluation method {method!r}")
    d2, j = knn_ops.nn1(p, target.points, target.mask)
    return torch.where(d2 <= knn_ops.sq_f32(max_dist), d2, knn_ops.BIG), j


def _moved(source: Cloud, T) -> torch.Tensor:
    return se3.transform_points(
        torch.as_tensor(T, dtype=torch.float32, device=source.device), source.points)


def evaluate_registration(source: Cloud, target: Cloud, max_dist: float, T,
                          method: str = "band", band: int = 2048):
    """fitness = inlier fraction, inlier_rmse over correspondences within
    max_dist; returns (fitness, rmse, n_corr) as 0-dim tensors."""
    d2, _ = _nn_within(_moved(source, T), source.mask, target, max_dist, method, band)
    valid = source.mask & (d2 < knn_ops.BIG)
    n_corr = torch.sum(valid.to(torch.float32))
    n_src = torch.clamp(torch.sum(source.mask.to(torch.float32)), min=1.0)
    rmse = torch.sqrt(torch.sum(torch.where(valid, d2, 0.0)) / torch.clamp(n_corr, min=1.0))
    return n_corr / n_src, rmse, n_corr


def information_matrix(source: Cloud, target: Cloud, max_dist: float, T,
                       method: str = "band", band: int = 2048) -> torch.Tensor:
    """(6, 6) information matrix sum G^T G over the inlier correspondences
    at pose T, G = [-skew(q) | I] built from the matched TARGET points q."""
    d2, j = _nn_within(_moved(source, T), source.mask, target, max_dist, method, band)
    valid = source.mask & (d2 < knn_ops.BIG)
    q = target.points[j]
    eye = torch.eye(3, dtype=q.dtype, device=q.device).expand(q.shape[0], 3, 3)
    G = torch.cat([-se3.skew(q), eye], dim=-1)                 # (N, 3, 6)
    return torch.einsum("nij,nik->jk", G * valid.to(torch.float32)[:, None, None], G)


def evaluate_registration_batch(source: Cloud, target: Cloud, max_dist: float, T,
                                method: str = "band", band: int = 2048):
    """``evaluate_registration`` over the pairs of stacked clouds (leading
    dim B, ``cloud.stack_clouds``) at poses T (B, 4, 4); returns (fitness,
    rmse, n_corr), each (B,).  On one card the pairs run one after another
    (the JAX package vmaps them)."""
    rows = [evaluate_registration(source[b], target[b], max_dist, T[b], method=method,
                                  band=band) for b in range(source.points.shape[0])]
    return tuple(torch.stack(col) for col in zip(*rows))


def information_matrix_batch(source: Cloud, target: Cloud, max_dist: float, T,
                             method: str = "band", band: int = 2048) -> torch.Tensor:
    """``information_matrix`` over the pairs of stacked clouds at poses T
    (B, 4, 4), one after another on the card; returns (B, 6, 6)."""
    return torch.stack([information_matrix(source[b], target[b], max_dist, T[b],
                                           method=method, band=band)
                        for b in range(source.points.shape[0])])


def aligned_ate(absolute_poses, target_poses) -> dict:
    """SE(3)-Umeyama-aligned absolute trajectory error: rigidly align the
    estimated positions to the target positions (Kabsch/Umeyama, no scale),
    then report the translation residuals.  Removes the global-frame gauge,
    so trajectories in either chain convention can be scored against one
    target.  Host float64 numpy."""
    p = np.asarray(absolute_poses, np.float64)[:, :3, 3]
    q = np.asarray(target_poses, np.float64)[:, :3, 3]
    mu_p, mu_q = p.mean(axis=0), q.mean(axis=0)
    H = (p - mu_p).T @ (q - mu_q)
    U, _, Vt = np.linalg.svd(H)
    S = np.diag([1.0, 1.0, np.sign(np.linalg.det(Vt.T @ U.T))])
    R = Vt.T @ S @ U.T
    res = np.linalg.norm(q - ((p - mu_p) @ R.T + mu_q), axis=1)
    return {
        "rmse_m": float(np.sqrt(np.mean(res**2))),
        "mean_m": float(res.mean()),
        "median_m": float(np.median(res)),
        "max_m": float(res.max()),
    }


def circuit_edge_consistency(absolute_poses, relative_poses,
                             convention: str = "reference") -> dict:
    """Per-edge agreement between a trajectory and the measured relative
    poses of its circuit.  For edge k (pair ((k+1) % n, k)) the trajectory
    implies T_impl, which is compared with relative_poses[k]: dR =
    ||R_impl - R_rel||_F * sqrt(2)/2, dt = ||t_impl - t_rel||.

    ``convention`` is the absolute -> relative recovery the trajectory is
    scored in: "reference" uses the reference's own
    ``poses_absolutas_para_relativas`` (T_impl = compose_ref(A_{k+1},
    inv(A_k)), reversed rotation order), under which its chain
    (``se3.relative_to_absolute``) and the closed forms score perfectly on
    edges 0..n-2; "standard" uses inv(A_k) @ A_{k+1}, under which the
    standard chain and the pose graph do.  Any other value raises: a
    trajectory scored in the wrong convention shows the conjugation gap
    (~0.03 rad an edge on NCLT) as inconsistency.  Host float64 numpy.
    Returns {dR: (n,), dt: (n,)} plus summary floats."""
    if convention not in ("reference", "standard"):
        raise ValueError(f"convention must be 'reference' or 'standard', got {convention!r}")
    A = np.asarray(absolute_poses, np.float64)
    rel = np.asarray(relative_poses, np.float64)
    A_next = np.concatenate([A[1:], A[:1]])
    if convention == "standard":
        impl = se3.compose(se3.invert(A), A_next)
    else:
        impl = se3.compose_ref(A_next, se3.invert(A))
    dR = np.linalg.norm(impl[:, :3, :3] - rel[:, :3, :3], axis=(1, 2)) * np.sqrt(2) / 2
    dt = np.linalg.norm(impl[:, :3, 3] - rel[:, :3, 3], axis=1)
    return {
        "dR": dR, "dt": dt,
        "dt_max_m": float(dt.max()), "dt_mean_m": float(dt.mean()),
        "dt_closure_edge_m": float(dt[-1]),
        "dR_max": float(dR.max()), "dR_mean": float(dR.mean()),
    }
