"""Registration evaluation and information matrices (port of
pcr_tpu/models/evaluate.py): Open3D ``evaluate_registration`` and
``get_information_matrix_from_point_clouds`` semantics.

Correspondence search: the band sweep (kernel K1) by default;
``method='exact'`` runs the brute-force ``ops/knn.nn1`` (kernel K7 on the
card), the oracle the band path is held to.  Twist/block order is
(omega, t), rotation first.
"""

from __future__ import annotations

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


def evaluate_registration_batch(sources: list[Cloud], targets: list[Cloud],
                                max_dist: float, Ts, method: str = "band", band: int = 2048):
    """``evaluate_registration`` over pairs (sources[b], targets[b], Ts[b]);
    returns stacked (fitness, rmse, n_corr), each (B,)."""
    rows = [evaluate_registration(s, t, max_dist, T, method=method, band=band)
            for s, t, T in zip(sources, targets, Ts)]
    return tuple(torch.stack(col) for col in zip(*rows))


def information_matrix_batch(sources: list[Cloud], targets: list[Cloud], max_dist: float,
                             Ts, method: str = "band", band: int = 2048) -> torch.Tensor:
    """``information_matrix`` over pairs; returns (B, 6, 6)."""
    return torch.stack([information_matrix(s, t, max_dist, T, method=method, band=band)
                        for s, t, T in zip(sources, targets, Ts)])
