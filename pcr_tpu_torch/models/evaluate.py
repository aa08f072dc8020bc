"""Registration evaluation (port of pcr_tpu/models/evaluate.py, band method):
Open3D ``evaluate_registration`` semantics over the band correspondence
search (kernel K1)."""

from __future__ import annotations

import torch

from ..ops import band_nn
from ..utils import se3
from ..utils.cloud import Cloud


def evaluate_registration(source: Cloud, target: Cloud, max_dist: float, T,
                          band: int = 2048):
    """fitness = inlier fraction, inlier_rmse over correspondences within
    max_dist; returns (fitness, rmse, n_corr) as 0-dim tensors."""
    T = torch.as_tensor(T, dtype=torch.float32, device=source.device)
    p = se3.transform_points(T, source.points)
    d2, _ = band_nn.nn1_band(p, source.mask, target.points, target.mask,
                             max_dist, band=band)
    valid = source.mask & (d2 < band_nn.BIG)
    n_corr = torch.sum(valid.to(torch.float32))
    n_src = torch.clamp(torch.sum(source.mask.to(torch.float32)), min=1.0)
    rmse = torch.sqrt(torch.sum(torch.where(valid, d2, 0.0)) / torch.clamp(n_corr, min=1.0))
    return n_corr / n_src, rmse, n_corr


def evaluate_registration_batch(sources: list[Cloud], targets: list[Cloud],
                                max_dist: float, Ts, band: int = 2048):
    """``evaluate_registration`` over pairs (sources[b], targets[b], Ts[b]);
    returns stacked (fitness, rmse, n_corr), each (B,)."""
    rows = [evaluate_registration(s, t, max_dist, T, band=band)
            for s, t, T in zip(sources, targets, Ts)]
    return tuple(torch.stack(col) for col in zip(*rows))
