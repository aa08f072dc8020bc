"""Statistical outlier removal over k-NN neighbour lists (port of
pcr_tpu/ops/outlier.py): Open3D's ``remove_statistical_outlier``.

Each point's mean distance to its nb_neighbors nearest (itself excluded); a
point is dropped when that mean exceeds mu + std_ratio * sigma of the
per-point means over the valid points (sigma: the unbiased n-1 estimate).
Shapes stay fixed: removal clears the mask and parks the point at PAD_COORD.
"""

from __future__ import annotations

import torch

from . import knn as knn_ops
from ..utils.cloud import Cloud, PAD_COORD


def statistical_outlier_mask(points: torch.Tensor, mask: torch.Tensor,
                             nb_neighbors: int = 30, std_ratio: float = 1.0) -> torch.Tensor:
    """The filtered validity mask (True = keep)."""
    d2, _ = knn_ops.knn(points, points, mask, nb_neighbors, exclude_self=True)
    neighbor_valid = d2 < knn_ops.BIG
    d = torch.sqrt(torch.clamp(d2, min=0.0))
    counts = torch.sum(neighbor_valid, dim=1)
    mean_d = torch.sum(torch.where(neighbor_valid, d, 0.0), dim=1) / torch.clamp(counts, min=1)

    w = mask.to(torch.float32)
    n_valid = torch.clamp(torch.sum(w), min=1.0)
    mu = torch.sum(mean_d * w) / n_valid
    var = torch.sum((mean_d - mu) ** 2 * w) / torch.clamp(n_valid - 1.0, min=1.0)
    return mask & (mean_d <= mu + std_ratio * torch.sqrt(var))


def remove_statistical_outliers(c: Cloud, nb_neighbors: int = 30,
                                std_ratio: float = 1.0) -> Cloud:
    keep = statistical_outlier_mask(c.points, c.mask, nb_neighbors, std_ratio)
    return Cloud(points=torch.where(keep[:, None], c.points, PAD_COORD), mask=keep,
                 normals=c.normals, covariances=c.covariances)
