"""Normal and covariance estimation over k-NN neighbour lists (port of
pcr_tpu/ops/normals.py): Open3D's ``estimate_normals`` /
``estimate_covariances`` with KNN(k) or Hybrid(radius, max_nn) searches.

The covariance of a neighbour set is the population covariance; the normal
is its smallest eigenvector (``eigen3``), flipped so that n_z >= 0 (ties
broken on n_x), and zero below 3 neighbours.  The neighbourhoods come from
``ops/knn.knn``, whose selection is exact here.
"""

from __future__ import annotations

import torch

from . import eigen3
from . import knn as knn_ops
from ..utils.cloud import Cloud


def _neighbor_moments(points, idx, valid):
    """Mean (N, 3) and population covariance (N, 3, 3) over the valid
    neighbours points[idx] (idx, valid: (N, k))."""
    nb = points[idx]                                       # (N, k, 3)
    w = valid.to(torch.float32)[..., None]
    count = torch.clamp(torch.sum(w, dim=1), min=1.0)     # (N, 1)
    mean = torch.sum(nb * w, dim=1) / count
    centered = (nb - mean[:, None, :]) * w
    cov = torch.einsum("nki,nkj->nij", centered, centered) / count[..., None]
    return mean, cov


def _self_knn(points, mask, k: int):
    """Indices of every point's k nearest (itself first) and their validity
    from the exact d2 of the gathered coordinates."""
    _, idx = knn_ops.knn(points, points, mask, k)
    d2 = knn_ops.exact_sqdist(points[:, None, :], points[idx])
    return idx, (d2 < knn_ops.BIG) & mask[:, None]


def estimate_normals_knn(points, mask, k: int = 20):
    """KNN normals and covariances; the neighbourhood includes the query
    itself (Open3D's KNN search returns it as its own first neighbour)."""
    idx, valid = _self_knn(points, mask, k)
    return _finish_normals(points, mask, idx, valid)


def estimate_normals_hybrid(points, mask, radius: float, k: int = 20):
    """Hybrid(radius, max_nn) normals."""
    d2, idx = knn_ops.knn(points, points, mask, k)
    return _finish_normals(points, mask, idx, (d2 <= knn_ops.sq_f32(radius)) & mask[:, None])


def estimate_normals_hybrid_from_knn(points, mask, d2, idx, radius: float, k: int = 20):
    """Hybrid(radius, k) normals from a precomputed self-excluded kNN
    (``knn(..., exclude_self=True)``, >= k-1 ascending columns): the query
    itself plus its k-1 nearest within ``radius``, the set Open3D's hybrid
    search returns.  Lets ``fgr_features`` share one selection between the
    normals (k=20) and FPFH (k=200)."""
    n = points.shape[0]
    self_idx = torch.arange(n, dtype=idx.dtype, device=points.device)
    idx_k = torch.cat([self_idx[:, None], idx[:, :k - 1]], dim=1)
    d2_k = torch.cat([torch.zeros((n, 1), dtype=torch.float32, device=points.device),
                      d2[:, :k - 1]], dim=1)
    return _finish_normals(points, mask, idx_k, (d2_k <= knn_ops.sq_f32(radius)) & mask[:, None])


def _finish_normals(points, mask, idx, valid):
    _, cov = _neighbor_moments(points, idx, valid)
    enough = torch.sum(valid, dim=1) >= 3
    normals = eigen3.smallest_eigenvector(cov)
    # deterministic sign: nz >= 0, ties broken on nx
    flip = (normals[:, 2] < 0) | ((normals[:, 2] == 0) & (normals[:, 0] < 0))
    normals = torch.where(flip[:, None], -normals, normals)
    return torch.where((enough & mask)[:, None], normals, 0.0), cov


def estimate_covariances(points, mask, k: int = 30):
    """Open3D ``estimate_covariances`` default: KNN(30) neighbour covariance."""
    idx, valid = _self_knn(points, mask, k)
    return _neighbor_moments(points, idx, valid)[1]


def with_normals_knn(c: Cloud, k: int = 20) -> Cloud:
    normals, cov = estimate_normals_knn(c.points, c.mask, k)
    return Cloud(points=c.points, mask=c.mask, normals=normals, covariances=cov)


def with_normals_hybrid(c: Cloud, radius: float, k: int = 20) -> Cloud:
    normals, cov = estimate_normals_hybrid(c.points, c.mask, radius, k)
    return Cloud(points=c.points, mask=c.mask, normals=normals, covariances=cov)


def cloud_mean_and_covariance(points, mask):
    """Mean and population covariance of the whole cloud's valid points."""
    w = mask.to(torch.float32)[:, None]
    count = torch.clamp(torch.sum(w), min=1.0)
    mean = torch.sum(points * w, dim=0) / count
    centered = (points - mean) * w
    return mean, centered.T @ centered / count
