"""Fused per-scale preprocessing: voxel downsample -> statistical outlier
removal -> kNN normal estimation (port of pcr_tpu/ops/preprocess.py, the
``spacing_hint`` branch).

Every quantity the chain needs is a neighbourhood reduction over a slab of
the sorted cloud, so no neighbour lists are built:

  * pass 1 (kernel K2): mean distance to the nb_neighbors nearest (self
    excluded) = sum(sqrt(d2) * [d2 <= tau]) / (count - 1), with tau from a
    log-space count bisection over [0.05*hint, 100*hint];
  * the mu + std_ratio*sigma gate over the found points;
  * pass 2 (kernel K3): first and second moments of the ``normal_k`` nearest
    survivors, centred on each tile's slab centroid, whence the covariances
    and normals.

One tiling for both passes: q_tile-row query tiles whose 2*band slab is
centred on the tile, computed once here and handed to both the kernels and
their plain versions.  The output cloud is in sorted-sweep-axis order.
"""

from __future__ import annotations

import torch

from . import eigen3
from . import voxel as voxel_ops
from .kernels import feature_kernels
from ..utils.cloud import Cloud, PAD_COORD, pad_rows

def centred_slab_starts(n_tiles: int, q_tile: int, band: int, nr_pad: int) -> list[int]:
    """Slab start of every tile (element offset), centred on the tile and
    clipped into [0, nr_pad - 2*band] — pcr_tpu/ops/preprocess.py:211-214
    and pcr_tpu/ops/fpfh_sorted.py:221-224.  Host ints: the placement
    depends on the shapes alone."""
    max_blk = max(nr_pad // band - 2, 0)
    return [min(max((t * q_tile - (2 * band - q_tile) // 2) // band, 0), max_blk) * band
            for t in range(n_tiles)]


def sweep_order(points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Stable sort order of the points (padding at PAD_COORD) along the axis
    of largest valid extent."""
    n = points.shape[0]
    p = torch.where(mask[:, None], points, PAD_COORD)
    pmax = torch.where(mask[:, None], points, -3e38).amax(dim=0)
    pmin = torch.where(mask[:, None], points, 3e38).amin(dim=0)
    axis = torch.argmax(pmax - pmin)
    pa = p.gather(1, axis.view(1, 1).expand(n, 1))[:, 0]
    return torch.argsort(pa, stable=True)


def sort_and_tile(points: torch.Tensor, mask: torch.Tensor, q_tile: int, band: int):
    """One stable sort along the largest-extent axis, then the tiling both
    passes share.  Returns (ps, ms, p_q, p_r, starts_el): the sorted points
    (padding at PAD_COORD) and mask, the points padded to whole query tiles
    and to the slab-padded ref rows, and each tile's slab start."""
    n = points.shape[0]
    order = sweep_order(points, mask)
    ps = torch.where(mask[:, None], points, PAD_COORD)[order]
    n_pad = -(-n // q_tile) * q_tile
    nr_pad = (-(-n // band) + 1) * band
    starts = centred_slab_starts(n_pad // q_tile, q_tile, band, nr_pad)
    return (ps, mask[order], pad_rows(ps, n_pad, PAD_COORD), pad_rows(ps, nr_pad, PAD_COORD),
            torch.tensor(starts, dtype=torch.int32, device=points.device))


def normals_from_moments(S: torch.Tensor, mask: torch.Tensor):
    """(normals (n, 3), cov (n, 3, 3)) from neighbourhood moments
    S = [sum x | sum y | sum z | xx xy xz yy yz zz | count] (n, 10), with the
    nz >= 0 sign convention of ops/normals; rows with fewer than 3
    neighbours or off the mask get zero normals."""
    cnt = torch.clamp(S[:, 9], min=1.0)
    m1 = S[:, 0:3] / cnt[:, None]                         # E[x] (centred frame)
    xx = S[:, 3], S[:, 4], S[:, 5], S[:, 6], S[:, 7], S[:, 8]
    exx = torch.stack(
        [torch.stack([xx[0], xx[1], xx[2]], dim=-1),
         torch.stack([xx[1], xx[3], xx[4]], dim=-1),
         torch.stack([xx[2], xx[4], xx[5]], dim=-1)],
        dim=-2,
    ) / cnt[:, None, None]                                # E[xx^T]
    cov = exx - m1[:, :, None] * m1[:, None, :]
    enough = S[:, 9] >= 3
    normals = eigen3.smallest_eigenvector(cov)
    flip = (normals[:, 2] < 0) | ((normals[:, 2] == 0) & (normals[:, 0] < 0))
    normals = torch.where(flip[:, None], -normals, normals)
    return torch.where((enough & mask)[:, None], normals, 0.0), cov


def outlier_and_normals_sorted(
    points: torch.Tensor,
    mask: torch.Tensor,
    nb_neighbors: int = 30,
    std_ratio: float = 1.0,
    normal_k: int = 20,
    q_tile: int = 1024,
    band: int = 2048,
    spacing_hint: float | None = None,
) -> Cloud:
    """Fused outlier removal + normals.  Returns a Cloud whose rows are the
    input's rows in sorted-sweep-axis order (removed rows masked off).

    ``spacing_hint`` (the cloud's voxel size) is required: it bounds the
    pass-1 bisection.  Points lacking nb_neighbors+1 slab neighbours within
    100*hint are dropped and excluded from the mu/sigma statistics.
    """
    if spacing_hint is None or not spacing_hint > 0:
        raise ValueError(f"spacing_hint must be > 0, got {spacing_hint}")
    n = points.shape[0]
    ps, ms, p_q, p_r, starts_el = sort_and_tile(points, mask, q_tile, band)
    nr_pad = p_r.shape[0]

    # --- pass 1: outlier statistics -----------------------------------------
    mean_d_p, found_p, tau_p = feature_kernels.outlier_stats(
        starts_el, p_q, p_r, spacing_hint, q_tile=q_tile, band=band,
        k1=nb_neighbors + 1)
    mean_d, found = mean_d_p[:n], found_p[:n]
    stat = ms & found
    wv = stat.to(torch.float32)
    n_valid = torch.clamp(torch.sum(wv), min=1.0)
    mu = torch.sum(mean_d * wv) / n_valid
    var = torch.sum((mean_d - mu) ** 2 * wv) / torch.clamp(n_valid - 1.0, min=1.0)
    keep = stat & (mean_d <= mu + std_ratio * torch.sqrt(var))

    # --- pass 2: moments of the normal_k nearest survivors -------------------
    keep_r = pad_rows(keep, nr_pad, False)
    center = feature_kernels.slab_centroids(starts_el, p_r, band)
    S = feature_kernels.survivor_moments(
        starts_el, p_q, p_r, keep_r, tau_p, center, q_tile=q_tile, band=band,
        normal_k=normal_k)[:n]
    normals, cov = normals_from_moments(S, keep)
    pts_out = torch.where(keep[:, None], ps, PAD_COORD)
    return Cloud(points=pts_out, mask=keep, normals=normals, covariances=cov)


def _band_width(capacity: int) -> int:
    """Capacity-scaled band: the neighbourhoods are 30-NN / 20-NN (a few
    voxels across), so capacity/16 rows either side of a tile is still far
    wider than any neighbourhood, and the band multiplies every bisection
    step.  Rounded to 256, within [256, 1024]."""
    return min(1024, max(256, -(-(capacity // 16) // 256) * 256))


def preprocess_scale_fused(
    c: Cloud,
    voxel_size: float,
    scale_capacity: int | None = None,
    nb_neighbors: int = 30,
    std_ratio: float = 1.0,
    normal_k: int = 20,
) -> Cloud:
    """Voxel downsample -> fused outlier + normals (sorted-order output)."""
    if not voxel_size > 0.0:
        raise ValueError(f"voxel_size must be > 0, got {voxel_size}")
    d = voxel_ops.voxel_downsample_cloud(c, voxel_size)
    if scale_capacity is not None and scale_capacity < d.capacity:
        # voxel output is prefix-compact (valid rows first): a slice suffices
        d = Cloud(points=d.points[:scale_capacity], mask=d.mask[:scale_capacity])
    return outlier_and_normals_sorted(
        d.points, d.mask, nb_neighbors, std_ratio, normal_k, band=_band_width(d.capacity),
        spacing_hint=float(voxel_size))
