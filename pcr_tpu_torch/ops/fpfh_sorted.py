"""Gather-free stage-1 features: hybrid normals + FPFH over banded sorted
slabs (port of pcr_tpu/ops/fpfh_sorted.py, its default XLA semantics).

Sort once along the largest-extent axis, give every q_tile-row query tile
one contiguous 2*band slab of the sorted cloud, and express every
neighbourhood quantity as a reduction over the tile's slab:

  * pass 1 (kernel K4): Hybrid(2v, normal_k) moments -> normals, covariances;
  * pass 2 (kernel K5): the Hybrid(10v, max_nn) threshold tau per query and
    its SPFH histograms (Darboux pair features of the kept pairs);
  * pass 3 (kernel K6): the 1/d^2-weighted sum of the neighbours' SPFH, whose
    blocks are normalised and added to the query's own SPFH.

Neighbourhoods are ``min(k-th in-slab distance, radius)`` hybrid sets; a slab
that misses a true neighbour widens the threshold to the nearest in-slab
points instead.  Distance ties at the bisected threshold are all included.

Reference: Open3D ``compute_fpfh_feature`` with Hybrid(10*voxel, 200) and
``estimate_normals`` Hybrid(2*voxel, 20).
"""

from __future__ import annotations

import numpy as np
import torch

from . import preprocess
from .kernels import common
from .kernels import feature_kernels as fk
from ..utils import trace
from ..utils.cloud import Cloud, PAD_COORD, pad_rows, stack_clouds

N_BINS = fk.N_BINS
FEATURE_DIM = fk.FEATURE_DIM
SENTINEL = PAD_COORD
REAL_D2_MAX = common.REAL_D2_MAX


def prove_slab_placement(starts: list[int], n_pad: int, q_tile: int, band: int) -> None:
    """Raise unless every query row lies inside its own tile's slab.

    If a query's own row fell outside its slab, the self-exclusion by slab
    column would silently fail and the 1/d^2 FPFH weight of the self point
    (d^2 of f32 noise) would explode.  This is the exact condition: it
    accepts q_tile > band where the tiles still land inside their slabs."""
    n_tiles = n_pad // q_tile
    self_col = (np.arange(n_pad).reshape(n_tiles, q_tile)
                - np.asarray(starts, np.int64)[:, None])
    if self_col.size and not ((self_col >= 0).all() and (self_col < 2 * band).all()):
        raise ValueError(
            f"band slab placement broken: self_col range [{self_col.min()}, "
            f"{self_col.max()}] outside [0, {2 * band}) (n_pad={n_pad}, "
            f"q_tile={q_tile}, band={band})")


def fgr_features_sorted(c: Cloud, voxel_size: float, q_tile: int = 512, band: int = 4096,
                        normal_k: int = 20, max_nn: int = 200,
                        normals_in: torch.Tensor | None = None):
    """Banded gather-free stage-1 preprocessing.

    Returns ``(cloud, fpfh)``: ``cloud`` holds the SAME valid points in
    sorted-sweep-axis order with normals (nz >= 0 sign convention) and
    covariances, ``fpfh`` the (N, 33) features in the same order.

    ``normals_in``: optional (N, 3) normals in INPUT order, which skip the
    banded estimation (for oracle tests that need known normals).
    """
    with trace.span("features", kind="banded", rows=c.capacity):
        points, mask = c.points, c.mask
        n = points.shape[0]
        v = float(np.float32(voxel_size))
        ps, ms, p_q, p_r, starts_el = preprocess.sort_and_tile(points, mask, q_tile, band)
        n_pad, nr_pad = p_q.shape[0], p_r.shape[0]
        prove_slab_placement(preprocess.centred_slab_starts(n_pad // q_tile, q_tile, band, nr_pad),
                             n_pad, q_tile, band)

        # --- pass 1 — normals: Hybrid(2v, normal_k incl. self) moments ----------
        if normals_in is not None:
            normals = normals_in[preprocess.sweep_order(points, mask)]
            cov = torch.zeros((n, 3, 3), dtype=torch.float32, device=points.device)
        else:
            center = fk.slab_centroids(starts_el, p_r, band)
            S = fk.moments(starts_el, p_q, p_r, center, v, q_tile=q_tile, band=band,
                           normal_k=normal_k)[:n]
            normals, cov = preprocess.normals_from_moments(S, ms)

        # --- pass 2 — SPFH: Hybrid(10v, max_nn excl. self) ------------------------
        spfh_p, tau = fk.spfh(starts_el, p_q, pad_rows(normals, n_pad, 0.0).contiguous(),
                              p_r, pad_rows(normals, nr_pad, 0.0).contiguous(), v,
                              q_tile=q_tile, band=band, max_nn=max_nn)
        spfh = spfh_p[:n]

        # --- pass 3 — FPFH: 1/d^2-weighted neighbour SPFH sum ---------------------
        acc = fk.fpfh(starts_el, p_q, p_r, tau, pad_rows(spfh, nr_pad, 0.0).contiguous(),
                      q_tile=q_tile, band=band)[:n]
        blocks = acc.reshape(-1, 3, N_BINS)
        sums = torch.sum(blocks, dim=-1, keepdim=True)
        blocks = torch.where(sums > 0, blocks * (100.0 / torch.clamp(sums, min=1e-12)), 0.0)
        feat = torch.where(ms[:, None], blocks.reshape(-1, FEATURE_DIM) + spfh, 0.0)
    out = Cloud(points=torch.where(ms[:, None], ps, PAD_COORD), mask=ms,
                normals=normals, covariances=cov)
    return out, feat


def batched_fgr_features_sorted(clouds: Cloud, voxel_size: float, q_tile: int = 512,
                                band: int = 2048):
    """``fgr_features_sorted`` of every scan of a stacked Cloud (leading
    dimension B), one scan after another (kernels K4-K6 launch once a scan):
    (stacked sorted clouds with normals and covariances, (B, N, 33)
    features), for the chunked stage-1 runner."""
    out = [fgr_features_sorted(clouds[b], voxel_size, q_tile=q_tile, band=band)
           for b in range(clouds.points.shape[0])]
    return stack_clouds([c for c, _ in out]), torch.stack([f for _, f in out])
