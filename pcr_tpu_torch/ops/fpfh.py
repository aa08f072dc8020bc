"""Fast Point Feature Histograms over k-NN neighbour lists (port of
pcr_tpu/ops/fpfh.py): Open3D's ``compute_fpfh_feature`` with a
Hybrid(radius, max_nn) search.

Open3D's two passes:
  1. SPFH: for each point p and each neighbour q != p, the Darboux pair
     features (f1 = v . n_t, f2 = u . d/|d|, f3 = atan2(w . n_t, u . n_t))
     accumulated into three 11-bin histograms (33 values), each increment
     100 / (number of neighbours);
  2. FPFH: fpfh_p = spfh_p + normalize(sum_q spfh_q / |p - q|^2), the
     weighted neighbour sum renormalised per 11-bin block to sum to 100.

Both passes gather the neighbours' rows in chunks of ``nb_chunk`` columns,
the form pcr_tpu runs off the TPU (its TPU path replaces pass 2 by a dense
tiled matmul, ``_weighted_spfh_matmul``, only because row gathers are slow
there; that XLA form is not ported).
"""

from __future__ import annotations

import math

import torch

from . import knn as knn_ops

N_BINS = 11
FEATURE_DIM = 33


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=1e-12)


def _pair_features(p, n_p, q, n_q):
    """Darboux-frame pair features of p, n_p (N, 3) with q, n_q (N, K, 3):
    (f1, f2, f3, dist), each (N, K).  As Open3D's ComputePairFeatures, the
    point whose normal makes the smaller angle with the connecting line is
    the source."""
    d = q - p[:, None, :]
    dist = torch.linalg.norm(d, dim=-1)
    dn = d / torch.clamp(dist[..., None], min=1e-12)
    n1 = n_p[:, None, :].expand(q.shape)
    a1 = torch.sum(n1 * dn, dim=-1)
    a2 = torch.sum(n_q * dn, dim=-1)
    swap = (a2.abs() > a1.abs())[..., None]
    u = torch.where(swap, n_q, n1)
    nt = torch.where(swap, n1, n_q)
    dn_eff = torch.where(swap, -dn, dn)
    f2 = torch.sum(u * dn_eff, dim=-1)
    v = _unit(torch.linalg.cross(dn_eff, u, dim=-1))
    w = torch.linalg.cross(u, v, dim=-1)
    f1 = torch.sum(v * nt, dim=-1)
    f3 = torch.atan2(torch.sum(w * nt, dim=-1), torch.sum(u * nt, dim=-1))
    return f1, f2, f3, dist


def _hist_accumulate(f, lo: float, hi: float, weights):
    """(N, K) features -> (N, 11) weighted histograms: floor binning
    clipped to 0..10."""
    bins = torch.clamp(torch.floor(N_BINS * (f - lo) / (hi - lo)).to(torch.int64), 0, N_BINS - 1)
    onehot = torch.nn.functional.one_hot(bins, N_BINS).to(torch.float32)
    return torch.einsum("nk,nkb->nb", weights, onehot)


def fpfh(points: torch.Tensor, normals: torch.Tensor, mask: torch.Tensor, radius: float,
         max_nn: int = 200, nb_chunk: int = 25, knn_result=None) -> torch.Tensor:
    """(N, 33) FPFH features over Hybrid(radius, max_nn) neighbourhoods.

    ``knn_result``: an optional precomputed self-kNN ``(d2, idx)`` with
    exclude_self=True and >= max_nn ascending columns (``fgr_features``
    shares one selection between the normals and FPFH).  Both passes run
    over neighbour chunks of ``nb_chunk`` columns, so the temporaries are
    O(N * nb_chunk).
    """
    if max_nn % nb_chunk:
        raise ValueError(f"max_nn {max_nn} is not a multiple of nb_chunk {nb_chunk}")
    n = points.shape[0]
    if knn_result is None:
        d2, idx = knn_ops.knn(points, points, mask, max_nn, exclude_self=True)
    else:
        d2, idx = knn_result[0][:, :max_nn], knn_result[1][:, :max_nn]
    w = ((d2 <= knn_ops.sq_f32(radius)) & mask[:, None] & (d2 < knn_ops.BIG)).to(torch.float32)
    counts = torch.sum(w, dim=1)
    hist_incr = torch.where(counts > 0, 100.0 / torch.clamp(counts, min=1.0), 0.0)

    pn = torch.cat([points, normals], dim=1)
    spfh = torch.zeros((n, FEATURE_DIM), dtype=torch.float32, device=points.device)
    for c0 in range(0, max_nn, nb_chunk):
        nb = pn[idx[:, c0:c0 + nb_chunk]]
        f1, f2, f3, _ = _pair_features(points, normals, nb[..., :3], nb[..., 3:])
        wh = w[:, c0:c0 + nb_chunk] * hist_incr[:, None]
        spfh = spfh + torch.cat([_hist_accumulate(f1, -1.0, 1.0, wh),
                                 _hist_accumulate(f2, -1.0, 1.0, wh),
                                 _hist_accumulate(f3, -math.pi, math.pi, wh)], dim=1)

    # pass 2: the 1/d^2-weighted neighbour SPFH sum
    acc = torch.zeros((n, FEATURE_DIM), dtype=torch.float32, device=points.device)
    for c0 in range(0, max_nn, nb_chunk):
        w_k, d2_k = w[:, c0:c0 + nb_chunk], d2[:, c0:c0 + nb_chunk]
        inv = torch.where((w_k > 0) & (d2_k > 0), 1.0 / torch.clamp(d2_k, min=1e-12), 0.0)
        acc = acc + torch.einsum("nk,nkf->nf", inv, spfh[idx[:, c0:c0 + nb_chunk]])
    # per-11-bin-block renormalisation to 100 (Open3D's sum[j/11] scheme)
    blocks = acc.reshape(-1, 3, N_BINS)
    sums = torch.sum(blocks, dim=-1, keepdim=True)
    blocks = torch.where(sums > 0, blocks * (100.0 / torch.clamp(sums, min=1e-12)), 0.0)
    return torch.where(mask[:, None], blocks.reshape(-1, FEATURE_DIM) + spfh, 0.0)
