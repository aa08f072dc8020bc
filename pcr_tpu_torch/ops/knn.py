"""Tiled brute-force nearest neighbours over feature vectors (port of the
part of pcr_tpu/ops/knn.py that stage 1 runs: ``nn1_mutual``).

Distances are ||q||^2 + ||r||^2 - 2 q.r with the cross term as one matmul per
query tile.  It must be a true f32 product (``pcr_tpu_torch`` sets that
policy on import): FPFH values reach ~200, and TF32 would reorder matches.
"""

from __future__ import annotations

import torch

from ..utils.cloud import pad_rows

BIG = 3.0e38
# Any exact squared distance above this is a sentinel (PAD_COORD) hit: real
# LiDAR scenes are < ~2 km across (d^2 < 4e6) while sentinel pairs are ~1e12.
SENTINEL_D2 = 1.0e10


def _chunk_sqdist(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """(Tq, D) x (C, D) -> (Tq, C) squared distances via one matmul."""
    qn = torch.sum(q * q, dim=-1, keepdim=True)
    rn = torch.sum(r * r, dim=-1)
    return torch.clamp(qn + rn[None, :] - 2.0 * (q @ r.T), min=0.0)


def nn1_mutual(a: torch.Tensor, a_mask: torch.Tensor, b: torch.Tensor,
               b_mask: torch.Tensor, *, q_tile: int = 2048):
    """a->b and b->a exact nearest-neighbour indices from ONE sweep over the
    (q_tile, Nb) distance tiles: each tile gives its rows' argmin (a->b) and
    updates a carried column minimum (b->a).

    Ties: the first index inside a tile, and a later tile replaces the
    carried column minimum only when strictly smaller.  Returns (ij (Na,),
    ji (Nb,)) int64; rows with no valid partner get index 0 — callers gate on
    their own masks.
    """
    na, nb = a.shape[0], b.shape[0]
    na_pad = -(-na // q_tile) * q_tile
    ap = pad_rows(a, na_pad, 0.0)
    amask = pad_rows(a_mask, na_pad, False)
    col_d = torch.full((nb,), BIG, dtype=torch.float32, device=a.device)
    col_i = torch.zeros(nb, dtype=torch.int64, device=a.device)
    rows = []
    for t0 in range(0, na_pad, q_tile):
        d2 = _chunk_sqdist(ap[t0:t0 + q_tile], b)
        d2 = torch.where(amask[t0:t0 + q_tile, None] & b_mask[None, :], d2, BIG)
        rows.append(torch.argmin(d2, dim=1))
        cmin, carg = torch.min(d2, dim=0)
        take = cmin < col_d
        col_d = torch.where(take, cmin, col_d)
        col_i = torch.where(take, carg + t0, col_i)
    return torch.cat(rows)[:na], col_i
