"""Spatial hash-grid nearest neighbour within a radius (port of
pcr_tpu/ops/grid_nn.py).

For the radius-bounded correspondence search (the nearest neighbour within
max_dist, Open3D's registration semantics) a hash grid whose cells are at
least max_dist wide is exact: every point within max_dist of a query lies in
one of the 27 cells around the query's cell, so a query scores 27 * k_cap
candidates instead of the whole cloud.

Fixed shapes, as in pcr_tpu:
  * bucket = hash(cell) & (table_size - 1); collisions only add candidates
    (each is scored exactly), never lose one;
  * the points are stably argsorted by bucket, and two searchsorteds over
    the table give every bucket's [start, end) rows;
  * a query gathers up to ``k_cap`` rows of each of its 27 buckets: a bucket
    holding more is cut to its first k_cap sorted rows (the only
    approximation).

The grid is built once per (target, scale) and queried every Gauss-Newton
iteration.  Everything stays on the device of the inputs: no host read.
pcr_tpu's int32 hash wraps; here it is computed in int64 and masked, which
keeps the same low bits, so the buckets are the same.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import knn as knn_ops
from ..utils.cloud import pad_rows

BIG = 3.0e38

_P1, _P2, _P3 = 73856093, 19349663, 83492791  # the standard spatial-hash primes
# the 27 neighbour cells in pcr_tpu's order: dx outermost, dz innermost
_OFFSETS = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)]


class HashGrid(NamedTuple):
    points_sorted: torch.Tensor  # (N, 3) points ordered by bucket
    orig_idx: torch.Tensor       # (N,) int64 original indices
    starts: torch.Tensor         # (H,) first row of each bucket
    ends: torch.Tensor           # (H,) one past the last row
    cell_size: torch.Tensor      # 0-dim f32, on the points' device
    origin: torch.Tensor         # (3,) grid origin (min corner of the valid points)


def _cells(p: torch.Tensor, origin: torch.Tensor, cell_size: torch.Tensor) -> torch.Tensor:
    """floor((p - origin) / cell_size) as int64.  ``cell_size`` is a device
    tensor: a true f32 division, as pcr_tpu's (a host scalar divisor would
    let the card multiply by its reciprocal, which rounds differently)."""
    return torch.floor((p - origin) / cell_size).to(torch.int64)


def _bucket_of(cells: torch.Tensor, table_size: int) -> torch.Tensor:
    h = (cells[..., 0] * _P1) ^ (cells[..., 1] * _P2) ^ (cells[..., 2] * _P3)
    return h & (table_size - 1)


def build_grid(points: torch.Tensor, mask: torch.Tensor, cell_size,
               table_size: int = 1 << 17) -> HashGrid:
    """Hash grid over the valid points; invalid points are parked in a far
    cell and take bucket ``table_size``, so they sort last, outside every
    bucket."""
    dev = points.device
    cell = torch.tensor(float(cell_size), dtype=torch.float32, device=dev)
    origin = torch.where(mask[:, None], points, BIG).amin(dim=0)
    cells = torch.where(mask[:, None], _cells(points, origin, cell), 1 << 28)
    bucket = torch.where(mask, _bucket_of(cells, table_size), table_size)
    order = torch.argsort(bucket, stable=True)
    bucket_sorted = bucket[order].contiguous()
    arange_h = torch.arange(table_size, dtype=torch.int64, device=dev)
    starts = torch.searchsorted(bucket_sorted, arange_h, right=False)
    ends = torch.searchsorted(bucket_sorted, arange_h, right=True)
    return HashGrid(points[order], order, starts, ends, cell, origin)


def nn1_grid(grid: HashGrid, query: torch.Tensor, max_dist, *, k_cap: int = 32,
             q_tile: int = 4096, table_size: int = 1 << 17):
    """Nearest neighbour within max_dist of each query point.

    Exact while grid.cell_size >= max_dist.  Returns (exact sqdist (Nq,),
    original ref index (Nq,) int64).  As in pcr_tpu, the winner is the first
    strict minimum over the 27 cells in ``_OFFSETS`` order and the first row
    within a cell; a query with no candidate gets (BIG, orig_idx[0]), and
    one whose nearest candidate lies beyond max_dist gets BIG and keeps that
    candidate's index.  A query tile gathers all 27 cells at once: one
    (q_tile, 27 * k_cap) candidate block.
    """
    dev = query.device
    nq = query.shape[0]
    n = grid.points_sorted.shape[0]
    qp = pad_rows(query, -(-nq // q_tile) * q_tile, 0.0)
    max_d2 = knn_ops.sq_f32(max_dist)
    offsets = torch.tensor(_OFFSETS, dtype=torch.int64, device=dev)      # (27, 3)
    lanes = torch.arange(k_cap, dtype=torch.int64, device=dev)
    d_out, i_out = [], []
    for t0 in range(0, qp.shape[0], q_tile):
        q = qp[t0:t0 + q_tile]
        b = _bucket_of(_cells(q, grid.origin, grid.cell_size)[:, None, :] + offsets,
                       table_size)                                     # (TQ, 27)
        rows = grid.starts[b][..., None] + lanes                        # (TQ, 27, k_cap)
        valid = rows < grid.ends[b][..., None]
        rows = torch.clamp(rows, max=n - 1).reshape(q.shape[0], -1)
        diff = q[:, None, :] - grid.points_sorted[rows]                # (TQ, 27 k_cap, 3)
        dx, dy, dz = diff.unbind(-1)
        d2 = (dx * dx + dy * dy) + dz * dz          # pcr_tpu's summation order
        d2 = torch.where(valid.reshape(q.shape[0], -1), d2, BIG)
        best_d, pos = torch.min(d2, dim=1)          # the first minimum in offset order
        best_i = torch.where(best_d < BIG, rows.gather(1, pos[:, None])[:, 0], 0)
        d_out.append(torch.where(best_d <= max_d2, best_d, BIG))
        i_out.append(grid.orig_idx[best_i])
    return torch.cat(d_out)[:nq], torch.cat(i_out)[:nq]
