"""Band nearest-neighbour search: sort + sweep (port of pcr_tpu/ops/band_nn.py).

  1. sort the refs along the axis of largest extent (once per index);
  2. group the queries into tiles of ``q_tile`` spatially consecutive points
     (once — the grouping may go stale under the rigid motion of an ICP loop
     without hurting correctness, since slab bounds are recomputed from the
     CURRENT coordinates on every query);
  3. each tile's candidates are ONE contiguous slab of 2*band sorted refs:
     [searchsorted(tile_min - r) rounded down to ``band``, + 2*band), unless
     that misses refs level with the tile's own queries and a slab centred
     on those holds them all;
  4. kernel K1 (``ops/kernels/nn_kernels.nn1_band``) finds every query's
     nearest slab row.

Exact while every tile's in-radius band fits in 2*band sorted rows (the
slab is then pcr_tpu's).  pcr_tpu always keeps its slab at tile_min - r;
when the in-radius band overflows, that slab loses the refs level with the
tile's upper queries, their nearest neighbours included: at a radius of
metres over a dense cloud (the doubling M-GICP's coarse scales at TLS
density) the slab can end below the tile, every query then takes a wrong
neighbour metres down the axis, and the GICP walks off.  The centred slab
keeps every level ref and loses the candidates farthest along the axis on
both sides instead.  Where even the level refs overflow the slab, no slab
holds every query's neighbours, and the slab stays pcr_tpu's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .kernels import nn_kernels
from .kernels.common import BIG, SENTINEL, axis_coord
from ..utils.cloud import pad_rows


class BandIndex(NamedTuple):
    """Sorted-ref structure + query grouping (build once per pair)."""

    r_sorted: torch.Tensor   # (Nr_pad, 3) refs sorted by axis coord (+sentinel pad)
    ra_sorted: torch.Tensor  # (Nr,) sorted axis coords (unpadded)
    r_order: torch.Tensor    # (Nr,) sort permutation into original indices
    q_order: torch.Tensor    # (Nq,) query grouping permutation
    axis: torch.Tensor       # 0-dim int64 — sweep axis


def _sq_f32(x: float) -> float:
    """x*x rounded as float32 arithmetic rounds it (the JAX package squares
    its f32 max_dist on device); a host float, so no device sync."""
    return float(np.float32(x) * np.float32(x))


def build_band_index(query, query_mask, ref, ref_mask, *, q_tile: int = 1024,
                     band: int = 2048) -> BandIndex:
    """Sort refs along the largest-extent axis; group queries by it.
    Both sorts are stable, as JAX's are."""
    rpts = torch.where(ref_mask[:, None], ref, SENTINEL)
    rmax = torch.where(ref_mask[:, None], ref, -3e38).amax(dim=0)
    rmin = torch.where(ref_mask[:, None], ref, 3e38).amin(dim=0)
    axis = torch.argmax(rmax - rmin)
    ra = axis_coord(rpts, axis)
    r_order = torch.argsort(ra, stable=True)
    return _group_queries(rpts[r_order], ra[r_order].contiguous(), r_order, axis, query,
                          query_mask, band)


def requery_band_index(index: BandIndex, query, query_mask, *, band: int) -> BandIndex:
    """``build_band_index`` of the same refs for other queries and another
    band, without sorting the refs again: their stable sort by the same keys
    gives the same order, so every field equals the full build's."""
    nr = index.ra_sorted.shape[0]
    return _group_queries(index.r_sorted[:nr], index.ra_sorted, index.r_order, index.axis,
                          query, query_mask, band)


def _group_queries(r_sorted, ra_sorted, r_order, axis, query, query_mask,
                   band: int) -> BandIndex:
    """The index of the sorted refs ``r_sorted`` (nr, 3), padded for
    ``band``, with the queries grouped by their coordinate along ``axis``."""
    qa = axis_coord(torch.where(query_mask[:, None], query, SENTINEL), axis)
    nr_pad = (-(-ra_sorted.shape[0] // band) + 1) * band
    return BandIndex(pad_rows(r_sorted, nr_pad, SENTINEL), ra_sorted, r_order,
                     torch.argsort(qa, stable=True), axis)


def slab_starts(index: BandIndex, q_sp: torch.Tensor, max_dist: float,
                 q_tile: int, band: int) -> torch.Tensor:
    """(n_tiles,) int32 element offset of each query tile's 2*band slab,
    inside the refs.  pcr_tpu's slab starts at the first sorted ref within
    max_dist of the tile's lowest query, rounded down to a band multiple.
    It is kept unless it misses some of the refs level with the tile (those
    between its lowest and highest real query along the axis) and a slab
    centred on them holds them all; then the centred slab is taken (module
    docstring).  One kernel launch on the card
    (``nn_kernels.slab_starts``)."""
    return nn_kernels.slab_starts(q_sp, index.r_sorted, index.ra_sorted, index.axis, max_dist,
                                  q_tile=q_tile, band=band)


def nn1_band_query(index: BandIndex, query, query_mask, max_dist: float, *,
                   q_tile: int = 1024, band: int = 2048):
    """Nearest ref within max_dist per query, using a prebuilt index (query
    coordinates may have moved since the build).

    Returns (exact sqdist, original ref index), both in query order;
    out-of-range -> (BIG, index of the nearest slab row).
    """
    nq = query.shape[0]
    nr = index.ra_sorted.shape[0]
    qpts = torch.where(query_mask[:, None], query, SENTINEL)
    q_s = qpts[index.q_order]                                 # (Nq, 3) grouped
    nq_pad = -(-nq // q_tile) * q_tile
    q_sp = pad_rows(q_s, nq_pad, SENTINEL).contiguous()
    starts_el = slab_starts(index, q_sp, max_dist, q_tile, band)
    _, i_sorted = nn_kernels.nn1_band(starts_el, q_sp, index.r_sorted,
                                      q_tile=q_tile, band=band)
    i_sorted = torch.clamp(i_sorted[:nq].long(), 0, nr - 1)
    diff = q_s - index.r_sorted[i_sorted]
    d_exact = torch.sum(diff * diff, dim=1)
    d_final = torch.where(d_exact <= _sq_f32(max_dist), d_exact, BIG)
    out_d = torch.empty_like(d_final)
    out_i = torch.empty(nq, dtype=torch.int64, device=query.device)
    out_d[index.q_order] = d_final
    out_i[index.q_order] = index.r_order[i_sorted]
    return out_d, out_i


def nn1_band_query_sorted(index: BandIndex, q_sorted, q_sorted_mask,
                          max_dist: float, *, q_tile: int = 1024, band: int = 2048):
    """Band query for callers that LIVE in sorted space: ``q_sorted`` is
    already grouped by ``index.q_order`` and padded to a q_tile multiple.

    Returns (sqdist, SORTED-ref row index), both in sorted query order;
    out-of-range -> (BIG, clipped row).  K1's distance is exact (the direct
    (q - r)^2), so it is returned as is: pcr_tpu's ``rescore`` pass, which
    corrects its kernel's expansion distance, has nothing to correct here.
    """
    nr = index.ra_sorted.shape[0]
    q_sp = torch.where(q_sorted_mask[:, None], q_sorted, SENTINEL).contiguous()
    starts_el = slab_starts(index, q_sp, max_dist, q_tile, band)
    d2, i_sorted = nn_kernels.nn1_band(starts_el, q_sp, index.r_sorted,
                                       q_tile=q_tile, band=band)
    i_sorted = torch.clamp(i_sorted.long(), 0, nr - 1)
    return torch.where(d2 <= _sq_f32(max_dist), d2, BIG), i_sorted


def nn1_band(query, query_mask, ref, ref_mask, max_dist: float, *,
             q_tile: int = 1024, band: int = 2048):
    """One-shot band NN (build + query)."""
    index = build_band_index(query, query_mask, ref, ref_mask, q_tile=q_tile, band=band)
    return nn1_band_query(index, query, query_mask, max_dist, q_tile=q_tile, band=band)
