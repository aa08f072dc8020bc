"""Brute-force nearest neighbours (port of pcr_tpu/ops/knn.py).

The exact k-NN ``knn_exact`` of 3-D points runs kernel K13
(``ops/kernels/nn_kernels.knn_select``, ``csrc/knn.cu``; its plain version
on CPU tensors): each row's k smallest (d2, index) keys, d2 by the exact
rounded formula, ties to the smaller index, so every returned distance is
exact and ascending.  Other widths run ``knn_tiled``, pcr_tpu's tiled
selection: candidates by the expanded distance ||q||^2 + ||r||^2 - 2 q.r,
the cross term one matmul per query tile, re-scored with the exact
(q - r)^2 and re-sorted.  Missing entries (masked or absent refs) get
d2 >= BIG.  The cross term must be a true f32 product (``pcr_tpu_torch``
sets that policy on import): FPFH values reach ~200.

The 1-NN ``nn1`` launches kernel K7 (``ops/kernels/nn_kernels.nn1``) on the
card: it scores the whole ref with the exact formula and needs no re-score.
FGR's mutual matching ``nn1_mutual`` launches kernel K11
(``nn_kernels.nn1_mutual``), which keeps the expanded formula.
``knn_approx`` keeps pcr_tpu's interface, but ``approx_min_k`` has no CUDA
form, so its selection is the exact one.
"""

from __future__ import annotations

import numpy as np
import torch

from .kernels import nn_kernels
from .kernels.common import BIG
from .kernels.common import chunk_sqdist as _chunk_sqdist
from ..utils.cloud import PAD_COORD, pad_rows

# Any exact squared distance above this is a sentinel (PAD_COORD) hit: real
# LiDAR scenes are < ~2 km across (d^2 < 4e6) while sentinel pairs are ~1e12.
SENTINEL_D2 = 1.0e10

def sq_f32(x: float) -> float:
    """x*x as float32 arithmetic rounds it (pcr_tpu squares its f32 radii on
    the device); a host float, so comparing with it needs no device sync."""
    return float(np.float32(x) * np.float32(x))


def exact_sqdist(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    d = q - r
    return torch.sum(d * d, dim=-1)


def _sort_rows(d: torch.Tensor, i: torch.Tensor):
    """Sort each row of d ascending (stable), carrying the indices along."""
    d, order = torch.sort(d, dim=1, stable=True)
    return d, torch.gather(i, 1, order)


def knn(query, ref, ref_mask, k: int, *, exclude_self: bool = False,
        method: str = "auto", **kw):
    """k-NN dispatch; see ``knn_exact`` for the output contract.

    'auto' resolves to 'exact', as pcr_tpu resolves it off the TPU; 'approx'
    is ``knn_approx``.  'band' (pcr_tpu's sorted-band self-kNN,
    ``knn_self_band``) needs ``query is ref`` and runs ``knn_exact``:
    pcr_tpu's one slab a tile misses the neighbours of sparse rows, and a
    slab widened until it holds them returns knn_exact's neighbours (ROADMAP
    F7), so its ``band``, ``recall`` and ``r_chunk`` have no effect.
    """
    if method == "band":
        if query is not ref:
            raise ValueError("band kNN requires query is ref (self-neighborhoods)")
        for name in ("band", "recall", "r_chunk"):
            kw.pop(name, None)
        method = "exact"
    if method == "auto":
        method = "exact"
    if method == "approx":
        return knn_approx(query, ref, ref_mask, k, exclude_self=exclude_self, **kw)
    if method != "exact":
        raise ValueError(f"unknown knn method {method!r}")
    return knn_exact(query, ref, ref_mask, k, exclude_self=exclude_self, **kw)


def _padded(query, ref, ref_mask, k_search: int, q_tile: int):
    """The queries padded to whole tiles; the refs and their mask padded to
    at least ``k_search`` rows (padding masked off)."""
    nr_pad = max(ref.shape[0], k_search)
    return (pad_rows(query, -(-query.shape[0] // q_tile) * q_tile, 0.0),
            pad_rows(ref, nr_pad, 0.0), pad_rows(ref_mask, nr_pad, False))


def knn_exact(query: torch.Tensor, ref: torch.Tensor, ref_mask: torch.Tensor, k: int, *,
              exclude_self: bool = False,
              q_tile: int = 512) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN of ``query`` (Nq, D) in ``ref`` (Nr, D).

    Returns (sqdists (Nq, k) ascending, indices (Nq, k) int64).  Entries
    beyond the number of valid refs get sqdist >= BIG and an in-range index;
    callers gate on distance or mask.  ``exclude_self=True`` drops the
    i == j pair (query IS ref).

    D = 3 runs K13 (``nn_kernels.knn_select``: float32, k <= ``nn_kernels.
    KNN_MAX_K``, anything else refused): ties go to the smaller index, and
    the slots past the valid refs hold the smallest masked indices.  Other
    D runs ``knn_tiled`` in ``q_tile``-row tiles.
    """
    if query.shape[-1] == 3:
        return nn_kernels.knn_select(query.contiguous(), ref.contiguous(),
                                     ref_mask.contiguous(), k, exclude_self=exclude_self)
    return knn_tiled(query, ref, ref_mask, k, exclude_self=exclude_self, q_tile=q_tile)


def knn_tiled(query: torch.Tensor, ref: torch.Tensor, ref_mask: torch.Tensor, k: int, *,
              exclude_self: bool = False,
              q_tile: int = 512) -> tuple[torch.Tensor, torch.Tensor]:
    """``knn_exact``'s selection at D != 3, any D: ``torch.topk`` of the
    expanded d2 over each (q_tile, Nr) row block, the picks re-scored
    exactly and re-sorted (stable).  Entries beyond the number of valid refs
    get sqdist >= BIG and the index of a best-effort candidate.

    pcr_tpu merges a running top-k over ref chunks; one ``torch.topk`` over
    each full (q_tile, Nr) row selects the same set.
    """
    nq = query.shape[0]
    qp, rp, rmask = _padded(query, ref, ref_mask, k, q_tile)
    col = torch.arange(rp.shape[0], device=query.device)
    d_out, i_out = [], []
    for t0 in range(0, qp.shape[0], q_tile):
        q = qp[t0:t0 + q_tile]
        d2 = torch.where(rmask[None, :], _chunk_sqdist(q, rp), BIG)
        if exclude_self:
            qidx = torch.arange(t0, t0 + q.shape[0], device=query.device)
            d2 = torch.where(col[None, :] == qidx[:, None], BIG, d2)
        best_d, best_i = torch.topk(d2, k, dim=1, largest=False, sorted=True)
        d_exact = exact_sqdist(q[:, None, :], rp[best_i])
        d, i = _sort_rows(torch.where(best_d >= BIG, BIG, d_exact), best_i)
        d_out.append(d)
        i_out.append(i)
    return torch.cat(d_out)[:nq], torch.cat(i_out)[:nq]


def knn_approx(query: torch.Tensor, ref: torch.Tensor, ref_mask: torch.Tensor, k: int, *,
               exclude_self: bool = False, q_tile: int = 2048, recall: float = 0.95,
               rescore: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """pcr_tpu's ``knn_approx`` interface with an exact selection
    (``approx_min_k`` has no CUDA form; ``recall`` has no effect).

    Masked refs are parked at PAD_COORD (the sentinel discipline) rather
    than masked to BIG; any d2 >= SENTINEL_D2 becomes BIG.  ``rescore=True``
    returns exact, ascending d2; ``rescore=False`` returns the selection's
    expanded d2, clamped at 0, as pcr_tpu does.
    """
    del recall
    nq = query.shape[0]
    k_search = k + 1 if exclude_self else k
    qp, rp, rmask = _padded(query, ref, ref_mask, k_search, q_tile)
    rp = torch.where(rmask[:, None], rp, PAD_COORD)
    rn = torch.sum(rp * rp, dim=1)
    d_out, i_out = [], []
    for t0 in range(0, qp.shape[0], q_tile):
        q = qp[t0:t0 + q_tile]
        qidx = torch.arange(t0, t0 + q.shape[0], device=query.device)
        d2 = torch.sum(q * q, dim=1, keepdim=True) + rn[None, :] - 2.0 * (q @ rp.T)
        dd, ii = torch.topk(d2, k_search, dim=1, largest=False, sorted=True)
        if not rescore:
            d, i = torch.where(dd >= SENTINEL_D2, BIG, torch.clamp(dd, min=0.0)), ii
            if exclude_self:   # push the self hit (if found) to the end, keep k
                d, pos = torch.topk(torch.where(ii == qidx[:, None], BIG, d), k, dim=1,
                                    largest=False, sorted=True)
                i = torch.gather(ii, 1, pos)
        else:
            d = exact_sqdist(q[:, None, :], rp[ii])
            drop = d >= SENTINEL_D2
            if exclude_self:
                drop |= ii == qidx[:, None]
            d, i = _sort_rows(torch.where(drop, BIG, d), ii)
            d, i = d[:, :k], i[:, :k]
        d_out.append(d)
        i_out.append(i)
    return torch.cat(d_out)[:nq], torch.cat(i_out)[:nq]


def nn1(query: torch.Tensor, ref: torch.Tensor, ref_mask: torch.Tensor, *,
        method: str = "auto", **kw) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest neighbour (k=1), the exact-correspondence hot path.

    'auto' and 'pallas' run kernel K7 (its plain version on CPU tensors):
    masked refs are parked at PAD_COORD and a d2 >= SENTINEL_D2 (no real
    ref) becomes BIG.  'exact' runs the tiled ``nn1_exact``.  Returns (exact
    sqdist (Nq,), index (Nq,) int64).
    """
    if method in ("auto", "pallas"):
        rp = torch.where(ref_mask[:, None], ref, PAD_COORD).contiguous()
        d, i = nn_kernels.nn1(query.contiguous(), rp)
        return torch.where(d >= SENTINEL_D2, BIG, d), i.long()
    if method != "exact":
        raise ValueError(f"unknown nn1 method {method!r}")
    return nn1_exact(query, ref, ref_mask, **kw)


def nn1_exact(query: torch.Tensor, ref: torch.Tensor, ref_mask: torch.Tensor, *,
              q_tile: int = 1024, r_chunk: int = 8192) -> tuple[torch.Tensor, torch.Tensor]:
    """Tiled-merge nearest neighbour (k=1) for any D: select by the expanded
    d2 over ``r_chunk``-wide ref chunks (a later chunk wins only when
    strictly closer), then re-score the winner exactly.  Returns (sqdist
    (Nq,), index (Nq,) int64); no valid ref -> (BIG, 0)."""
    nq, nr = query.shape[0], ref.shape[0]
    qp = pad_rows(query, -(-nq // q_tile) * q_tile, 0.0)
    d_out, i_out = [], []
    for t0 in range(0, qp.shape[0], q_tile):
        q = qp[t0:t0 + q_tile]
        best_d = torch.full((q.shape[0],), BIG, dtype=torch.float32, device=query.device)
        best_i = torch.zeros(q.shape[0], dtype=torch.int64, device=query.device)
        for c0 in range(0, nr, r_chunk):
            d2 = torch.where(ref_mask[None, c0:c0 + r_chunk],
                             _chunk_sqdist(q, ref[c0:c0 + r_chunk]), BIG)
            cd, ci = torch.min(d2, dim=1)
            take = cd < best_d
            best_d = torch.where(take, cd, best_d)
            best_i = torch.where(take, ci + c0, best_i)
        d_exact = exact_sqdist(q, ref[best_i])
        d_out.append(torch.where(best_d >= BIG, BIG, d_exact))
        i_out.append(best_i)
    return torch.cat(d_out)[:nq], torch.cat(i_out)[:nq]


def nn1_mutual(a: torch.Tensor, a_mask: torch.Tensor, b: torch.Tensor,
               b_mask: torch.Tensor, *, q_tile: int = 2048):
    """a->b and b->a exact nearest-neighbour indices in one sweep over the
    (Na, Nb) distances (FGR's mutual matching): kernel K11
    (``ops/kernels/nn_kernels.nn1_mutual``) on CUDA tensors, its plain
    version, a loop over (q_tile, Nb) tiles, on CPU ones.

    d2 is the expanded formula; ties go to the smallest index among the
    equal minimal d2.  Returns (ij (Na,), ji (Nb,)) int64; rows with no
    valid partner get index 0 — callers gate on their own masks.
    ``q_tile`` sets the plain version's tiles (the kernel's are its own);
    the kernel takes 33-dim rows (FPFH) and refuses others.
    """
    ij, ji = nn_kernels.nn1_mutual(a.contiguous(), a_mask.contiguous(), b.contiguous(),
                                   b_mask.contiguous(), q_tile=q_tile)
    return ij.long(), ji.long()


def hybrid(query, ref, ref_mask, k: int, radius: float, **kw):
    """KDTreeSearchParamHybrid semantics: the k nearest within ``radius``;
    neighbours beyond it are flagged invalid.  Returns (sqdists, indices,
    valid), each (Nq, k)."""
    d, i = knn(query, ref, ref_mask, k, **kw)
    return d, i, d <= sq_f32(radius)
