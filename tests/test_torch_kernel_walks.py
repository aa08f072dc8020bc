"""The reduction orders of kernels K1 (``pcr_tpu_torch/csrc/band_nn.cu``) and
K6 (``pcr_tpu_torch/csrc/fpfh.cu``), mirrored in torch on the CPU and held
bit for bit against their plain versions.

K1 splits each query's slab over ``kSplit`` lanes by residue: part s takes
rows s, s + kSplit, ... in ascending order (the slab is staged ``kChunk``
rows at a time, a multiple of kSplit, so the chunks do not change a part's
rows or their order) and keeps its first minimum, starting from (3e38, its
first row); a butterfly of shuffles merges the parts lexicographically on
(d2, row).  The least (d2, row) of the slab is its first minimum, so d2 and
rows must equal ``nn1_band_reference`` (``torch.min``, first minimum)
exactly, on inputs full of exact ties.

K6 sweeps the slab 32 rows a step and walks each step's kept rows from its
ballot with ``__ffs``, lowest lane first, each adding w * spfh[row] to the
33 sums.  Every feature is then summed in ascending row order, so the walk
must equal ``chip_smoke.fpfh_serial`` (a straight ascending loop, which
chip_smoke holds the kernel to on the card) bit for bit, and
``fpfh_reference`` (a batched product, another order) within chip_smoke's
2.4e-5 relative limit: 2 * 201 * 2^-24 for sums of at most ~201
nonnegative terms.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from pcr_tpu_torch.ops import preprocess
from pcr_tpu_torch.ops.kernels import common
from pcr_tpu_torch.ops.kernels import feature_kernels as fk
from pcr_tpu_torch.ops.kernels import nn_kernels as nk
from pcr_tpu_torch.utils import cloud
from tests.test_torch_bisect import _feature_tiles

CSRC = Path(fk.__file__).resolve().parents[2] / "csrc"
SPLITS = (1, 2, 4, 8, 16, 32)
TEAM = 32
V = 0.1


def _constant(source: str, name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", (CSRC / source).read_text())
    assert m is not None, name
    return int(m.group(1))


def split_first_min(d2, split: int):
    """K1's walk for every query at once: d2 (Q, S) -> (d2, slab row) of the
    merged winner."""
    q, s = d2.shape
    steps = -(-s // split)
    d = torch.cat([d2, torch.full((q, steps * split - s), float("inf"))], dim=1)
    best = torch.full((q, split), 3.0e38)
    best_j = torch.arange(split).expand(q, split).clone()
    for k in range(steps):                    # each part's rows in ascending order
        row = d[:, k * split:(k + 1) * split]
        better = row < best                   # strict: a part keeps its first minimum
        best = torch.where(better, row, best)
        best_j = torch.where(better, k * split + torch.arange(split), best_j)
    lane = torch.arange(split)
    off = split // 2
    while off:                                # the butterfly of shuffles
        od, oj = best[:, lane ^ off], best_j[:, lane ^ off]
        take = (od < best) | ((od == best) & (oj < best_j))
        best, best_j = torch.where(take, od, best), torch.where(take, oj, best_j)
        off //= 2
    assert torch.equal(best, best[:, :1].expand_as(best))   # every lane holds the winner
    return best[:, 0], best_j[:, 0]


def _tie_inputs(rng, band: int, q_tile: int, n_q: int):
    """Sorted refs on a 0.5 m lattice (many rows at equal distance from a
    query), 50 of them duplicated, then 2*band coincident sentinel rows;
    sorted queries on a 0.25 m lattice (many equidistant from two rows), 20
    of them on ref rows, and the last half tile of them sentinel rows (every
    sentinel row of their slab at d2 0); slab starts spread over the refs,
    the last tile's slab over the sentinel rows."""
    nr = 4 * band
    r = rng.integers(-6, 6, size=(nr, 3)).astype(np.float32) * 0.5
    r[nr // 2:nr // 2 + 50] = r[:50]
    q = rng.integers(-12, 12, size=(n_q, 3)).astype(np.float32) * 0.25
    q[:20] = r[:20]
    rs = torch.as_tensor(r)[torch.argsort(torch.as_tensor(r[:, 0]), stable=True)]
    rs = torch.cat([rs, torch.full((2 * band, 3), 1e6)]).contiguous()
    qs = torch.as_tensor(q)[torch.argsort(torch.as_tensor(q[:, 0]), stable=True)].contiguous()
    qs[-(q_tile // 2):] = 1e6
    n_tiles = n_q // q_tile
    starts = (torch.arange(n_tiles) * (nr // n_tiles) // band * band).to(torch.int32)
    starts[-1] = rs.shape[0] - 2 * band
    return starts, qs, rs


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("band,q_tile", [(256, 128), (1024, 256), (2048, 512)])
def test_k1_split_merge_is_first_minimum(band, q_tile, split):
    """The mirror of K1's lane-split slab and lexicographic merge gives
    ``nn1_band_reference``'s d2 and rows exactly."""
    starts, q, r = _tie_inputs(np.random.default_rng(band + split), band, q_tile, 2 * q_tile)
    d_p, i_p = nk.nn1_band_reference(starts, q, r, q_tile=q_tile, band=band)
    d2 = common.sqdist_tiles(q.view(-1, q_tile, 3), common.slabs(starts, r, band))
    d_m, j_m = split_first_min(d2.reshape(-1, 2 * band), split)
    rows = (starts.long()[:, None] + j_m.view(-1, q_tile)).reshape(-1).to(torch.int32)
    assert torch.equal(d_m, d_p) and torch.equal(rows, i_p)
    # the inputs do tie: many queries have their minimum at several slab rows
    ties = (d2 == d_p.view(d2.shape[:-1])[..., None]).sum(-1)
    assert int((ties.reshape(-1)[:-(q_tile // 2)] > 1).sum()) > q_tile // 4
    assert bool((ties.reshape(-1)[-(q_tile // 2):] == 2 * band).all())


def test_k1_constants_are_covered():
    """band_nn.cu's split is among those tested, and its staging chunk keeps
    every part's rows in step."""
    split, chunk = _constant("band_nn.cu", "kSplit"), _constant("band_nn.cu", "kChunk")
    assert split in SPLITS and chunk % split == 0


def _fpfh_inputs(case: str, q_tile: int = 128, band: int = 256):
    """(starts, q, r, tau, spfh in ref-row order) as fgr_features_sorted
    hands them to K6, from the plain K4 and K5."""
    ms, p_q, p_r, starts, _ = _feature_tiles(np.random.default_rng(23), case, q_tile, band)
    S = fk.moments_reference(starts, p_q, p_r, fk.slab_centroids(starts, p_r, band), V,
                             q_tile=q_tile, band=band)
    normals, _ = preprocess.normals_from_moments(S[:ms.shape[0]], ms)
    nq = cloud.pad_rows(normals, p_q.shape[0], 0.0).contiguous()
    nr = cloud.pad_rows(normals, p_r.shape[0], 0.0).contiguous()
    h, tau = fk.spfh_reference(starts, p_q, nq, p_r, nr, V, q_tile=q_tile, band=band)
    spfh_r = cloud.pad_rows(h[:ms.shape[0]], p_r.shape[0], 0.0).contiguous()
    return starts, p_q, p_r, tau, spfh_r


def ballot_walk_sums(starts, q, r, tau, spfh_r, q_tile: int, band: int):
    """K6's walk for every query at once: each 32-row step's kept rows taken
    from the ballot lowest lane first (``__ffs``, then the bit cleared), w =
    1 / max(d2, 1e-12) as __frcp_rn rounds it."""
    d2 = common.sqdist_tiles(q.view(-1, q_tile, 3), common.slabs(starts, r, band))
    keep = fk.pair_keep(d2, tau.view(-1, q_tile), starts, q_tile, band).reshape(-1, 2 * band)
    w = torch.reciprocal(torch.clamp(d2, min=1e-12)).reshape(-1, 2 * band)
    slab_spfh = common.slabs(starts, spfh_r, band).repeat_interleave(q_tile, dim=0)
    n_q = keep.shape[0]
    every = torch.arange(n_q)
    acc = torch.zeros(n_q, fk.FEATURE_DIM)
    for j0 in range(0, 2 * band, TEAM):
        votes = keep[:, j0:j0 + TEAM].clone()
        while bool(votes.any()):              # the same for the whole team
            live = votes.any(dim=1)
            b = torch.argmax(votes.to(torch.int8), dim=1)   # the lowest set lane
            votes[every, b] = False
            j = j0 + b
            acc = torch.where(live[:, None], acc + w[every, j, None] * slab_spfh[every, j], acc)
    return acc, keep


@pytest.mark.parametrize("q_tile,band", [(128, 256), (64, 512), (256, 128), (128, 512)])
@pytest.mark.parametrize("case", ("surface", "duplicated", "clusters"))
def test_k6_ballot_walk_sums_in_row_order(case, q_tile, band):
    """The mirror of K6's walk equals chip_smoke's serial ascending-row sums
    bit for bit, and ``fpfh_reference`` within 2.4e-5 relative; some queries
    keep rows in several steps."""
    starts, q, r, tau, spfh_r = _fpfh_inputs(case, q_tile, band)
    a_m, keep = ballot_walk_sums(starts, q, r, tau, spfh_r, q_tile, band)
    assert torch.equal(a_m, chip_smoke.fpfh_serial(starts, q, r, tau, spfh_r, q_tile, band))
    a_p = fk.fpfh_reference(starts, q, r, tau, spfh_r, q_tile=q_tile, band=band)
    assert bool(((a_m - a_p).abs() <= 2.4e-5 * a_p.abs() + 1e-7).all())
    kept = keep.sum(-1)
    assert int(kept.max()) > 2 * TEAM and bool((kept == 0).any() or case != "clusters")


def test_k6_constants_are_covered():
    """fpfh.cu's team is the mirror's."""
    assert _constant("fpfh.cu", "kTeam") == TEAM


def lazy_group_walk(q, r, splits: int, group: int):
    """K7's walk for every query at once: the refs split into ranges of
    ``nn1_split_rows(nr, splits)`` rows; in each range the groups of
    ``group`` rows in ascending order (the tail padded with +inf), the
    running minimum folded with each group's minimum and the group recorded
    when it was strictly lower; the first row of the recorded group at the
    minimum (the group's start when nothing beat 3e38); the ranges merged
    strictly (an earlier range wins ties).  Returns (d2, row)."""
    nq, nr = q.shape[0], r.shape[0]
    per_split = nk.nn1_split_rows(nr, splits)
    d_all = common.sqdist_tiles(q[None], r[None])[0]              # (nq, nr)
    best, rows = None, None
    for lo in range(0, nr, per_split):
        hi = min(nr, lo + per_split)
        n_groups = -(-(hi - lo) // group)
        d = torch.full((nq, n_groups * group), float("inf"))
        d[:, :hi - lo] = d_all[:, lo:hi]
        g_min = d.view(nq, n_groups, group).amin(dim=-1)
        b = torch.full((nq,), 3.0e38)
        bg = torch.zeros(nq, dtype=torch.long)
        for g in range(n_groups):
            m = torch.minimum(b, g_min[:, g])
            bg = torch.where(m < b, g, bg)
            b = m
        in_group = d.view(nq, n_groups, group)[torch.arange(nq), bg]    # (nq, group)
        k = torch.where(in_group == b[:, None], torch.arange(group), group).amin(dim=-1)
        row = lo + bg * group + torch.where(k < group, k, 0)
        if best is None:
            best, rows = b, row
        else:
            take = b < best
            best, rows = torch.where(take, b, best), torch.where(take, row, rows)
    return best, rows.to(torch.int32)


# (nq, nr, splits): nr below a group, nr and nq off every multiple, one range
# per 4096 rows, and the 16 ranges of chip_smoke's odd shape
K7_CASES = [(37, 5, 1), (21, 16, 1), (100, 517, 1), (129, 1000, 3), (257, 4097, 7),
            (1000, 3001, 16)]


@pytest.mark.parametrize("nq,nr,splits", K7_CASES)
def test_k7_lazy_group_walk_is_first_minimum(nq, nr, splits):
    """The mirror of K7's group walk, split ranges and merge gives
    ``nn1_reference``'s d2 and rows exactly on inputs full of ties:
    duplicated refs, lattice ties, and equal nearest refs straddling a group
    boundary, a range boundary and the last row."""
    bounds = chip_smoke.k7_tie_bounds(nr, splits)
    q_np, r_np = chip_smoke.k7_tie_inputs(nq, nr, bounds, seed=nq + nr)
    q, r = torch.as_tensor(q_np), torch.as_tensor(r_np)
    d_p, i_p = nk.nn1_reference(q, r)
    d_m, i_m = lazy_group_walk(q, r, splits, nk.NN1_GROUP)
    assert torch.equal(d_m, d_p) and torch.equal(i_m, i_p)
    ties = chip_smoke.tie_rows(nr, bounds)
    assert ties and i_m[nq - len(ties):].tolist() == [b - 1 for b in ties]
    # the inputs do tie: every boundary query, and on the larger lattices
    # many more queries, have their minimum at several rows
    d_all = common.sqdist_tiles(q[None], r[None])[0]
    tied = int(((d_all == d_p[:, None]).sum(-1) > 1).sum())
    assert tied >= len(ties) and (nr < 500 or tied > nq // 4)


def test_k7_constants_are_covered():
    """nn1.cu's geometry is the wrapper's (its launch bounds' blocks a SM are
    the resident blocks the splits fill), and its staging chunk holds whole
    groups."""
    assert (_constant("nn1.cu", "kThreads"), _constant("nn1.cu", "kQueries"),
            _constant("nn1.cu", "kGroup"), _constant("nn1.cu", "kMinBlocks")) == (
        nk.NN1_THREADS, nk.NN1_QUERIES, nk.NN1_GROUP, nk.NN1_BLOCKS_PER_SM)
    assert _constant("nn1.cu", "kChunk") % nk.NN1_GROUP == 0
