"""The multi-level bisection walk of kernels K2 and K3
(``pcr_tpu_torch/csrc/preprocess.cu``) and K4 and K5
(``pcr_tpu_torch/csrc/fpfh.cu``), and K5's compacted consumer, mirrored in
torch on the CPU and held bit for bit against their plain versions.

A pass of the kernel counts the slab against the 2^m - 1 thresholds of the
next m levels of the bisection tree (heap order, each the midpoint
0.5 * (lo + hi) of the serial walk, exp of it in log space), then walks those
m levels from the counts.  A row that does not count (a sentinel pair, a
non-survivor) has d2 = NaN; the sentinel test is left out where every
threshold lies below ``REAL_D2_MAX``.  The mirror below does the same
operations in f32 in the same order, so tau must be bit-equal
(``torch.equal``) to ``feature_kernels._log_bisect`` (K2, K4, K5) and to
K3's linear loop, whose counts ``survivor_moments_reference`` returns.

K5's consumer sweeps the slab 32 rows a step (one a lane), compacts the
kept rows of a step behind those still waiting in the team's list (ballot
and popcount prefix), and whenever 32 wait, evaluates them one a lane and
adds 1 to three integer bins; what is left is evaluated after the sweep.
The mirror does the same with tensors, every query at once, and must give
``spfh_reference``'s histograms exactly.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from pcr_tpu_torch.ops import preprocess
from pcr_tpu_torch.ops.kernels import common
from pcr_tpu_torch.ops.kernels import feature_kernels as fk
from pcr_tpu_torch.utils import cloud

STEPS = fk.BISECT_STEPS
LEVELS = (1, 2, 3, 4, 5)       # 10 % 3 and 10 % 4 leave a shorter last pass
CASES = ("surface", "ties", "sparse", "k1")
H = 0.2                        # spacing hint (voxel size)
CSRC = Path(fk.__file__).resolve().parents[2] / "csrc"
V = 0.1                        # voxel size of the feature kernels' cases
FEATURE_KERNELS = {"k4": (20, 2.0), "k5": (201, 10.0)}   # k, top bound in voxels
FEATURE_CASES = ("surface", "sparse", "duplicated")
TEAM = 32


def subtree_mids(lo, hi, r: int):
    """(..., 2^r - 1) thresholds of the r levels below (lo, hi), heap order."""
    m = (1 << r) - 1
    nlo, nhi, mid = [None] * m, [None] * m, [None] * m
    nlo[0], nhi[0] = lo, hi
    for n in range(m):
        mid[n] = 0.5 * (nlo[n] + nhi[n])
        if 2 * n + 2 < m:
            nlo[2 * n + 1], nhi[2 * n + 1] = nlo[n], mid[n]
            nlo[2 * n + 2], nhi[2 * n + 2] = mid[n], nhi[n]
    return torch.stack(mid, dim=-1)


def multilevel_bisect(d2, counted, k: int, lo, hi, levels: int, log: bool):
    """The kernel's walk: ceil(10 / levels) passes, each counting NaN-masked
    d2 (..., S) against 2^r - 1 thresholds and walking r levels.  Returns
    the final (lo, hi)."""
    dn = torch.where(counted, d2, float("nan"))
    done = 0
    while done < STEPS:
        r = min(levels, STEPS - done)
        mid = subtree_mids(lo, hi, r)
        t = torch.exp(mid) if log else mid
        cnt = torch.sum(dn[..., None, :] <= t[..., None], dim=-1)
        n = torch.zeros(lo.shape, dtype=torch.long)
        for _ in range(r):
            c = cnt.gather(-1, n[..., None])[..., 0]
            m = mid.gather(-1, n[..., None])[..., 0]
            geq = c >= k
            lo, hi = torch.where(geq, lo, m), torch.where(geq, m, hi)
            n = torch.where(geq, 2 * n + 1, 2 * n + 2)
        done += r
    return lo, hi


def serial_linear(d2, counted, k: int, hi):
    """K3's serial linear bisection on [0, hi], as survivor_moments_reference
    runs it."""
    lo = torch.zeros_like(hi)
    for _ in range(STEPS):
        mid = 0.5 * (lo + hi)
        geq = torch.sum(counted & (d2 <= mid[..., None]), dim=-1) >= k
        lo, hi = torch.where(geq, lo, mid), torch.where(geq, mid, hi)
    return hi


def _surface_tiles(rng, n=900, cap=1024, q_tile=128, band=256):
    """Sorted tiles of a bumpy patch whose rows 100-149 duplicate rows 0-49
    (exact d2 ties) and whose slabs end in PAD_COORD sentinel rows."""
    pts = rng.uniform(-2, 2, size=(n, 3)).astype(np.float32)
    pts[:, 2] = 0.1 * np.sin(2 * pts[:, 0]) + 0.05 * pts[:, 1]
    pts[100:150] = pts[:50]
    c = cloud.from_numpy(pts, cap, device="cpu")
    _, ms, p_q, p_r, starts = preprocess.sort_and_tile(c.points, c.mask, q_tile, band)
    d2 = common.sqdist_tiles(p_q.view(-1, q_tile, 3), common.slabs(starts, p_r, band))
    return ms, p_q, p_r, starts, d2


def _case(rng, case: str, log: bool):
    """(d2 (Q, S), real (Q, S), k, lo (Q,), hi (Q,)) for one test case."""
    if log:
        lo_f, hi_f = fk._log_bounds(H, 0.05, 100.0)
    if case in ("surface", "k1"):
        d2 = _surface_tiles(rng)[-1].reshape(-1, 512)
        k = 1 if case == "k1" else (31 if log else 20)
    else:
        q, s = 48, 384
        if log:
            lo0, hi0 = torch.full((q,), lo_f), torch.full((q,), hi_f)
            tree = torch.exp(subtree_mids(lo0, hi0, STEPS))
        else:
            hi0 = 4.0 * torch.as_tensor(rng.uniform(0.01, 0.5, q), dtype=torch.float32) + 1e-6
            tree = subtree_mids(torch.zeros(q), hi0, STEPS)
        if case == "ties":       # every d2 exactly at a threshold, many repeated
            pick = torch.as_tensor(rng.integers(0, tree.shape[-1], (q, s)))
            d2 = tree.gather(-1, pick)
            d2[:, s // 2:] = d2[:, :s // 2]
            k = 8
        else:                    # sparse: fewer than k real rows
            d2 = torch.as_tensor(rng.uniform(0, 0.5, (q, s)), dtype=torch.float32)
            d2[:, 12:] = 3.0e12
            k = 31 if log else 20
    real = d2 < common.REAL_D2_MAX
    if log:
        return d2, real, k, torch.full(d2.shape[:-1], lo_f), torch.full(d2.shape[:-1], hi_f)
    if case in ("surface", "k1"):
        hi0 = 4.0 * fk._log_bisect(d2, real, 31, *fk._log_bounds(H, 0.05, 100.0)) + 1e-6
    return d2, real, k, torch.zeros_like(hi0), hi0


@pytest.mark.parametrize("levels", LEVELS)
@pytest.mark.parametrize("case", CASES)
def test_multilevel_log_walk_matches_serial(case, levels):
    """K2's walk (log space, one tree for every query): tau bit-equal to
    ``_log_bisect``, and the sentinel test may be left out because every
    threshold is below REAL_D2_MAX."""
    d2, real, k, lo, hi = _case(np.random.default_rng(7), case, log=True)
    tau_serial = fk._log_bisect(d2, real, k, float(lo[0]), float(hi[0]))
    assert math.exp(float(hi[0])) < common.REAL_D2_MAX
    everything = torch.ones_like(real)
    for counted in (real, everything):
        _, lhi = multilevel_bisect(d2, counted, k, lo, hi, levels, log=True)
        assert torch.equal(torch.exp(lhi), tau_serial)
    found = torch.sum(real & (d2 <= tau_serial[..., None]), dim=-1) >= k
    if case == "sparse":
        assert not bool(found.any())
        assert torch.equal(tau_serial, torch.exp(hi))
    else:
        assert bool(found.any())


@pytest.mark.parametrize("levels", LEVELS)
@pytest.mark.parametrize("case", CASES)
def test_multilevel_linear_walk_matches_serial(case, levels):
    """K3's walk (linear, one tree per query from [0, 4*tau + 1e-6]): tau
    bit-equal to the serial loop, with or without the sentinel test."""
    d2, real, k, lo, hi = _case(np.random.default_rng(11), case, log=False)
    keep = torch.as_tensor(np.random.default_rng(3).random(d2.shape[-1]) < 0.8)
    counted = real & keep
    tau_serial = serial_linear(d2, counted, k, hi)
    assert bool((hi < common.REAL_D2_MAX).all())
    for c in (counted, keep.expand_as(real)):
        _, tau = multilevel_bisect(d2, c, k, lo, hi, levels, log=False)
        assert torch.equal(tau, tau_serial)
    if case == "sparse":
        assert torch.equal(tau_serial, hi)


@pytest.mark.parametrize("levels", LEVELS)
def test_multilevel_walk_gives_plain_k3_counts(levels):
    """On sorted tiles with duplicated rows and sentinel slab rows, the
    mirror's K3 tau reproduces survivor_moments_reference's neighbour counts
    exactly, from K2's plain tau and survivor set."""
    rng = np.random.default_rng(5)
    ms, p_q, p_r, starts, d2 = _surface_tiles(rng)
    q_tile, band = 128, 256
    mean, found, tau0 = fk.outlier_stats_reference(starts, p_q, p_r, H, q_tile=q_tile,
                                                   band=band)
    n = ms.shape[0]
    stat = ms & found[:n]
    keep = stat & (mean[:n] <= mean[:n][stat].mean() + mean[:n][stat].std())
    keep_r = torch.cat([keep, torch.zeros(p_r.shape[0] - n, dtype=torch.bool)])
    S = fk.survivor_moments_reference(starts, p_q, p_r, keep_r, tau0,
                                      fk.slab_centroids(starts, p_r, band),
                                      q_tile=q_tile, band=band)
    keep_b = common.slabs(starts, keep_r[:, None], band)[..., 0][:, None, :]
    counted = keep_b & (d2 < common.REAL_D2_MAX)
    hi = (4.0 * tau0 + 1e-6).view(d2.shape[:-1])
    _, tau = multilevel_bisect(d2, keep_b.expand_as(d2), 20, torch.zeros_like(hi), hi, levels,
                               log=False)
    cnt = torch.sum(counted & (d2 <= tau[..., None]), dim=-1).reshape(-1)
    assert torch.equal(cnt.to(torch.float32), S[:, 9])
    assert bool((S[:, 9] >= 20).any()) and bool((S[:, 9] < 20).any())


@pytest.mark.parametrize("source", ["preprocess.cu", "fpfh.cu"])
def test_kernel_levels_are_covered(source):
    """The levels a pass that each source fixes are among those tested, and
    fpfh.cu's team is the mirror's."""
    text = (CSRC / source).read_text()
    m = re.search(r"constexpr int kLevels = (\d+);", text)
    assert m is not None and int(m.group(1)) in LEVELS
    if source == "fpfh.cu":
        m = re.search(r"constexpr int kTeam = (\d+);", text)
        assert m is not None and int(m.group(1)) == TEAM


def _feature_points(rng, case: str, n: int = 1900):
    """A bumpy patch at ~0.08 m spacing (0.1 m voxels): ``duplicated`` repeats
    400 rows exactly; ``clusters`` keeps a third of it and adds a lone point,
    a group of 9 and a group of 45 points, each 5 m from everything else."""
    side = float(np.sqrt(n) * 0.08)
    pts = rng.uniform(-side / 2, side / 2, size=(n, 3)).astype(np.float32)
    pts[:, 2] = 0.4 * np.sin(pts[:, 0]) * np.cos(0.7 * pts[:, 1])
    if case == "duplicated":
        pts[800:1200] = pts[:400]
    if case == "clusters":
        groups = [np.asarray(c, np.float32) + rng.uniform(-0.3, 0.3, (m, 3)).astype(np.float32)
                  for c, m in (((8, 0, 0), 1), ((0, 9, 0), 9), ((-8, -8, 0), 45))]
        pts = np.concatenate([pts[:n // 3]] + groups)
    return pts


def _feature_tiles(rng, case: str, q_tile=128, band=256):
    """(mask, sorted queries, sorted refs, slab starts, d2 (T, TQ, 2B))."""
    pts = _feature_points(rng, case)
    c = cloud.from_numpy(pts, 2048, device="cpu")
    _, ms, p_q, p_r, starts = preprocess.sort_and_tile(c.points, c.mask, q_tile, band)
    d2 = common.sqdist_tiles(p_q.view(-1, q_tile, 3), common.slabs(starts, p_r, band))
    return ms, p_q, p_r, starts, d2


@pytest.mark.parametrize("levels", LEVELS)
@pytest.mark.parametrize("case", FEATURE_CASES)
@pytest.mark.parametrize("kernel", sorted(FEATURE_KERNELS))
def test_multilevel_log_walk_matches_serial_features(kernel, case, levels):
    """K4's walk (k = 20 on [0.05v, 2v]) and K5's (k = 201 on [0.05v, 10v],
    capped at (10v)^2): tau bit-equal to ``_log_bisect``, with or without the
    sentinel test, on a surface, on slabs with fewer than k real rows and on
    duplicated points."""
    k, top = FEATURE_KERNELS[kernel]
    rng = np.random.default_rng(13)
    if case == "sparse":          # 12 real rows a slab
        d2 = torch.as_tensor(rng.uniform(0, 0.02, (48, 384)), dtype=torch.float32)
        d2[:, 12:] = 3.0e12
    else:
        d2 = _feature_tiles(rng, case)[-1].reshape(-1, 512)
    real = d2 < common.REAL_D2_MAX
    lo_f, hi_f = fk._log_bounds(V, 0.05, top)
    assert math.exp(hi_f) < common.REAL_D2_MAX
    cap = fk._radius2(V) if kernel == "k5" else float("inf")
    tau_serial = torch.clamp(fk._log_bisect(d2, real, k, lo_f, hi_f), max=cap)
    lo, hi = torch.full(d2.shape[:-1], lo_f), torch.full(d2.shape[:-1], hi_f)
    for counted in (real, torch.ones_like(real)):
        _, lhi = multilevel_bisect(d2, counted, k, lo, hi, levels, log=True)
        assert torch.equal(torch.clamp(torch.exp(lhi), max=cap), tau_serial)
    found = torch.sum(real & (d2 <= tau_serial[..., None]), dim=-1) >= k
    if case == "sparse":
        assert not bool(found.any())
        assert torch.equal(tau_serial, torch.clamp(torch.exp(hi), max=cap))
    else:                         # some neighbourhoods reach k, some stop at the top bound
        assert bool(found.any()) and not bool(found.all())


@pytest.mark.parametrize("case", FEATURE_CASES)
@pytest.mark.parametrize("kernel", sorted(FEATURE_KERNELS))
def test_listed_rows_give_the_slab_walk(kernel, case):
    """K4 and K5 list the slab rows within the bisection's top bound and walk
    over the list: counting only those rows gives the slab's tau, and every
    row at d2 <= tau is listed."""
    k, top = FEATURE_KERNELS[kernel]
    rng = np.random.default_rng(19)
    if case == "sparse":
        d2 = torch.as_tensor(rng.uniform(0, 0.02, (48, 384)), dtype=torch.float32)
        d2[:, 12:] = 3.0e12
    else:
        d2 = _feature_tiles(rng, case)[-1].reshape(-1, 512)
    real = d2 < common.REAL_D2_MAX
    lo_f, hi_f = fk._log_bounds(V, 0.05, top)
    lo, hi = torch.full(d2.shape[:-1], lo_f), torch.full(d2.shape[:-1], hi_f)
    listed = d2 <= torch.exp(hi)[..., None]
    assert bool((listed.sum(-1) < d2.shape[-1]).all())
    tau_serial = fk._log_bisect(d2, real, k, lo_f, hi_f)
    _, lhi = multilevel_bisect(d2, listed, k, lo, hi, 2, log=True)
    assert torch.equal(torch.exp(lhi), tau_serial)
    assert not bool((real & (d2 <= tau_serial[..., None]) & ~listed).any())


def compacted_histograms(starts, q, nq, r, nr, tau, q_tile: int, band: int):
    """K5's consumer for every query at once: (n_pad, 33) float32 histograms
    and the set of list lengths met at the last flush."""
    n_tiles, slab = starts.shape[0], 2 * band
    n_q = n_tiles * q_tile
    b, nb = common.slabs(starts, r, band), common.slabs(starts, nr, band)
    d2 = common.sqdist_tiles(q.view(n_tiles, q_tile, 3), b)
    keep = fk.pair_keep(d2, tau.view(n_tiles, q_tile), starts, q_tile, band)
    keep = keep.reshape(n_q, slab // TEAM, TEAM)
    lo3, scale12, scale3 = fk._bin_constants()
    lane = torch.arange(TEAM)
    every = torch.arange(n_q)
    hist = torch.zeros(n_q, fk.FEATURE_DIM, dtype=torch.long)
    rows_list = torch.zeros(n_q, 2 * TEAM, dtype=torch.long)
    pending = torch.zeros(n_q, dtype=torch.long)
    total = torch.zeros(n_q, dtype=torch.long)

    def bin_pairs(qi, rows, valid):
        """One flush: query qi[f]'s lane l evaluates slab row rows[f, l]."""
        t = (qi // q_tile)[:, None]
        bq, nbq = b[t, rows], nb[t, rows]
        qq, nqq = q[qi][:, None, :], nq[qi][:, None, :]
        f1, f2, f3 = fk._pair_features_tile(qq, nqq, bq, nbq, common.sqdist_tiles(qq, bq))
        for f, lo, scale, first in ((f1, -1.0, scale12, 0), (f2, -1.0, scale12, fk.N_BINS),
                                    (f3, lo3, scale3, 2 * fk.N_BINS)):
            bins = torch.clamp(torch.floor((f[:, 0] - lo) * scale).long(), 0, fk.N_BINS - 1)
            hist.index_put_((qi[:, None].expand_as(bins)[valid], first + bins[valid]),
                            torch.ones((), dtype=torch.long), accumulate=True)

    for step in range(slab // TEAM):
        votes = keep[:, step]
        ahead = torch.cumsum(votes, dim=1) - votes.long()     # kept lanes before this one
        qi, li = votes.nonzero(as_tuple=True)
        rows_list[qi, pending[qi] + ahead[qi, li]] = step * TEAM + li
        n_new = votes.sum(dim=1)
        pending, total = pending + n_new, total + n_new
        full = (pending >= TEAM).nonzero()[:, 0]
        if full.numel():
            pending[full] -= TEAM
            bin_pairs(full, rows_list[full[:, None], pending[full][:, None] + lane],
                      torch.ones(full.numel(), TEAM, dtype=torch.bool))
    bin_pairs(every, rows_list[:, :TEAM], lane[None, :] < pending[:, None])
    incr = torch.where(total > 0, torch.full((n_q,), 100.0) / torch.clamp(total, min=1).float(),
                       0.0)
    return hist.float() * incr[:, None], total


@pytest.mark.parametrize("case", ("surface", "duplicated", "clusters"))
def test_spfh_compacted_consumer_matches_plain(case):
    """The mirror of K5's consumer gives ``spfh_reference``'s histograms bit
    for bit; ``clusters`` has a query with no kept pair, queries with fewer
    than 32 and queries whose kept count is no multiple of 32."""
    q_tile, band = 128, 256
    ms, p_q, p_r, starts, _ = _feature_tiles(np.random.default_rng(17), case, q_tile, band)
    S = fk.moments_reference(starts, p_q, p_r, fk.slab_centroids(starts, p_r, band), V,
                             q_tile=q_tile, band=band)
    normals, _ = preprocess.normals_from_moments(S[:ms.shape[0]], ms)
    nq = cloud.pad_rows(normals, p_q.shape[0], 0.0).contiguous()
    nr = cloud.pad_rows(normals, p_r.shape[0], 0.0).contiguous()
    h_p, tau = fk.spfh_reference(starts, p_q, nq, p_r, nr, V, q_tile=q_tile, band=band)
    h_m, total = compacted_histograms(starts, p_q, nq, p_r, nr, tau, q_tile, band)
    assert torch.equal(h_m, h_p)
    valid = total[:ms.shape[0]][ms]
    assert bool((valid % TEAM != 0).any()) and bool((valid > TEAM).any())
    if case == "clusters":
        assert bool((valid == 0).any()) and bool(((valid > 0) & (valid < TEAM)).any())
