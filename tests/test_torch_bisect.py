"""The multi-level bisection walk of kernels K2 and K3
(``pcr_tpu_torch/csrc/preprocess.cu``), mirrored in torch on the CPU and held
bit for bit against the serial walks of their plain versions.

A pass of the kernel counts the slab against the 2^m - 1 thresholds of the
next m levels of the bisection tree (heap order, each the midpoint
0.5 * (lo + hi) of the serial walk, exp of it in log space), then walks those
m levels from the counts.  A row that does not count (a sentinel pair, a
non-survivor) has d2 = NaN; the sentinel test is left out where every
threshold lies below ``REAL_D2_MAX``.  The mirror below does the same
operations in f32 in the same order, so tau must be bit-equal
(``torch.equal``) to ``feature_kernels._log_bisect`` (K2, K4, K5) and to
K3's linear loop, whose counts ``survivor_moments_reference`` returns.
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
SOURCE = Path(fk.__file__).resolve().parents[2] / "csrc" / "preprocess.cu"


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


def test_kernel_levels_are_covered():
    """The levels a pass that preprocess.cu fixes are among those tested."""
    m = re.search(r"constexpr int kLevels = (\d+);", SOURCE.read_text())
    assert m is not None and int(m.group(1)) in LEVELS
