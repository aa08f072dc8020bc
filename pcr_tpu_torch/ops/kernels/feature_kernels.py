"""K2 and K3 — the preprocess neighbourhood passes (CUDA source:
``pcr_tpu_torch/csrc/preprocess.cu``) — and K4-K6, the stage-1 feature
passes (CUDA source: ``pcr_tpu_torch/csrc/fpfh.cu``).

K2 ``outlier_stats`` replaces
``pcr_tpu/ops/pallas/feature_kernels.py:outlier_stats_pallas``: per sorted
query, a 10-step log-space count-CDF bisection over [0.05h, 100h] for the
k1-th nearest slab row (self included), then the mean distance to the k1-1
nearest excluding self, a ``found`` flag and the threshold tau.

K3 ``survivor_moments`` replaces
``pcr_tpu/ops/pallas/feature_kernels.py:survivor_moments_pallas``: a 10-step
linear bisection on [0, 4*tau + 1e-6] for the normal_k-th nearest SURVIVOR
(``keep``-masked), then the moments [x y z | xx xy xz yy yz zz | count] of
those neighbours, centred on the tile's slab centroid.

Bound on the H100: issue rate.  The TPU kernels keep the (TQ, 2*band) d2
tile resident in VMEM through all 10 bisection steps; that tile does not fit
in a block's shared memory, so K2-K5 recompute distances from the slab,
which the block stages once in shared memory as float4 rows: a team of lanes
(a warp) shares one query and splits the slab, and each pass over it counts
two bisection levels (the header of preprocess.cu says how tau stays the
serial walk's, bit for bit; the shared helpers are in csrc/common.cuh).  The
plain versions below follow the XLA ``spacing_hint`` branch of
``pcr_tpu/ops/preprocess._outlier_and_normals_sorted`` and share the
kernels' slabs and d2 formula, so the two differ only in summation order.

K4 ``moments`` replaces ``feature_kernels.py:moments_pallas``: a 10-step
log-space bisection on [0.05v, 2v] for the normal_k-th nearest slab row (self
included), then the moments of that Hybrid(2v, normal_k) set, centred on the
tile's slab centroid.  The kernel first lists, in one sweep of the slab,
the rows within the top bound (2v)^2, a handful of the 2*band, and runs the
bisection and the moments over the list; a query with more such rows than
the list holds reduces over the whole slab.  Either way the counts are the
slab's, so tau and the neighbour counts equal the plain version's.

K5 ``spfh`` replaces ``feature_kernels.py:spfh_pallas``: a log bisection on
[0.05v, 10v] for the (max_nn+1)-th nearest, tau = min(that, (10v)^2); over
the kept pairs (real, d2 <= tau, d2 > 0, not the query's own slab column) the
Darboux features f1, f2, f3 and three 11-bin histograms scaled by 100/count.
f3 is binned with atan2 and floor, as the XLA path of
``pcr_tpu/ops/fpfh_sorted`` does (the Pallas kernel's atan2-free binning
exists because Mosaic has no atan2).  Like K4 it lists the rows within its
top bound (10v)^2 first.  After the bisection the team goes through its rows
once more and compacts the kept ones (~200 of the 2*band) across its
lanes (ballot and popcount prefix into a list in shared memory); every 32
kept rows each lane evaluates one pair and adds 1 to three bins of the
team's integer histogram in shared memory, so no lane waits while another
runs the square roots, divisions and atan2 of a pair.  Bin counts are
integers, so the histogram does not depend on the order of the pairs.  The
neighbours' normals are read from global memory (L2) for the kept rows only.
Tensor cores serve neither kernel: d2 must be the rounded f32 formula for
tau and the kept set to equal the plain version's.

K6 ``fpfh`` replaces ``feature_kernels.py:fpfh_pallas``: over K5's kept pairs,
the sum of (1/max(d2, 1e-12)) * spfh[row]; the caller normalises the blocks
and adds the query's own SPFH.  It is bound by the slab sweep that finds the
kept rows (as K5's listing sweep) and by the latency of reading their SPFH
rows, which stay in L2.  A team of 32 lanes takes a query over the float4
slab, 32 queries a block; the kept rows of each 32-row step are walked in
ascending order from the step's ballot, lane f summing feature f (lane 0
also feature 32), so each kept row's SPFH is one coalesced 132-byte read of
the team.  Every feature is summed in ascending row order with the same
rounded operations as a one-thread-a-query walk.

Each of K4-K6 holds its slab (K4 and K5 also their lists) in shared memory;
the wrappers refuse, by band and bytes, a band whose block would need more
than the card gives.

The plain versions of K4-K6 follow the XLA path of ``fgr_features_sorted``
(the same tiles and slabs, d2 by ``common.sqdist_tiles``) over groups of
tiles, and evaluate every operation the kernels evaluate in the same order,
so bins and tau agree exactly; only K4's and K6's sums differ in order.

``voxel_counts`` (CUDA source: ``pcr_tpu_torch/csrc/voxel_counts.cu``)
replaces no TPU kernel: it counts the occupied voxels of every cloud at
every scale for the pyramid's capacity planner (``utils/cloud.
plan_scale_caps``), which counted them on the host, one sort a (cloud,
scale).  Its oracle is that host count, ``native.count_voxels``, which it
equals bit for bit; the planner's host route runs it for CPU clouds, so the
wrapper takes CUDA tensors only.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ...utils import trace
from . import build, common

LAUNCHES = {"outlier_stats": 0, "survivor_moments": 0, "moments": 0, "spfh": 0,
            "fpfh": 0, "voxel_counts": 0}
BISECT_STEPS = 10
MAX_LISTED_SLAB = 1 << 16   # K4 and K5 list candidate slab rows in 16 bits
N_BINS = 11
FEATURE_DIM = 33


def _f32(x: float) -> float:
    """x rounded to float32 (a host float, so the kernels and the plain
    versions get the same constant)."""
    return float(np.float32(x))


def _log_bounds(scale: float, lo_mult: float, hi_mult: float) -> tuple[float, float]:
    """f32 log-space bisection bounds 2*log(lo_mult*scale), 2*log(hi_mult*scale)."""
    s = float(scale)
    return _f32(2.0 * math.log(lo_mult * s)), _f32(2.0 * math.log(hi_mult * s))


def _log_bisect(d2, real, k: int, lo: float, hi: float):
    """Plain log-space count-CDF bisection (the serial walk that the kernels'
    ``pcr::bisect`` reproduces several levels a pass): per row of d2
    (..., S), tau = exp(lhi) after BISECT_STEPS halvings."""
    llo = torch.full(d2.shape[:-1], lo, dtype=torch.float32, device=d2.device)
    lhi = torch.full(d2.shape[:-1], hi, dtype=torch.float32, device=d2.device)
    for _ in range(BISECT_STEPS):
        lmid = 0.5 * (llo + lhi)
        geq = torch.sum(real & (d2 <= torch.exp(lmid)[..., None]), dim=-1) >= k
        llo = torch.where(geq, llo, lmid)
        lhi = torch.where(geq, lmid, lhi)
    return torch.exp(lhi)


def outlier_stats_reference(starts_el, q, r, spacing_hint, *, q_tile: int,
                            band: int, k1: int = 31):
    """Plain PyTorch version of K2: (mean_d, found (bool), tau), each (n_pad,)."""
    n_tiles = starts_el.shape[0]
    d2 = common.sqdist_tiles(q.view(n_tiles, q_tile, 3), common.slabs(starts_el, r, band))
    real = d2 < common.REAL_D2_MAX
    tau = _log_bisect(d2, real, k1, *_log_bounds(spacing_hint, 0.05, 100.0))
    w = real & (d2 <= tau[..., None])
    cnt = torch.sum(w, dim=-1)                                   # includes self
    sum_d = torch.sum(torch.where(w, torch.sqrt(torch.clamp(d2, min=0.0)), 0.0), dim=-1)
    mean_d = sum_d / torch.clamp(cnt - 1, min=1)
    return mean_d.reshape(-1), (cnt >= k1).reshape(-1), tau.reshape(-1)


def outlier_stats(starts_el, q, r, spacing_hint, *, q_tile: int, band: int,
                  k1: int = 31):
    """Outlier statistics of every sorted query over its tile's slab.

    starts_el: (n_tiles,) int32 slab starts; q: (n_tiles*q_tile, 3) f32;
    r: (nr_pad, 3) f32.  Returns (mean_d f32, found bool, tau f32), each
    (n_pad,).  CPU tensors run the plain version; CUDA tensors the kernel.
    """
    n_tiles = starts_el.shape[0]
    common.check_tiling(q.shape[0], q_tile, n_tiles, band, r.shape[0])
    if not common.on_cuda(starts_el, q, r):
        return outlier_stats_reference(starts_el, q, r, spacing_hint,
                                       q_tile=q_tile, band=band, k1=k1)
    common.check(starts_el, "starts_el", torch.int32, (n_tiles,))
    common.check(q, "q", torch.float32, (n_tiles * q_tile, 3))
    common.check(r, "r", torch.float32, (r.shape[0], 3))
    n_pad = n_tiles * q_tile
    mean_d = torch.empty(n_pad, dtype=torch.float32, device=q.device)
    found = torch.empty(n_pad, dtype=torch.bool, device=q.device)
    tau = torch.empty(n_pad, dtype=torch.float32, device=q.device)
    lo, hi = _log_bounds(spacing_hint, 0.05, 100.0)
    lib = build.library()
    with torch.cuda.device(q.device):
        err = lib.pcr_outlier_stats(
            starts_el.data_ptr(), q.data_ptr(), r.data_ptr(), n_pad, q_tile,
            band, k1, lo, hi, mean_d.data_ptr(), found.data_ptr(),
            tau.data_ptr(), common.stream_of(q))
    build.check_launch("outlier_stats", err)
    LAUNCHES["outlier_stats"] += 1
    trace.shape("outlier_stats", n_tiles, q.shape[0], r.shape[0], q_tile, band)
    return mean_d, found, tau


def slab_centroids(starts_el: torch.Tensor, r: torch.Tensor, band: int) -> torch.Tensor:
    """(n_tiles, 3) centroid of each tile's real (non-sentinel) slab rows —
    the frame K3's moments are centred in, computed once for both versions."""
    s = common.slabs(starts_el, r, band)
    real = torch.sum(s * s, dim=-1) < common.REAL_D2_MAX
    total = torch.sum(torch.where(real[..., None], s, 0.0), dim=1)
    return total / torch.clamp(torch.sum(real, dim=1), min=1)[:, None]


def _moment_features(s: torch.Tensor, center: torch.Tensor) -> torch.Tensor:
    """(T, 2B, 10) rows [x y z | xx xy xz yy yz zz | 1] of the slabs s
    (T, 2B, 3), centred on each tile's ``center`` (T, 3)."""
    bc = s - center[:, None, :]
    x, y, z = bc[..., 0], bc[..., 1], bc[..., 2]
    return torch.stack([x, y, z, x * x, x * y, x * z, y * y, y * z, z * z,
                        torch.ones_like(x)], dim=-1)


def survivor_moments_reference(starts_el, q, r, keep, tau_out, center, *,
                               q_tile: int, band: int, normal_k: int = 20):
    """Plain PyTorch version of K3: (n_pad, 10) f32 moments."""
    n_tiles = starts_el.shape[0]
    s = common.slabs(starts_el, r, band)
    d2 = common.sqdist_tiles(q.view(n_tiles, q_tile, 3), s)
    keep_b = keep[starts_el.long()[:, None]
                  + torch.arange(2 * band, device=r.device)[None, :]]
    keep_real = keep_b[:, None, :] & (d2 < common.REAL_D2_MAX)
    tau0 = tau_out.view(n_tiles, q_tile)
    lo = torch.zeros_like(tau0)
    hi = 4.0 * tau0 + 1e-6
    for _ in range(BISECT_STEPS):
        mid = 0.5 * (lo + hi)
        geq = torch.sum(keep_real & (d2 <= mid[..., None]), dim=-1) >= normal_k
        lo = torch.where(geq, lo, mid)
        hi = torch.where(geq, mid, hi)
    w = (keep_real & (d2 <= hi[..., None])).to(torch.float32)
    return torch.bmm(w, _moment_features(s, center)).reshape(n_tiles * q_tile, 10)


def survivor_moments(starts_el, q, r, keep, tau_out, center, *, q_tile: int,
                     band: int, normal_k: int = 20):
    """Survivor-kNN moments of every sorted query over its tile's slab.

    keep: (nr_pad,) bool survivors in ref-row order; tau_out: (n_pad,) f32
    from ``outlier_stats``; center: (n_tiles, 3) f32 from ``slab_centroids``.
    Returns (n_pad, 10) f32.  CPU tensors run the plain version; CUDA
    tensors the kernel.
    """
    n_tiles = starts_el.shape[0]
    nr_pad = r.shape[0]
    common.check_tiling(q.shape[0], q_tile, n_tiles, band, nr_pad)
    if not common.on_cuda(starts_el, q, r, keep, tau_out, center):
        return survivor_moments_reference(starts_el, q, r, keep, tau_out, center,
                                          q_tile=q_tile, band=band, normal_k=normal_k)
    n_pad = n_tiles * q_tile
    common.check(starts_el, "starts_el", torch.int32, (n_tiles,))
    common.check(q, "q", torch.float32, (n_pad, 3))
    common.check(r, "r", torch.float32, (nr_pad, 3))
    common.check(keep, "keep", torch.bool, (nr_pad,))
    common.check(tau_out, "tau_out", torch.float32, (n_pad,))
    common.check(center, "center", torch.float32, (n_tiles, 3))
    out = torch.empty((n_pad, 10), dtype=torch.float32, device=q.device)
    lib = build.library()
    with torch.cuda.device(q.device):
        err = lib.pcr_survivor_moments(
            starts_el.data_ptr(), q.data_ptr(), r.data_ptr(), keep.data_ptr(),
            tau_out.data_ptr(), center.data_ptr(), n_pad, q_tile, band,
            normal_k, out.data_ptr(), common.stream_of(q))
    build.check_launch("survivor_moments", err)
    LAUNCHES["survivor_moments"] += 1
    trace.shape("survivor_moments", n_tiles, q.shape[0], r.shape[0], q_tile, band)
    return out


# ---------------------------------------------------------------------------
# K4-K6: the stage-1 feature passes
# ---------------------------------------------------------------------------

def _bin_constants() -> tuple[float, float, float]:
    """(lo of f3, bins per unit of f1/f2, bins per unit of f3) as float32:
    bin = floor((f - lo) * scale), f1/f2 on [-1, 1], f3 on [-pi, pi]."""
    return _f32(-math.pi), _f32(N_BINS / 2.0), _f32(N_BINS / (2.0 * math.pi))


def _radius2(voxel_size: float) -> float:
    """(10v)^2 as float32 arithmetic gives it."""
    r = np.float32(10.0) * np.float32(voxel_size)
    return float(r * r)


def pair_keep(d2, tau, starts_el, q_tile: int, band: int, first_tile: int = 0):
    """K5's and K6's kept pairs of a group of tiles: real slab rows at
    d2 <= tau with d2 > 0, off the query's own slab column.  d2 (G, TQ, 2B)
    of tiles first_tile.., tau (G, TQ), starts_el (G,) their slab starts."""
    g = starts_el.shape[0]
    rows = (first_tile * q_tile
            + torch.arange(g * q_tile, device=d2.device).view(g, q_tile))
    self_col = rows - starts_el.long()[:, None]
    col = torch.arange(2 * band, device=d2.device)
    return ((d2 < common.REAL_D2_MAX) & (d2 <= tau[..., None]) & (d2 > 0.0)
            & (col != self_col[..., None]))


def _check_listed_slab(band: int) -> None:
    if 2 * band > MAX_LISTED_SLAB:
        raise ValueError(f"slab of 2*{band} rows exceeds the {MAX_LISTED_SLAB} rows that "
                         f"kernels K4 and K5 can list")


def _check_shared_memory(name: str, smem_bytes, band: int, device: torch.device) -> None:
    """Raise unless a block of kernel ``name`` at this band (``smem_bytes(band)``
    bytes of shared memory, from the library) fits the card's limit a block."""
    need = smem_bytes(band)
    have = torch.cuda.get_device_properties(device).shared_memory_per_block_optin
    if need > have:
        raise ValueError(f"band {band}: kernel {name} needs {need} bytes of shared memory "
                         f"a block, more than the {have} bytes the card gives one")


def moments_reference(starts_el, q, r, center, voxel_size, *, q_tile: int,
                      band: int, normal_k: int = 20):
    """Plain PyTorch version of K4: (n_pad, 10) f32 moments."""
    n_tiles = starts_el.shape[0]
    lo, hi = _log_bounds(voxel_size, 0.05, 2.0)
    q_t = q.view(n_tiles, q_tile, 3)
    out = []
    for g in common.tile_groups(n_tiles, q_tile * 2 * band):
        s = common.slabs(starts_el[g], r, band)
        d2 = common.sqdist_tiles(q_t[g], s)
        real = d2 < common.REAL_D2_MAX
        tau = _log_bisect(d2, real, normal_k, lo, hi)
        w = (real & (d2 <= tau[..., None])).to(torch.float32)
        out.append(torch.bmm(w, _moment_features(s, center[g])))
    return torch.cat(out).reshape(n_tiles * q_tile, 10)


def moments(starts_el, q, r, center, voxel_size, *, q_tile: int, band: int,
            normal_k: int = 20):
    """Hybrid(2*voxel, normal_k) neighbourhood moments of every sorted query.

    starts_el: (n_tiles,) int32 slab starts; q: (n_tiles*q_tile, 3) f32;
    r: (nr_pad, 3) f32; center: (n_tiles, 3) f32 from ``slab_centroids``.
    Returns (n_pad, 10) f32.  CPU tensors run the plain version; CUDA tensors
    the kernel.
    """
    n_tiles = starts_el.shape[0]
    nr_pad = r.shape[0]
    common.check_tiling(q.shape[0], q_tile, n_tiles, band, nr_pad)
    if not common.on_cuda(starts_el, q, r, center):
        return moments_reference(starts_el, q, r, center, voxel_size, q_tile=q_tile,
                                 band=band, normal_k=normal_k)
    n_pad = n_tiles * q_tile
    common.check(starts_el, "starts_el", torch.int32, (n_tiles,))
    common.check(q, "q", torch.float32, (n_pad, 3))
    common.check(r, "r", torch.float32, (nr_pad, 3))
    common.check(center, "center", torch.float32, (n_tiles, 3))
    _check_listed_slab(band)
    lib = build.library()
    _check_shared_memory("moments", lib.pcr_moments_smem, band, q.device)
    out = torch.empty((n_pad, 10), dtype=torch.float32, device=q.device)
    lo, hi = _log_bounds(voxel_size, 0.05, 2.0)
    with torch.cuda.device(q.device):
        err = lib.pcr_moments(
            starts_el.data_ptr(), q.data_ptr(), r.data_ptr(), center.data_ptr(), n_pad,
            q_tile, band, normal_k, lo, hi, out.data_ptr(), common.stream_of(q))
    build.check_launch("moments", err)
    LAUNCHES["moments"] += 1
    trace.shape("moments", n_tiles, q.shape[0], r.shape[0], q_tile, band)
    return out


def _pair_features_tile(q, nq, b, nb, d2):
    """Darboux pair features (f1, f2, f3), each (T, TQ, 2B), between query
    tiles q, nq (T, TQ, 3) and their slabs b, nb (T, 2B, 3) at squared
    distances d2 — Open3D's ComputePairFeatures with the source/target swap,
    as ``pcr_tpu/ops/fpfh_sorted._pair_features_tile`` computes it, written
    one operation at a time in the order of the kernel's ``pair_features``."""
    def dot(a, c):
        return a[0] * c[0] + a[1] * c[1] + a[2] * c[2]

    def cross(a, c):
        return (a[1] * c[2] - a[2] * c[1], a[2] * c[0] - a[0] * c[2],
                a[0] * c[1] - a[1] * c[0])

    dist = torch.clamp(torch.sqrt(d2), min=1e-12)
    dn = [(b[:, None, :, k] - q[:, :, None, k]) / dist for k in range(3)]
    n1 = [nq[:, :, None, k] for k in range(3)]
    n2 = [nb[:, None, :, k] for k in range(3)]
    swap = dot(n2, dn).abs() > dot(n1, dn).abs()
    u = [torch.where(swap, y, x) for x, y in zip(n1, n2)]
    nt = [torch.where(swap, x, y) for x, y in zip(n1, n2)]
    e = [torch.where(swap, -d, d) for d in dn]
    f2 = dot(u, e)
    v = cross(e, u)
    vn = torch.clamp(torch.sqrt(dot(v, v)), min=1e-12)
    v = [c / vn for c in v]
    w = cross(u, v)
    return dot(v, nt), f2, torch.atan2(dot(w, nt), dot(u, nt))


def _bin_counts(f, keep, lo: float, scale: float):
    """(..., S) features -> (..., 11) counts of the kept pairs in each bin."""
    bins = torch.clamp(torch.floor((f - lo) * scale).to(torch.int64), 0, N_BINS - 1)
    return torch.stack([torch.sum(keep & (bins == b), dim=-1) for b in range(N_BINS)],
                       dim=-1)


def spfh_reference(starts_el, q, nq, r, nr, voxel_size, *, q_tile: int, band: int,
                   max_nn: int = 200):
    """Plain PyTorch version of K5: (spfh (n_pad, 33) f32, tau (n_pad,) f32)."""
    n_tiles = starts_el.shape[0]
    lo, hi = _log_bounds(voxel_size, 0.05, 10.0)
    radius2 = _radius2(voxel_size)
    lo3, scale12, scale3 = _bin_constants()
    q_t, nq_t = q.view(n_tiles, q_tile, 3), nq.view(n_tiles, q_tile, 3)
    hists, taus = [], []
    for g in common.tile_groups(n_tiles, q_tile * 2 * band):
        st = starts_el[g]
        b, nb = common.slabs(st, r, band), common.slabs(st, nr, band)
        d2 = common.sqdist_tiles(q_t[g], b)
        tau = torch.clamp(_log_bisect(d2, d2 < common.REAL_D2_MAX, max_nn + 1, lo, hi),
                          max=radius2)
        keep = pair_keep(d2, tau, st, q_tile, band, g.start)
        f1, f2, f3 = _pair_features_tile(q_t[g], nq_t[g], b, nb, d2)
        counts = torch.cat([_bin_counts(f1, keep, -1.0, scale12),
                            _bin_counts(f2, keep, -1.0, scale12),
                            _bin_counts(f3, keep, lo3, scale3)], dim=-1)
        cnt = torch.sum(keep, dim=-1).to(torch.float32)
        incr = torch.where(cnt > 0, torch.full_like(cnt, 100.0) / torch.clamp(cnt, min=1.0),
                           0.0)
        hists.append(counts.to(torch.float32) * incr[..., None])
        taus.append(tau)
    return (torch.cat(hists).reshape(n_tiles * q_tile, FEATURE_DIM),
            torch.cat(taus).reshape(n_tiles * q_tile))


def spfh(starts_el, q, nq, r, nr, voxel_size, *, q_tile: int, band: int,
         max_nn: int = 200):
    """SPFH histograms of every sorted query over its Hybrid(10*voxel, max_nn)
    slab neighbourhood (self excluded).

    q, nq: (n_pad, 3) f32 points and unit normals; r, nr: (nr_pad, 3) f32.
    Returns (spfh (n_pad, 33) f32, tau (n_pad,) f32).  CPU tensors run the
    plain version; CUDA tensors the kernel.
    """
    n_tiles = starts_el.shape[0]
    nr_pad = r.shape[0]
    common.check_tiling(q.shape[0], q_tile, n_tiles, band, nr_pad)
    if not common.on_cuda(starts_el, q, nq, r, nr):
        return spfh_reference(starts_el, q, nq, r, nr, voxel_size, q_tile=q_tile,
                              band=band, max_nn=max_nn)
    n_pad = n_tiles * q_tile
    common.check(starts_el, "starts_el", torch.int32, (n_tiles,))
    for t, name in ((q, "q"), (nq, "nq")):
        common.check(t, name, torch.float32, (n_pad, 3))
    for t, name in ((r, "r"), (nr, "nr")):
        common.check(t, name, torch.float32, (nr_pad, 3))
    _check_listed_slab(band)
    lib = build.library()
    _check_shared_memory("spfh", lib.pcr_spfh_smem, band, q.device)
    hist = torch.empty((n_pad, FEATURE_DIM), dtype=torch.float32, device=q.device)
    tau = torch.empty(n_pad, dtype=torch.float32, device=q.device)
    lo, hi = _log_bounds(voxel_size, 0.05, 10.0)
    lo3, scale12, scale3 = _bin_constants()
    with torch.cuda.device(q.device):
        err = lib.pcr_spfh(
            starts_el.data_ptr(), q.data_ptr(), nq.data_ptr(), r.data_ptr(), nr.data_ptr(),
            n_pad, q_tile, band, max_nn + 1, lo, hi, _radius2(voxel_size), lo3, scale12,
            scale3, hist.data_ptr(), tau.data_ptr(), common.stream_of(q))
    build.check_launch("spfh", err)
    LAUNCHES["spfh"] += 1
    trace.shape("spfh", n_tiles, q.shape[0], r.shape[0], q_tile, band)
    return hist, tau


def fpfh_reference(starts_el, q, r, tau, spfh_r, *, q_tile: int, band: int):
    """Plain PyTorch version of K6: (n_pad, 33) f32 weighted neighbour sums."""
    n_tiles = starts_el.shape[0]
    q_t, tau_t = q.view(n_tiles, q_tile, 3), tau.view(n_tiles, q_tile)
    out = []
    for g in common.tile_groups(n_tiles, q_tile * 2 * band):
        st = starts_el[g]
        d2 = common.sqdist_tiles(q_t[g], common.slabs(st, r, band))
        keep = pair_keep(d2, tau_t[g], st, q_tile, band, g.start)
        W = torch.where(keep, torch.reciprocal(torch.clamp(d2, min=1e-12)), 0.0)
        out.append(torch.bmm(W, common.slabs(st, spfh_r, band)))
    return torch.cat(out).reshape(n_tiles * q_tile, FEATURE_DIM)


def fpfh(starts_el, q, r, tau, spfh_r, *, q_tile: int, band: int):
    """1/d2-weighted sums of the neighbours' SPFH over K5's neighbourhoods.

    tau: (n_pad,) f32 from ``spfh``; spfh_r: (nr_pad, 33) f32 SPFH in ref-row
    order (zero rows past the cloud).  Returns (n_pad, 33) f32.  CPU tensors
    run the plain version; CUDA tensors the kernel.
    """
    n_tiles = starts_el.shape[0]
    nr_pad = r.shape[0]
    common.check_tiling(q.shape[0], q_tile, n_tiles, band, nr_pad)
    if not common.on_cuda(starts_el, q, r, tau, spfh_r):
        return fpfh_reference(starts_el, q, r, tau, spfh_r, q_tile=q_tile, band=band)
    n_pad = n_tiles * q_tile
    common.check(starts_el, "starts_el", torch.int32, (n_tiles,))
    common.check(q, "q", torch.float32, (n_pad, 3))
    common.check(r, "r", torch.float32, (nr_pad, 3))
    common.check(tau, "tau", torch.float32, (n_pad,))
    common.check(spfh_r, "spfh_r", torch.float32, (nr_pad, FEATURE_DIM))
    lib = build.library()
    _check_shared_memory("fpfh", lib.pcr_fpfh_smem, band, q.device)
    out = torch.empty((n_pad, FEATURE_DIM), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.pcr_fpfh(
            starts_el.data_ptr(), q.data_ptr(), r.data_ptr(), tau.data_ptr(),
            spfh_r.data_ptr(), n_pad, q_tile, band, out.data_ptr(), common.stream_of(q))
    build.check_launch("fpfh", err)
    LAUNCHES["fpfh"] += 1
    trace.shape("fpfh", n_tiles, q.shape[0], r.shape[0], q_tile, band)
    return out


VOXEL_SCRATCH_BYTES = 1 << 26   # the hash tables of one voxel_counts launch
MAX_VOXEL_CLOUDS = 64           # clouds a launch (csrc/voxel_counts.cu kMaxClouds)
MAX_VOXEL_SCALES = 8            # ... and scales (kMaxScales)


def voxel_slots_log2(rows: int) -> int:
    """log2 of the slots of a (cloud, scale) hash table for clouds of at most
    ``rows`` rows: the least power of two >= 2 * rows, so no table is more
    than half full."""
    return max(1, (2 * rows - 1).bit_length())


def voxel_chunks(n_clouds: int, rows: int, n_scales: int) -> list[slice]:
    """The clouds of each ``voxel_counts`` launch: consecutive chunks of
    near-equal size whose tables (``n_scales`` of 2^voxel_slots_log2(rows)
    64-bit keys a cloud) fit VOXEL_SCRATCH_BYTES, at most MAX_VOXEL_CLOUDS
    clouds; a cloud whose tables alone exceed the budget is a chunk."""
    if n_clouds <= 0:
        return []
    per_cloud = n_scales * (8 << voxel_slots_log2(rows))
    most = max(1, min(MAX_VOXEL_CLOUDS, VOXEL_SCRATCH_BYTES // per_cloud))
    n_chunks = -(-n_clouds // most)
    size, extra = divmod(n_clouds, n_chunks)
    bounds = [k * size + min(k, extra) for k in range(n_chunks + 1)]
    return [slice(a, b) for a, b in zip(bounds, bounds[1:])]


def voxel_counts(points, masks, scales) -> torch.Tensor:
    """Occupied-voxel counts of every cloud at every scale, on the card.

    points: sequence of (n_i, 3) f32 CUDA tensors, one a cloud; masks: the
    same number of (n_i,) bool tensors, or None where every row is valid;
    scales: the voxel sizes (at most MAX_VOXEL_SCALES, each rounded to
    float32).  Returns a (clouds, scales) int64 tensor on the clouds' card,
    enqueued on the current stream: entry (k, s) is
    ``native.count_voxels(valid rows of cloud k, scales[s])`` bit for bit.
    One launch a chunk of ``voxel_chunks``; scratch by ``torch.empty``.
    Raises for CPU tensors, a wrong dtype, shape or layout, and a mix of
    devices.
    """
    points, masks = list(points), list(masks)
    scales = [float(v) for v in scales]
    if not 1 <= len(scales) <= MAX_VOXEL_SCALES or not all(v > 0 for v in scales):
        raise ValueError(f"voxel_counts: 1 to {MAX_VOXEL_SCALES} positive scales, got {scales}")
    if len(masks) != len(points):
        raise ValueError(f"voxel_counts: {len(points)} clouds but {len(masks)} masks")
    tensors = []
    for k, (p, m) in enumerate(zip(points, masks)):
        rows = p.shape[0] if p.dim() else 0
        common.check(p, f"points[{k}]", torch.float32, (rows, 3))
        if rows >= 1 << 30:
            raise ValueError(f"voxel_counts: points[{k}] has {rows} rows, at most 2^30 - 1")
        tensors.append(p)
        if m is not None:
            common.check(m, f"masks[{k}]", torch.bool, (rows,))
            tensors.append(m)
    if not tensors or not common.on_cuda(*tensors):
        raise ValueError("voxel_counts takes CUDA tensors; CPU clouds are counted on the host "
                         "(utils/cloud.plan_scale_caps)")
    dev, n, n_s = tensors[0].device, len(points), len(scales)
    counts = torch.empty((n, n_s), dtype=torch.int64, device=dev)
    rows = max(p.shape[0] for p in points)
    log2 = voxel_slots_log2(rows)
    chunks = voxel_chunks(n, rows, n_s)
    most = max(c.stop - c.start for c in chunks)
    tables = torch.empty((most * n_s) << log2, dtype=torch.int64, device=dev)
    mins = torch.empty(most * 3, dtype=torch.float32, device=dev)
    c_scales = (ctypes.c_float * n_s)(*scales)
    lib = build.library()
    for c in chunks:
        k = c.stop - c.start
        c_points = (ctypes.c_void_p * k)(*[p.data_ptr() for p in points[c]])
        c_masks = (ctypes.c_void_p * k)(*[None if m is None else m.data_ptr()
                                          for m in masks[c]])
        c_rows = (ctypes.c_int * k)(*[p.shape[0] for p in points[c]])
        with torch.cuda.device(dev):
            err = lib.pcr_voxel_counts(
                ctypes.addressof(c_points), ctypes.addressof(c_masks), ctypes.addressof(c_rows),
                k, ctypes.addressof(c_scales), n_s, log2, tables.data_ptr(), mins.data_ptr(),
                counts[c].data_ptr(), common.stream_of(counts))
        build.check_launch("voxel_counts", err)
        LAUNCHES["voxel_counts"] += 1
        trace.shape("voxel_counts", k, rows, n_s, 1 << log2)
    return counts
