"""K2 and K3 — the preprocess neighbourhood passes (CUDA source:
``pcr_tpu_torch/csrc/preprocess.cu``).

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
in a block's shared memory, so one thread per query recomputes its distances
in every step from the slab, which the block holds in shared memory.  The
plain versions below follow the XLA ``spacing_hint`` branch of
``pcr_tpu/ops/preprocess._outlier_and_normals_sorted`` and share the
kernels' slabs and d2 formula, so the two differ only in summation order.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import build, common

LAUNCHES = {"outlier_stats": 0, "survivor_moments": 0}
BISECT_STEPS = 10


def _log_bounds(spacing_hint: float) -> tuple[float, float]:
    """f32 log-space bisection bounds 2*log(0.05h), 2*log(100h)."""
    h = float(spacing_hint)
    return (float(np.float32(2.0 * math.log(0.05 * h))),
            float(np.float32(2.0 * math.log(100.0 * h))))


def outlier_stats_reference(starts_el, q, r, spacing_hint, *, q_tile: int,
                            band: int, k1: int = 31):
    """Plain PyTorch version of K2: (mean_d, found (bool), tau), each (n_pad,)."""
    n_tiles = starts_el.shape[0]
    d2 = common.sqdist_tiles(q.view(n_tiles, q_tile, 3), common.slabs(starts_el, r, band))
    real = d2 < common.REAL_D2_MAX
    lo, hi = _log_bounds(spacing_hint)
    llo = torch.full(d2.shape[:-1], lo, dtype=torch.float32, device=q.device)
    lhi = torch.full(d2.shape[:-1], hi, dtype=torch.float32, device=q.device)
    for _ in range(BISECT_STEPS):
        lmid = 0.5 * (llo + lhi)
        geq = torch.sum(real & (d2 <= torch.exp(lmid)[..., None]), dim=-1) >= k1
        llo = torch.where(geq, llo, lmid)
        lhi = torch.where(geq, lmid, lhi)
    tau = torch.exp(lhi)
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
    lo, hi = _log_bounds(spacing_hint)
    lib = build.library()
    with torch.cuda.device(q.device):
        err = lib.pcr_outlier_stats(
            starts_el.data_ptr(), q.data_ptr(), r.data_ptr(), n_pad, q_tile,
            band, k1, lo, hi, mean_d.data_ptr(), found.data_ptr(),
            tau.data_ptr(), common.stream_of(q))
    build.check_launch("outlier_stats", err)
    LAUNCHES["outlier_stats"] += 1
    return mean_d, found, tau


def slab_centroids(starts_el: torch.Tensor, r: torch.Tensor, band: int) -> torch.Tensor:
    """(n_tiles, 3) centroid of each tile's real (non-sentinel) slab rows —
    the frame K3's moments are centred in, computed once for both versions."""
    s = common.slabs(starts_el, r, band)
    real = torch.sum(s * s, dim=-1) < common.REAL_D2_MAX
    total = torch.sum(torch.where(real[..., None], s, 0.0), dim=1)
    return total / torch.clamp(torch.sum(real, dim=1), min=1)[:, None]


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
    bc = s - center[:, None, :]                                  # (T, 2B, 3)
    x, y, z = bc[..., 0], bc[..., 1], bc[..., 2]
    feats = torch.stack([x, y, z, x * x, x * y, x * z, y * y, y * z, z * z,
                         torch.ones_like(x)], dim=-1)            # (T, 2B, 10)
    return torch.bmm(w, feats).reshape(n_tiles * q_tile, 10)


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
    return out
