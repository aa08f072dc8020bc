"""Multi-scale GICP pyramid and scale schedules (port of
pcr_tpu/models/multiscale.py).

Per scale, coarse to fine, warm-started from the previous scale:
  voxel_down_sample(v_s) -> remove_statistical_outlier(30, 1.0)
  -> estimate_normals(KNN 20) -> GICP(L1, <= 100 iterations,
     rel_fitness = rel_rmse = 1e-6) at search radii [3, 2.5, 2, 1.5, 1] * v_s

Preprocessing is fused by default (``ops/preprocess``, kernels K2 and K3:
one banded pass, output in sorted-axis order); ``fused=False`` runs the
unfused chain over k-NN lists (``ops/outlier`` and ``ops/normals``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import normals as normals_ops
from ..ops import outlier as outlier_ops
from ..ops import preprocess as preprocess_ops
from ..ops import voxel as voxel_ops
from ..utils import trace
from ..utils.cloud import Cloud, compact
from . import gicp as gicp_mod


def create_scales(n_scales: int) -> list[float]:
    """Linear schedule: n=5 -> [0.5, 0.4, 0.3, 0.2, 0.1]."""
    return [0.1 + 0.1 * i for i in reversed(range(n_scales))]


def create_scales_doubling(n_scales: int) -> list[float]:
    """Doubling schedule (coarse to fine): n=3 -> [0.4, 0.2, 0.1]."""
    return [0.1 * 2**i for i in reversed(range(n_scales))]


def max_correspondence_distances(scales: list[float]) -> list[float]:
    """Search-radius schedule (exact factors for n in {3, 4, 5}; linear
    3 -> 1 interpolation otherwise)."""
    n = len(scales)
    table = {3: [3.0, 2.0, 1.0], 4: [3.0, 2.5, 2.0, 1.0], 5: [3.0, 2.5, 2.0, 1.5, 1.0]}
    if n in table:
        factors = table[n]
    elif n == 1:
        factors = [1.0]
    else:
        factors = [3.0 - 2.0 * i / (n - 1) for i in range(n)]
    return [f * s for f, s in zip(factors, scales)]


def radius_from_cloud_pair(source: Cloud, target: Cloud) -> torch.Tensor:
    """Geometric-mean extent radius of the pair."""
    def rad(c: Cloud):
        mx = torch.where(c.mask[:, None], c.points, -3e38).amax(dim=0)
        mn = torch.where(c.mask[:, None], c.points, 3e38).amin(dim=0)
        d = mx - mn
        return (d[0] * d[1] * d[2]) ** (1.0 / 3.0)

    return (rad(source) + rad(target)) / 2.0


def _preprocess_scale(c: Cloud, voxel_size: float, scale_capacity: int | None,
                      knn_filter: int = 30, std_filter: float = 1.0, normal_k: int = 20,
                      fused: bool = True) -> Cloud:
    if fused:
        return preprocess_ops.preprocess_scale_fused(c, voxel_size, scale_capacity,
                                                     knn_filter, std_filter, normal_k)
    d = voxel_ops.voxel_downsample_cloud(c, voxel_size)
    if scale_capacity is not None and scale_capacity < d.capacity:
        d = compact(d, scale_capacity)  # voxel output is prefix-compact already
    d = outlier_ops.remove_statistical_outliers(d, knn_filter, std_filter)
    return normals_ops.with_normals_knn(d, normal_k)


@trace.spanned("pyramid")
def build_pyramid(c: Cloud, n_scales: int = 5,
                  scale_capacities: tuple[int, ...] | None = None,
                  fused: bool = True) -> tuple[Cloud, ...]:
    """Per-cloud preprocessing pyramid (linear schedule): downsample, filter
    and normals at every scale, computed ONCE per cloud."""
    scales = create_scales(n_scales)
    return tuple(
        _preprocess_scale(c, scales[s],
                          None if scale_capacities is None else scale_capacities[s],
                          fused=fused)
        for s in range(n_scales))


def _run_scales(pairs, dists, T_init, iterations: int, loss: str):
    """GICP over (source, target) clouds per scale, warm-started; returns the
    finest result with every scale's iteration count attached."""
    T = torch.as_tensor(T_init, dtype=torch.float32, device=pairs[0][0].device)
    result, its = None, []
    for i, ((src, tgt), dist) in enumerate(zip(pairs, dists)):
        its0 = trace.counter("gicp.iterations")
        with trace.span("gicp.scale", scale=i, rows=src.capacity,
                        band=gicp_mod.iteration_band(tgt.capacity)):
            result = gicp_mod.registration_gicp(src, tgt, dist, T, loss=loss,
                                                max_iteration=iterations)
        trace.count(f"gicp.iterations.s{i}", trace.counter("gicp.iterations") - its0)
        its.append(result.iterations)
        T = result.transformation
    return result._replace(scale_iterations=torch.stack(its))


def multiscale_gicp_pyramids(src_pyr: tuple[Cloud, ...], tgt_pyr: tuple[Cloud, ...],
                             T_init, n_scales: int = 5, iterations: int = 100,
                             loss: str = "l1") -> gicp_mod.RegistrationResult:
    """M-GICP over precomputed pyramids (linear schedule)."""
    dists = max_correspondence_distances(create_scales(n_scales))
    return _run_scales(list(zip(src_pyr, tgt_pyr)), dists, T_init, iterations, loss)


def multiscale_gicp(source: Cloud, target: Cloud, T_init, n_scales: int = 5,
                    iterations: int = 100, loss: str = "l1",
                    scale_capacities: tuple[int, ...] | None = None,
                    schedule: str = "linear", fused: bool = True) -> gicp_mod.RegistrationResult:
    """M-GICP with the reference's stage-2 defaults (n=5, 100 iters, L1).

    ``schedule='linear'`` is the canonical variant; ``'doubling'`` derives the
    search radii from the cloud extents, each clamped to 10x its voxel size
    (on partial-overlap pairs a radius of tens of metres lets the robust GN
    walk a correct seed into a wrong basin).
    """
    if schedule == "linear":
        scales = create_scales(n_scales)
        dists = max_correspondence_distances(scales)
    elif schedule == "doubling":
        scales = create_scales_doubling(n_scales)
        base = float(radius_from_cloud_pair(source, target))
        dists = [float(min(np.float32(base * 2.0 ** (-i)), np.float32(10.0 * scales[i])))
                 for i in range(n_scales)]
    else:
        raise ValueError(f"unknown schedule {schedule!r}")
    pairs = []
    for s in range(n_scales):
        cap = None if scale_capacities is None else scale_capacities[s]
        pairs.append((_preprocess_scale(source, scales[s], cap, fused=fused),
                      _preprocess_scale(target, scales[s], cap, fused=fused)))
    return _run_scales(pairs, dists, T_init, iterations, loss)
