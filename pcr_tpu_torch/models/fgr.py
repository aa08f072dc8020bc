"""Fast Global Registration (port of pcr_tpu/models/fgr.py): mutual feature
matching, the seeded tuple test and graduated non-convexity.

The options are those of the reference's script 1: division_factor=1.4,
use_absolute_scale=False, decrease_mu=True, maximum_correspondence_distance
=2*voxel, iteration_number=300, tuple_scale=0.95, maximum_tuple_count
=0.2*n.

  1. mutual nearest neighbours over the 33-dim FPFH features
     (``ops/knn.nn1_mutual``);
  2. tuple test: seeded random triples of correspondences, kept when all
     three point-pair length ratios lie in [tuple_scale, 1/tuple_scale],
     capped at maximum_tuple_count accepted triples;
  3. GNC on the scaled Geman-McClure: line-process weight
     l = (mu / (mu + ||r||^2))^2, mu divided by division_factor every 4
     iterations until it reaches max_corr_dist^2, one weighted point-to-point
     Gauss-Newton step on se(3) per iteration.

The tuple test draws its uniforms from a ``torch.Generator``, which cannot
replay ``jax.random``'s stream: the two packages agree on a pose
statistically, or exactly when handed the same draws (``u``).

``registro_fgr`` is the reference's whole per-pair pipeline over the
selection features of ``fgr_features`` (one exact k=200 self-kNN shared by
the hybrid normals and the FPFH); the stage-1 runner's default features are
the banded ones of ``ops/fpfh_sorted``.  ``stage1_features`` and
``batched_stage1_features`` are the one place that chooses between the two.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import fpfh as fpfh_ops
from ..ops import fpfh_sorted
from ..ops import knn as knn_ops
from ..ops import normals as normals_ops
from ..ops.kernels import loop_kernels
from ..utils import se3, trace
from ..utils.cloud import Cloud, stack_clouds
from . import evaluate as eval_mod
from .gicp import RegistrationResult


class FgrOptions(NamedTuple):
    division_factor: float = 1.4
    use_absolute_scale: bool = False
    decrease_mu: bool = True
    maximum_correspondence_distance: float = 0.2
    iteration_number: int = 300
    tuple_scale: float = 0.95
    maximum_tuple_count: int = 1000
    tuple_test: bool = True


def match_features(feat_src, src_mask, feat_tgt, tgt_mask):
    """Mutual nearest neighbours in feature space.  Returns (corr_src_idx,
    corr_tgt_idx, corr_mask), each (N,) over the source capacity N: pair i is
    (i, nn_tgt[i]), kept when mutual."""
    ij, ji = knn_ops.nn1_mutual(feat_src, src_mask, feat_tgt, tgt_mask)
    n = feat_src.shape[0]
    ar = torch.arange(n, device=feat_src.device)
    return ar, ij, (ji[ij] == ar) & src_mask


def _norm3(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x, dim=-1))


def tuple_test(pts_src, pts_tgt, corr_i, corr_j, corr_mask, seed: int,
               tuple_scale: float = 0.95, max_tuples: int = 4096,
               n_trials: int = 16384, u: torch.Tensor | None = None):
    """Seeded, fixed-shape tuple constraint: a per-correspondence keep mask
    (a correspondence survives if it appears in any accepted triple).

    ``u``: optional (n_trials, 3) uniforms on [0, 1) to use instead of the
    draws of a ``torch.Generator`` seeded with ``seed``."""
    n = corr_i.shape[0]
    dev = corr_i.device
    # valid correspondence slots first, for uniform sampling over them
    order = torch.argsort((~corr_mask).to(torch.uint8), stable=True)
    n_valid = torch.sum(corr_mask.to(torch.int32))
    if u is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        u = torch.rand((n_trials, 3), generator=gen, device=dev)
    pos = torch.minimum((u * n_valid).to(torch.int32), torch.clamp(n_valid - 1, min=0))
    slots = order[pos.long()]                              # (n_trials, 3)
    pa = pts_src[corr_i[slots]]                            # (n_trials, 3, 3)
    qa = pts_tgt[corr_j[slots]]

    def edge_ok(a, b):
        r = _norm3(pa[:, a] - pa[:, b]) / torch.clamp(_norm3(qa[:, a] - qa[:, b]), min=1e-12)
        return (r > tuple_scale) & (r < 1.0 / tuple_scale)

    ok = edge_ok(0, 1) & edge_ok(1, 2) & edge_ok(2, 0) & (n_valid >= 3)
    # cap accepted tuples at max_tuples (first-come order, like the reference)
    ok_i = ok.to(torch.int32)
    ok = ok & (torch.cumsum(ok_i, dim=0) - ok_i < max_tuples)
    # mark the slots of accepted tuples; the others write to a spare last
    # entry.  Every write is True, so their order does not matter.
    flat = torch.where(ok[:, None], slots, n).reshape(-1)
    keep = torch.zeros(n + 1, dtype=torch.bool, device=dev)
    keep[flat] = True
    return keep[:n] & corr_mask


def _center_radius(pts: torch.Tensor, mask: torch.Tensor):
    w = mask.to(torch.float32)[..., None]
    c = torch.sum(pts * w, dim=-2) / torch.clamp(torch.sum(w, dim=-2), min=1.0)
    return c, torch.amax(torch.where(mask, _norm3(pts - c[..., None, :]), 0.0), dim=-1)


def _take_rows(pts: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.take_along_dim(pts, idx.long()[..., None], dim=-2)


class GncInputs(NamedTuple):
    """The GNC's normalised inputs (``ops/kernels/loop_kernels.gnc``) and the
    normalisation that ``gnc_pose`` undoes; leading batch dimensions as the
    correspondences'."""

    p: torch.Tensor        # (..., N, 3) source points of the correspondences, normalised
    q: torch.Tensor        # (..., N, 3) target points, normalised
    w: torch.Tensor        # (..., N) f32 correspondence mask
    mu0: float             # mu's start
    delta: torch.Tensor    # (...) normalised stop scale
    enough: torch.Tensor   # (...) bool: at least 3 correspondences
    scale: torch.Tensor    # (...)
    c_src: torch.Tensor    # (..., 3)
    c_tgt: torch.Tensor    # (..., 3)


def gnc_inputs(source: Cloud, target: Cloud, corr_i, corr_j, corr_mask,
               opts: FgrOptions) -> GncInputs:
    """Gather and normalise the correspondences: centred on each cloud's
    centroid and divided by the larger radius (relative scale), or as they
    are (``use_absolute_scale``)."""
    dev = source.device
    p_all = _take_rows(source.points, corr_i)
    q_all = _take_rows(target.points, corr_j)
    w_corr = corr_mask.to(torch.float32).contiguous()
    batch = w_corr.shape[:-1]
    if opts.use_absolute_scale:
        scale = torch.ones(batch, dtype=torch.float32, device=dev)
        c_src = c_tgt = torch.zeros(batch + (3,), dtype=torch.float32, device=dev)
    else:
        c_src, r_src = _center_radius(source.points, source.mask)
        c_tgt, r_tgt = _center_radius(target.points, target.mask)
        scale = torch.clamp(torch.maximum(r_src, r_tgt), min=1e-6)
    # mu starts at the (normalized) global scale squared = 1 in relative-scale
    # mode; in absolute-scale mode at a proxy of the squared extent
    mu0 = (1.0 if not opts.use_absolute_scale
           else opts.maximum_correspondence_distance ** 2 * 1e4)
    return GncInputs(
        p=(p_all - c_src[..., None, :]) / scale[..., None, None],
        q=(q_all - c_tgt[..., None, :]) / scale[..., None, None],
        w=w_corr, mu0=mu0,
        delta=opts.maximum_correspondence_distance / scale,    # normalized stop scale
        enough=torch.sum(w_corr, dim=-1) >= 3,
        scale=scale, c_src=c_src, c_tgt=c_tgt)


def gnc_pose(T_hat: torch.Tensor, inp: GncInputs) -> torch.Tensor:
    """Denormalize the GNC's poses: q = s*(R p_hat + t_hat) + c_tgt with
    p_hat = (p - c_src)/s."""
    R = se3.rot(T_hat)
    return se3.make_pose(R, inp.scale[..., None] * se3.trans(T_hat) + inp.c_tgt
                         - (R @ inp.c_src[..., None])[..., 0])


def fgr_from_correspondences(source: Cloud, target: Cloud, corr_i, corr_j, corr_mask,
                             opts: FgrOptions) -> torch.Tensor:
    """GNC over fixed correspondences; returns the (4, 4) f32 pose.  The
    ``iteration_number`` steps are one launch of kernel K8 on the card
    (``loop_kernels.gnc``) and its plain loop on the CPU; around them the
    normalisation and the denormalisation stay here.

    Stacked pairs (clouds and correspondences with a leading dimension B)
    run the GNC once over the batch and return (B, 4, 4); each pair's
    arithmetic is its own."""
    inp = gnc_inputs(source, target, corr_i, corr_j, corr_mask, opts)
    T = loop_kernels.gnc(inp.p, inp.q, inp.w, inp.mu0, inp.delta, inp.enough,
                         opts.iteration_number, opts.division_factor, opts.decrease_mu)
    return gnc_pose(T, inp)


def _correspondences(source: Cloud, target: Cloud, feat_src, feat_tgt, opts: FgrOptions,
                     seed: int, n_trials: int, max_tuples, u=None):
    """Mutual matching, then the tuple test: (corr_i, corr_j, corr_mask)."""
    corr_i, corr_j, corr_mask = match_features(feat_src, source.mask, feat_tgt, target.mask)
    if opts.tuple_test:
        corr_mask = tuple_test(
            source.points, target.points, corr_i, corr_j, corr_mask, seed,
            tuple_scale=opts.tuple_scale,
            max_tuples=opts.maximum_tuple_count if max_tuples is None else max_tuples,
            n_trials=n_trials, u=u)
    return corr_i, corr_j, corr_mask


@trace.spanned("fgr")
def registration_fgr(source: Cloud, target: Cloud, feat_src, feat_tgt, opts: FgrOptions,
                     seed: int = 0, n_trials: int = 16384,
                     max_tuples: int | None = None,
                     u: torch.Tensor | None = None) -> RegistrationResult:
    """Full FGR: mutual matching -> tuple test -> GNC -> evaluation
    (``models/evaluate.evaluate_registration``, kernel K1).  ``max_tuples``
    overrides ``opts.maximum_tuple_count``; ``u``: optional (n_trials, 3)
    uniforms for the tuple test."""
    corr_i, corr_j, corr_mask = _correspondences(source, target, feat_src, feat_tgt, opts,
                                                 seed, n_trials, max_tuples, u)
    T = fgr_from_correspondences(source, target, corr_i, corr_j, corr_mask, opts)
    fitness, rmse, n_corr = eval_mod.evaluate_registration(
        source, target, opts.maximum_correspondence_distance, T)
    return RegistrationResult(T, fitness, rmse, n_corr,
                              torch.full((), opts.iteration_number, dtype=torch.int32,
                                         device=source.device))


def fgr_features(c: Cloud, voxel_size: float) -> tuple[Cloud, torch.Tensor]:
    """Per-cloud FGR preprocessing: Hybrid(2v, 20) normals and
    Hybrid(10v, 200) FPFH over ONE k=200 self-excluded kNN selection (its
    first 19 columns plus the query itself are the normal neighbourhood).
    Returns (the cloud with normals and covariances, its (N, 33) FPFH)."""
    with trace.span("features", kind="selection", rows=c.capacity):
        d2, idx = knn_ops.knn(c.points, c.points, c.mask, 200, exclude_self=True)
        normals, cov = normals_ops.estimate_normals_hybrid_from_knn(
            c.points, c.mask, d2, idx, 2 * voxel_size, 20)
        feat = fpfh_ops.fpfh(c.points, normals, c.mask, 10 * voxel_size, 200,
                             knn_result=(d2, idx))
    return Cloud(points=c.points, mask=c.mask, normals=normals, covariances=cov), feat


@trace.spanned("fgr")
def batched_registration_fgr(source: Cloud, target: Cloud, feat_src, feat_tgt,
                             opts: FgrOptions, seeds, n_trials: int = 16384,
                             max_tuples=None, u: torch.Tensor | None = None
                             ) -> RegistrationResult:
    """FGR over stacked pairs (leading dimension B), the pair-parallel form of
    stage 1: a ``RegistrationResult`` whose fields lead with B.

    ``seeds``: B tuple-test seeds, one a pair; ``max_tuples``: optional B
    tuple caps, one a pair; ``u``: optional (B, n_trials, 3) uniforms for the
    tuple tests.  Matching, the tuple test and the evaluation (kernel K1) run
    pair by pair; the 300-step GNC runs once over the batch (one launch of
    K8 on the card, a block a pair)."""
    corr = [_correspondences(source[b], target[b], feat_src[b], feat_tgt[b], opts,
                             int(seeds[b]), n_trials,
                             None if max_tuples is None else int(max_tuples[b]),
                             None if u is None else u[b])
            for b in range(len(seeds))]
    corr_i, corr_j, corr_mask = (torch.stack(c) for c in zip(*corr))
    T = fgr_from_correspondences(source, target, corr_i, corr_j, corr_mask, opts)
    evals = [eval_mod.evaluate_registration(source[b], target[b],
                                            opts.maximum_correspondence_distance, T[b])
             for b in range(len(seeds))]
    fitness, rmse, n_corr = (torch.stack(e) for e in zip(*evals))
    return RegistrationResult(T, fitness, rmse, n_corr,
                              torch.full((len(seeds),), opts.iteration_number,
                                         dtype=torch.int32, device=source.device))


def batched_fgr_features(clouds: Cloud, voxel_size: float) -> tuple[Cloud, torch.Tensor]:
    """``fgr_features`` of every scan of a stacked Cloud (leading dimension
    B), one scan after another: (stacked clouds with normals and
    covariances, (B, N, 33) features)."""
    out = [fgr_features(clouds[b], voxel_size) for b in range(clouds.points.shape[0])]
    return stack_clouds([c for c, _ in out]), torch.stack([f for _, f in out])


def stage1_features(c: Cloud, voxel_size: float, kind: str,
                    band: int) -> tuple[Cloud, torch.Tensor]:
    """Stage 1's features of one scan, of ``PipelineConfig.stage1_features``'
    ``kind``: "banded" (``fpfh_sorted.fgr_features_sorted`` at ``band``,
    kernels K4-K6) or "selection" (``fgr_features``).  Any other kind
    raises."""
    if kind == "banded":
        return fpfh_sorted.fgr_features_sorted(c, voxel_size, band=band)
    if kind == "selection":
        return fgr_features(c, voxel_size)
    raise ValueError(f"unknown stage1_features {kind!r}")


def batched_stage1_features(clouds: Cloud, voxel_size: float, kind: str,
                            band: int) -> tuple[Cloud, torch.Tensor]:
    """``stage1_features`` of every scan of a stacked Cloud (leading
    dimension B): ``fpfh_sorted.batched_fgr_features_sorted`` at ``band``
    or ``batched_fgr_features``.  Any other kind raises."""
    if kind == "banded":
        return fpfh_sorted.batched_fgr_features_sorted(clouds, voxel_size, band=band)
    if kind == "selection":
        return batched_fgr_features(clouds, voxel_size)
    raise ValueError(f"unknown stage1_features {kind!r}")


def registro_fgr(source: Cloud, target: Cloud, voxel_size: float,
                 use_absolute_scale: bool = False, seed: int = 0,
                 u: torch.Tensor | None = None) -> RegistrationResult:
    """The reference's ``registro_FGR``: hybrid normals (2v, 20) -> FPFH
    (10v, 200) -> FGR with the script-1 options of the two capacities
    (``u``: optional tuple-test uniforms, as ``registration_fgr``)."""
    src, feat_src = fgr_features(source, voxel_size)
    tgt, feat_tgt = fgr_features(target, voxel_size)
    opts = default_options(src, tgt, voxel_size, use_absolute_scale)
    return registration_fgr(src, tgt, feat_src, feat_tgt, opts, seed=seed, u=u)


def default_options(source: Cloud, target: Cloud, voxel_size: float,
                    use_absolute_scale: bool = False) -> FgrOptions:
    """The script-1 option set, from the two clouds' capacities."""
    n_pts = (int(source.capacity) + int(target.capacity)) // 2   # static proxy
    return default_options_capacity(n_pts, voxel_size, use_absolute_scale)


def default_options_capacity(n_pts: int, voxel_size: float,
                             use_absolute_scale: bool = False) -> FgrOptions:
    """``default_options`` from a capacity alone."""
    return FgrOptions(
        use_absolute_scale=use_absolute_scale,
        maximum_correspondence_distance=2 * voxel_size,
        iteration_number=300,
        maximum_tuple_count=max(int(0.2 * n_pts), 256),
    )
