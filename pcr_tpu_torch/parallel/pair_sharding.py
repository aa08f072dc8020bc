"""Pair-parallel batched registration over the ``pairs`` mesh axis (port of
pcr_tpu/parallel/pair_sharding.py).

Scan pairs are a batch axis: the ``batched_*`` functions loop the
single-pair functions over a stacked batch (as ``fgr.batched_fgr_features``
does; pcr_tpu vmaps them), and the ``sharded_*`` functions give each rank
its contiguous block of the batch, run the batched function on it and
gather the blocks, so every rank returns the whole batch (``parallel/mesh``
states the contract).  The batch must divide by the axis size: pad pairs
with duplicates and drop them afterwards.
"""

from __future__ import annotations

import dataclasses

import torch

from ..models import fgr as fgr_mod
from ..models import gicp as gicp_mod
from ..models import multiscale as ms_mod
from ..utils.cloud import Cloud
from ..utils.collectives import all_gather_rows
from .mesh import Mesh


def stack_results(results: list) -> gicp_mod.RegistrationResult:
    """Per-pair RegistrationResults stacked along a leading batch dim."""
    return gicp_mod.RegistrationResult(*(None if xs[0] is None else torch.stack(list(xs))
                                         for xs in zip(*results)))


def gather_result(res, group):
    """A NamedTuple of per-pair blocks (RegistrationResult, LMResult's
    tensors) gathered over ``group`` in rank order."""
    return type(res)(*(None if x is None else all_gather_rows(x, group) for x in res))


def gather_cloud(c: Cloud, group) -> Cloud:
    """A stacked Cloud's blocks gathered over ``group`` in rank order."""
    return c.with_(**{f.name: None if getattr(c, f.name) is None
                      else all_gather_rows(getattr(c, f.name), group)
                      for f in dataclasses.fields(c)})


def _check_pairs(mesh: Mesh, batch: int, what: str = "pair batch") -> slice:
    """This rank's block of the batch, or pcr_tpu's ValueError."""
    n_dev = mesh.shape["pairs"]
    if batch % n_dev != 0:
        raise ValueError(f"{what} {batch} not divisible by mesh axis {n_dev}")
    return mesh.block("pairs", batch)


def batched_gicp(src: Cloud, tgt: Cloud, T_init, max_corr_dist, **kw):
    """Single-pair GICP over a leading batch dim of stacked Clouds."""
    return stack_results([gicp_mod.registration_gicp(src[b], tgt[b], max_corr_dist, T_init[b],
                                                     **kw)
                          for b in range(src.points.shape[0])])


def batched_mgicp(src: Cloud, tgt: Cloud, T_init, **kw):
    """The multiscale pyramid (``multiscale.multiscale_gicp``: pyramids built
    per pair) over stacked pairs."""
    return stack_results([ms_mod.multiscale_gicp(src[b], tgt[b], T_init[b], **kw)
                          for b in range(src.points.shape[0])])


def sharded_mgicp(mesh: Mesh, src: Cloud, tgt: Cloud, T_init, **kw):
    """``batched_mgicp`` with the pairs sharded over 'pairs'."""
    sl = _check_pairs(mesh, T_init.shape[0])
    return gather_result(batched_mgicp(src[sl], tgt[sl], T_init[sl], **kw), mesh.group("pairs"))


def sharded_fgr(mesh: Mesh, src: Cloud, tgt: Cloud, feat_src, feat_tgt, seeds, opts,
                n_trials: int = 16384, max_tuples=None, u: torch.Tensor | None = None):
    """Stage-1 FGR (``fgr.batched_registration_fgr``: one GNC over a rank's
    block) with the pairs sharded over 'pairs'.  ``seeds``, the optional
    per-pair ``max_tuples`` caps and the optional tuple-test uniforms ``u``
    are sharded with the pairs."""
    sl = _check_pairs(mesh, len(seeds))
    if max_tuples is None:
        max_tuples = [opts.maximum_tuple_count] * len(seeds)
    res = fgr_mod.batched_registration_fgr(
        src[sl], tgt[sl], feat_src[sl], feat_tgt[sl], opts, seeds[sl], n_trials,
        max_tuples[sl], None if u is None else u[sl])
    return gather_result(res, mesh.group("pairs"))


def sharded_fgr_features(mesh: Mesh, clouds: Cloud, voxel_size, features: str = "banded",
                         band: int = 2048):
    """Per-scan stage-1 features (normals + FPFH) with the scans of a stack
    sharded over 'pairs'; returns (stacked clouds, (S, N, 33) features)
    replicated.  ``features``: 'banded' (``fpfh_sorted``, kernels K4-K6) or
    'selection' (``fgr.fgr_features``), chosen by
    ``fgr.batched_stage1_features``.  The scan batch must divide by the axis
    size (pad by repeating a scan)."""
    sl = _check_pairs(mesh, clouds.points.shape[0], "scan batch")
    c, f = fgr_mod.batched_stage1_features(clouds[sl], voxel_size, features, band)
    group = mesh.group("pairs")
    return gather_cloud(c, group), all_gather_rows(f, group)


def sharded_batched_gicp(mesh: Mesh, src: Cloud, tgt: Cloud, T_init, max_corr_dist, **kw):
    """``batched_gicp`` (single-scale GICP) with the pairs sharded over
    'pairs'."""
    sl = _check_pairs(mesh, T_init.shape[0])
    return gather_result(batched_gicp(src[sl], tgt[sl], T_init[sl], max_corr_dist, **kw),
                         mesh.group("pairs"))
