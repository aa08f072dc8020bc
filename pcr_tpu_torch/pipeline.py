"""The circuit runners (port of pcr_tpu/pipeline.py): stage 1 (its streamed
``batch_size=1`` and batched ``batch_size > 1`` branches on one card), stage 2
(streamed at every batch size), stage 3 and ``run_full``, stages 1 to 3 in one
window, the main path.

Stage contract, kept from the reference: every stage persists poses as
``pose_{i+1}_{i}.txt`` / ``pose{i}.txt`` text files and the next stage reloads
them, so the pipeline is restartable at stage granularity.

  stage 1  FGR over all circuit pairs (banded features, ``ops/fpfh_sorted``,
           the default, or the selection features, ``models/fgr``)
  stage 2  M-GICP refinement of the stage-1 poses; a pair that fails its
           fitness gate is re-registered by the FGR retry ladder
  stage 3  global refinement: LUM / SLERP / SLERP+LUM (host float64) and the
           pose-graph LM over band-NN information matrices (on the card)

The streamed loops (``run_full``'s, and the staged runners' at
``batch_size`` 1 and stage 2's at every batch size) share one window of
pairs in flight (``_stream_pairs``), one per-scan cache class
(``_ScanCache``) and one retry pass (``_retry_failures``).

Each runner takes the clouds it is given (a list of port Clouds, or a
``cloud.LazyClouds``, on one device, where the run happens) or, with
``clouds=None``, loads the dataset's PCD scans onto the CUDA card
(``_load_circuit_clouds``; streamed through a ``LazyClouds`` above 32 scans).
``run_pair`` registers one scan pair; ``python -m pcr_tpu_torch`` is the CLI
over all of them.

Device meshes (``parallel/``, one process a device): ``mesh=`` of the staged
runners shards the pairs over the mesh's 'pairs' axis (and, on a 2-D mesh,
each pair's source rows over 'points' in stage 2), ``mesh=`` of ``run_full``
(a pair mesh) runs them and then stage 3 on rank 0, ``point_mesh=`` of
``run_pair`` shards the pair's source rows.  Every rank runs the runner on
the same inputs and returns the same poses; only rank 0 writes pose files,
metrics and checkpoints, and every rank waits for the others before it
returns.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import json
import os
import time

import numpy as np
import torch

from .models import evaluate as eval_mod
from .models import fgr as fgr_mod
from .models import multiscale as ms_mod
from .models.global_refine import closed_form
from .models.global_refine import pose_graph as pg_mod
from .parallel import mesh as mesh_mod
from .utils import cloud as cloud_mod
from .utils import collectives, poses_io, se3, trace


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """The fields of ``pcr_tpu.pipeline.PipelineConfig`` that the ported
    branches read, with the same defaults (the reference's constants), and
    ``fgr_iterations``, which neither package reads."""

    dataset: str = "Facade"
    voxel_size: float = 0.1
    # Read by neither package: the GNC always runs the reference's 300 steps.
    # Kept so that a configuration written for pcr_tpu constructs here too.
    fgr_iterations: int = 300
    fgr_seed: int = 0
    mgicp_scales: int = 5
    mgicp_iterations: int = 100
    fitness_gate: float = 0.40      # the reference's success gate on gate fitness
    # Re-registration fallback: a pair whose refined finest-scale fitness
    # lands at/below retry_fitness is re-seeded with FGR at coarser voxels
    # (coarse FPFH is far more robust for low-overlap loop closures) and
    # re-refined; candidates are compared by full-cloud fitness at 2*voxel.
    retry_failed: bool = True
    retry_fitness: float = 0.15
    retry_voxel_mults: tuple = (2.0, 4.0)
    batch_size: int = 2
    # pairs registered ahead of the oldest result read
    inflight: int = 4
    # "auto": plan the tightest safe capacities from the clouds
    # (cloud.plan_scale_caps); a tuple pins them; None disables compaction.
    scale_capacities: tuple | str | None = "auto"
    # rounding unit of the per-scan capacity buckets of stage 1
    bucket_granularity: int = 4096
    # stage-1 features: "banded" (ops/fpfh_sorted, kernels K4-K6) or
    # "selection" (the k=200 selection + gather path, models/fgr.fgr_features)
    stage1_features: str = "banded"
    stage1_band: int = 2048
    output_root: str = "outputs"

    def out_dir(self, stage: str) -> str:
        return os.path.join(self.output_root, stage, self.dataset)


def circuit_pairs(n: int) -> list[tuple[int, int]]:
    """(source, target) scan indices of the closed circuit: (1,0), (2,1),
    ..., (0, n-1)."""
    return [((i + 1) % n, i) for i in range(n)]


class PairMetrics:
    """Per-pair structured metrics log.

    A row's ``seconds``: in the streamed loops (``run_full``, and the
    staged runners at ``batch_size`` 1) the pair's latency from the host's
    first launch for it to the end of its read, ``inflight`` pairs later,
    plus the retry ladder's wall when the pair was retried; in the batched
    stage 1 its chunk's wall over the chunk's pairs; in ``run_pair`` the
    wall of the stage, reads included."""

    def __init__(self):
        self.rows = []

    def add(self, stage, src, tgt, fitness, rmse, seconds, **extra):
        self.rows.append(
            dict(stage=stage, src=int(src), tgt=int(tgt), fitness=float(fitness),
                 rmse=float(rmse), seconds=float(seconds), **extra))

    def save(self, path, stage: str | None = None):
        """Write rows as jsonl; ``stage`` keeps only that stage's rows."""
        rows = self.rows if stage is None else [r for r in self.rows if r["stage"] == stage]
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as fh:
            for row in rows:
                fh.write(json.dumps(row) + "\n")

    def success_rate(self, gate: float, key: str = "fitness",
                     stage: str | None = None) -> float:
        """Fraction of pairs whose ``key`` exceeds ``gate`` (for stage 2 use
        key='gate_fitness', the full-cloud fitness at 2*voxel)."""
        rows = [r for r in self.rows
                if (stage is None or r["stage"] == stage) and key in r]
        if not rows:
            return 0.0
        return sum(1 for r in rows if r[key] > gate) / len(rows)


def _load_circuit_clouds(cfg: PipelineConfig, indices=None, device=None):
    """The dataset loader of the circuit runners, onto ``device`` (default:
    the CUDA card).  Large circuits stream: every scan is parsed on the host
    and uploaded lazily inside the compute loop (``cloud.LazyClouds``)
    instead of ~380 MB of padded NCLT scans up front."""
    idx = list(indices) if indices is not None else list(
        range(poses_io.CIRCUIT_SIZES[cfg.dataset]))
    if len(idx) > 32:
        return cloud_mod.load_dataset_lazy(cfg.dataset, indices=idx, device=device)
    return cloud_mod.load_dataset(cfg.dataset, indices=idx, device=device)


def _buckets(clouds, n: int, granularity: int) -> list[int]:
    """Every scan's capacity bucket, read up front: on a device cloud each
    read waits for the device, so none may fall inside a pipelined loop.  A
    LazyClouds is read from its host clouds, with no upload."""
    if isinstance(clouds, cloud_mod.LazyClouds):
        clouds = list(clouds)
    return [cloud_mod.bucket_capacity(clouds[i], granularity) for i in range(n)]


# Pairs stacked into one batched evaluation call (pcr_tpu's max(batch_size, 4)
# at its default batch_size): on one card the pairs of a call run one after
# another, so the chunk bounds the stacked copies, not the results.
PAIR_CHUNK = 4


def _chunks(n: int, size: int = PAIR_CHUNK) -> list[list[int]]:
    return [list(range(s, min(s + size, n))) for s in range(0, n, size)]


def _writes(mesh) -> bool:
    """True when this rank writes the runner's files: without a mesh, or on
    rank 0 of one.  A mesh that is not a ``parallel.mesh.Mesh`` is refused."""
    if mesh is None:
        return True
    if not isinstance(mesh, mesh_mod.Mesh):
        raise TypeError(f"a mesh must be a parallel.mesh.Mesh, got {type(mesh).__name__}")
    return mesh_mod.rank() == 0


def _prep_features(c, bucket: int, voxel: float, band: int, features_kind: str = "banded"):
    """Per-scan stage-1 preprocessing: compact to the scan's capacity bucket,
    then the banded or the selection normals + FPFH
    (``fgr.stage1_features``)."""
    return fgr_mod.stage1_features(cloud_mod.compact(c, bucket), voxel, features_kind, band)


def _pad_pair(src_f, feat_src, tgt_f, feat_tgt, B: int):
    """Pad a pair's clouds and features (zero rows, masked) to the pair
    bucket B."""
    return (cloud_mod.pad_to(src_f, B), cloud_mod.pad_rows(feat_src, B, 0.0),
            cloud_mod.pad_to(tgt_f, B), cloud_mod.pad_rows(feat_tgt, B, 0.0))


def _fgr_pair_step(src_f, feat_src, tgt_f, feat_tgt, seed: int, B: int, opts):
    """Per-pair stage-1 step: pad both scans to the pair bucket, then FGR."""
    src_p, fs, tgt_p, ft = _pad_pair(src_f, feat_src, tgt_f, feat_tgt, B)
    return fgr_mod.registration_fgr(src_p, tgt_p, fs, ft, opts, seed=seed)


class _ScanCache(dict):
    """A streamed runner's per-scan features or pyramids: scan i's is built
    by ``build(i)`` on its first lookup.  Pair (s, s-1) is followed by pair
    (s+1, s), so after it ``evict(s)`` keeps only scans s and s+1."""

    def __init__(self, n: int, build):
        super().__init__()
        self._n, self._build = n, build

    def __missing__(self, i: int):
        self[i] = self._build(i)
        return self[i]

    def evict(self, s: int) -> None:
        for i in [i for i in self if i not in (s, (s + 1) % self._n)]:
            del self[i]


def _stream_pairs(ks, submit, read, row, inflight: int, checkpoint=None) -> None:
    """The streamed runners' window: ``submit(k)`` launches pair k and
    returns its device results, and the oldest pair is read once
    ``max(inflight, 1)`` are in flight (the rest at the end), so each read
    overlaps the next pairs' work.  ``read(k, results)`` runs in the ``sync``
    span and its host values go to ``row(k, results, values, seconds)``,
    seconds from submission to the end of the read (the ``pair`` span).
    ``checkpoint(m)``, if given, runs after every 50th pair read."""
    window = collections.deque()
    n_read = 0

    def read_oldest():
        nonlocal n_read
        k, t_submit, results = window.popleft()
        with trace.span("sync", site="drain"):
            values = read(k, results)
        t_read = time.time_ns()
        trace.record("pair", t_submit, t_read, k=k)
        row(k, results, values, (t_read - t_submit) * 1e-9)
        n_read += 1
        if checkpoint is not None and n_read % 50 == 0:
            checkpoint(n_read)

    for k in ks:
        t_submit = time.time_ns()
        window.append((k, t_submit, submit(k)))
        while len(window) >= max(inflight, 1):
            read_oldest()
    while window:
        read_oldest()


def _partial_checkpoint(cfg: PipelineConfig, metrics: PairMetrics, stage1=None, stage2=None):
    """``_stream_pairs``' crash-resumable checkpoint: after m pairs read, the
    first m poses of each stage given (``<stage>_partial.npy``) and its
    rows.  Only a rank that writes passes one, and its pairs start at 0."""
    def save(m: int) -> None:
        d = cfg.out_dir("metrics")
        os.makedirs(d, exist_ok=True)
        for name, stage, out in (("stage1", "fgr", stage1), ("stage2", "mgicp", stage2)):
            if out is not None:
                np.save(os.path.join(d, f"{name}_partial.npy"), out[:m])
                metrics.save(os.path.join(d, f"{name}.jsonl"), stage=stage)
    return save


def run_stage1_fgr(cfg: PipelineConfig, clouds=None, n: int | None = None,
                   metrics: PairMetrics | None = None, mesh=None) -> np.ndarray:
    """FGR over all circuit pairs; returns (n, 4, 4) f64 relative poses and
    writes them (``relative_poses_FGR``) and the metrics.

    ``clouds`` (default: the dataset's scans, loaded onto the card) are on
    one device, which is where the run happens.  With ``batch_size`` 1 each
    scan's features (normals + FPFH) are computed once at its own capacity
    bucket and shared by the two pairs it serves; a pair runs at the larger
    of its two buckets.  With ``batch_size`` > 1 pairs run in chunks
    (``_run_stage1_fgr_batched``), and so they do with a ``mesh``, each chunk
    sharded over its 'pairs' axis."""
    _writes(mesh)    # refuses a mesh that is not a Mesh
    n = n or poses_io.CIRCUIT_SIZES[cfg.dataset]
    if clouds is None:
        clouds = _load_circuit_clouds(cfg, range(n))
    metrics = metrics if metrics is not None else PairMetrics()
    if cfg.batch_size > 1 or mesh is not None:
        return _run_stage1_fgr_batched(cfg, clouds, n, metrics, mesh)
    buckets = _buckets(clouds, n, cfg.bucket_granularity)
    features = _ScanCache(n, lambda i: _prep_features(
        clouds[i], buckets[i], cfg.voxel_size, cfg.stage1_band, cfg.stage1_features))
    pairs = circuit_pairs(n)
    out = np.zeros((n, 4, 4))

    def submit(k):
        s, t = pairs[k]
        (src, feat_src), (tgt, feat_tgt) = features[s], features[t]
        B = max(src.capacity, tgt.capacity)
        opts = fgr_mod.default_options_capacity(B, cfg.voxel_size)
        res = _fgr_pair_step(src, feat_src, tgt, feat_tgt, cfg.fgr_seed + s, B, opts)
        features.evict(s)
        return res

    def read(k, res):
        out[k] = res.transformation.double().cpu().numpy()
        return float(res.fitness), float(res.inlier_rmse)

    def row(k, res, values, seconds):
        metrics.add("fgr", *pairs[k], *values, seconds)

    _stream_pairs(range(n), submit, read, row, cfg.inflight,
                  _partial_checkpoint(cfg, metrics, stage1=out))
    _flag_stage1_outliers(out, metrics)
    poses_io.save_relative_circuit(cfg.out_dir("relative_poses_FGR"), out)
    metrics.save(os.path.join(cfg.out_dir("metrics"), "stage1.jsonl"), stage="fgr")
    return out


def _flag_stage1_outliers(poses: np.ndarray, metrics: PairMetrics, window: int = 10,
                          factor: float = 3.0, slack_m: float = 0.5) -> int:
    """Mark suspect stage-1 pairs in the metrics log.

    A circuit's per-pair translation magnitudes vary smoothly, so a pair
    whose ``|t|`` exceeds ``factor`` x the median of its +-window circuit
    neighbours (plus an absolute slack) is flagged ``stage1_outlier``.  Every
    fgr row gains ``t_norm_m``.  Returns the number of flagged pairs."""
    t = np.linalg.norm(np.asarray(poses)[:, :3, 3], axis=1)
    n = len(t)
    off = [d for d in range(-window, window + 1) if d != 0]
    idx = (np.arange(n)[:, None] + np.asarray(off)[None, :]) % n
    med = np.median(t[idx], axis=1)
    flagged = t > np.maximum(factor * med, med + slack_m)
    rows = {(r["src"], r["tgt"]): r for r in metrics.rows if r["stage"] == "fgr"}
    count = 0
    for k, (s, tg) in enumerate(circuit_pairs(n)):
        r = rows.get((s, tg))
        if r is None:
            continue
        r["t_norm_m"] = float(t[k])
        if flagged[k]:
            r["stage1_outlier"] = True
            count += 1
    return count


def _run_stage1_fgr_batched(cfg: PipelineConfig, clouds, n: int,
                            metrics: PairMetrics, mesh=None) -> np.ndarray:
    """Pair-parallel stage 1 (pcr_tpu's batched branch).  A chunk of B =
    ``batch_size`` consecutive circuit pairs touches B+1 consecutive-mod-n
    scans: they are compacted to the largest capacity bucket among them,
    featurized once each, and the chunk's pairs register in one batched FGR
    call (``fgr.batched_registration_fgr``: one GNC over the batch).  Each
    pair keeps the streamed branch's seed (fgr_seed + source scan) and its
    tuple cap, 0.2 x the larger of its two scans' buckets; the other options
    are ``default_options`` of scan 0.  The tail chunk repeats its last pair
    up to B; the repeats are dropped.  A checkpoint is written every chunk,
    and each pair's ``seconds`` is its chunk's wall over its real pairs.

    With a ``mesh`` B is rounded up to a multiple of its 'pairs' axis; the
    chunk's scan stack, padded by repeating its last scan to a multiple of
    the axis, is featurized sharded over it (``sharded_fgr_features``) and
    the pairs register sharded (``sharded_fgr``)."""
    from .parallel import pair_sharding

    writes = _writes(mesh)
    B = max(cfg.batch_size, 1)
    if mesh is not None:
        ndev = mesh.shape["pairs"]
        B = mesh_mod.pad_to_multiple(max(B, ndev), ndev)
    opts = fgr_mod.default_options(clouds[0], clouds[0], cfg.voxel_size)
    buckets = _buckets(clouds, n, cfg.bucket_granularity)
    out = np.zeros((n, 4, 4))
    ckpt = os.path.join(cfg.out_dir("metrics"), "stage1_partial.npy")
    for start in range(0, n, B):
        t0 = time.time()
        m = min(B, n - start)  # real pairs in this chunk
        scan_ids = [(start + j) % n for j in range(m + 1)]
        cap = max(buckets[i] for i in scan_ids)
        scans = [cloud_mod.compact(clouds[i], cap) for i in scan_ids]
        if mesh is not None:   # the scan stack fills the 'pairs' axis
            scans += scans[-1:] * ((-len(scans)) % ndev)
        stacked = cloud_mod.stack_clouds(scans)
        if mesh is not None:
            feat_clouds, feats = pair_sharding.sharded_fgr_features(
                mesh, stacked, cfg.voxel_size, features=cfg.stage1_features,
                band=cfg.stage1_band)
        else:
            feat_clouds, feats = fgr_mod.batched_stage1_features(
                stacked, cfg.voxel_size, cfg.stage1_features, cfg.stage1_band)
        # pair j of the chunk: source = scan slot j+1, target = slot j
        src_pos = [min(j + 1, m) for j in range(B)]
        tgt_pos = [min(j, m - 1) for j in range(B)]
        max_tuples = [max(int(0.2 * max(buckets[scan_ids[a]], buckets[scan_ids[b]])), 256)
                      for a, b in zip(src_pos, tgt_pos)]
        seeds = [cfg.fgr_seed + scan_ids[a] for a in src_pos]
        pair_args = (feat_clouds[src_pos], feat_clouds[tgt_pos], feats[src_pos], feats[tgt_pos])
        if mesh is None:
            res = fgr_mod.batched_registration_fgr(*pair_args, opts, seeds, max_tuples=max_tuples)
        else:
            res = pair_sharding.sharded_fgr(mesh, *pair_args, seeds, opts, max_tuples=max_tuples)
        T = res.transformation.double().cpu().numpy()
        fit, rmse = res.fitness.cpu().numpy(), res.inlier_rmse.cpu().numpy()
        dt = (time.time() - t0) / m
        for j in range(m):
            out[start + j] = T[j]
            metrics.add("fgr", scan_ids[j + 1], scan_ids[j], float(fit[j]), float(rmse[j]), dt)
        if writes:
            os.makedirs(os.path.dirname(ckpt), exist_ok=True)
            np.save(ckpt, out[: start + m])  # crash-resumable partial checkpoint
    _flag_stage1_outliers(out, metrics)
    if writes:
        poses_io.save_relative_circuit(cfg.out_dir("relative_poses_FGR"), out)
        metrics.save(os.path.join(cfg.out_dir("metrics"), "stage1.jsonl"), stage="fgr")
    if mesh is not None:
        collectives.barrier()
    return out


@trace.spanned("retry")
def _retry_pair(cfg: PipelineConfig, src_c, tgt_c, res0, src_pyr, tgt_pyr,
                seed_base: int = 0):
    """Re-registration ladder: for each multiplier m, FGR on the full clouds
    at m*voxel (``registro_fgr``, selection features), then M-GICP over the
    cached pyramids; candidates are compared by full-cloud fitness at
    2*voxel (finest-scale fitness is not comparable across seeds at low
    overlap).  Returns (best result, status, its gate score)."""
    eval_dist = 2 * cfg.voxel_size

    def score(T):
        fit, _, _ = eval_mod.evaluate_registration(src_c, tgt_c, eval_dist, T)
        with trace.span("sync", site="gate"):
            return float(fit)

    best_res, best_score, status = res0, score(res0.transformation), "ok"
    for m in cfg.retry_voxel_mults:
        res_fgr = fgr_mod.registro_fgr(src_c, tgt_c, m * cfg.voxel_size,
                                       seed=cfg.fgr_seed + seed_base + 1)
        cand = ms_mod.multiscale_gicp_pyramids(src_pyr, tgt_pyr, res_fgr.transformation,
                                               n_scales=cfg.mgicp_scales,
                                               iterations=cfg.mgicp_iterations)
        sc = score(cand.transformation)
        if sc > best_score:
            best_res, best_score, status = cand, sc, f"retried_voxel_x{m:g}"
    if float(best_res.fitness) <= cfg.retry_fitness:
        status += ",low_fitness"
    return best_res, status, best_score


def _retry_failures(cfg: PipelineConfig, clouds, pyramids: _ScanCache, failures,
                    out: np.ndarray, metrics: PairMetrics) -> None:
    """The retry ladder's second pass over the failed pairs, ``(k, index of
    its stage-2 row, result)`` each: ``out[k]`` and the row are replaced by
    ``_retry_pair``'s, the row's seconds gain the ladder's wall."""
    for k, row, res0 in failures:
        s, t = metrics.rows[row]["src"], metrics.rows[row]["tgt"]
        t0 = time.time()
        res, status, gate_sc = _retry_pair(cfg, clouds[s], clouds[t], res0,
                                           pyramids[s], pyramids[t], seed_base=s)
        with trace.span("sync", site="retry"):
            out[k] = res.transformation.double().cpu().numpy()
            fit, rmse, its = (float(res.fitness), float(res.inlier_rmse),
                              res.scale_iterations.tolist())
        metrics.rows[row] = dict(
            stage="mgicp", src=int(s), tgt=int(t), fitness=fit, rmse=rmse,
            seconds=metrics.rows[row]["seconds"] + (time.time() - t0),
            status=status, scale_iterations=its, gate_fitness=float(gate_sc))
        pyramids.evict(s)


def _annotate_gate_fitness(cfg: PipelineConfig, clouds, pairs, poses,
                           metrics: PairMetrics) -> np.ndarray:
    """Full-cloud fitness at 2*voxel for every refined pair (band-NN
    evaluation); each pair's metrics row gains a ``gate_fitness``."""
    eval_dist = 2 * cfg.voxel_size
    fit = [eval_mod.evaluate_registration_batch(
        cloud_mod.stack_clouds([clouds[pairs[k][0]] for k in idx]),
        cloud_mod.stack_clouds([clouds[pairs[k][1]] for k in idx]), eval_dist,
        np.asarray(poses[idx], np.float32))[0] for idx in _chunks(len(pairs))]
    with trace.span("sync", site="gate"):
        gate = np.concatenate([f.double().cpu().numpy() for f in fit])
    row_for = {(r["src"], r["tgt"]): i for i, r in enumerate(metrics.rows)
               if r["stage"] == "mgicp"}
    for k, (s, t) in enumerate(pairs):
        if (s, t) in row_for:
            metrics.rows[row_for[(s, t)]]["gate_fitness"] = float(gate[k])
    return gate


def run_stage2_mgicp(cfg: PipelineConfig, init_poses: np.ndarray | None = None,
                     clouds=None, n: int | None = None, mesh=None,
                     metrics: PairMetrics | None = None) -> np.ndarray:
    """M-GICP refinement of the stage-1 poses over all circuit pairs.

    ``clouds`` (default: the dataset's scans, loaded onto the card) are on
    one device, which is where the run happens; ``init_poses`` (n, 4, 4) or
    the stage-1 pose files.
    Pairs stream one at a time over per-cloud pyramids that are built once
    and shared by the two pairs each cloud serves; pairs whose fitness lands
    at/below the retry gate are collected and re-registered by the retry
    ladder in a second pass, so the main loop never stalls on one.  Returns
    (n, 4, 4) f64 relative poses and writes them, the absolute chain and the
    metrics.

    Every ``batch_size`` runs this streamed branch: pcr_tpu's batched branch
    (chunks of pairs, each building its own pyramids) computes the same
    poses, since a cloud's pyramid does not depend on the pair it serves.
    So does its mesh branch: with a ``mesh`` every rank runs this loop over
    its contiguous block of the pairs (the 'pairs' axis), its retries and
    gate scores included, and the blocks' poses and metrics rows are
    gathered to every rank.  On a (pairs, points) mesh every scale's GICP
    also splits the pair's source rows over 'points'
    (``point_sharding.point_sharded_multiscale_gicp``).
    """
    writes = _writes(mesh)
    n = n or poses_io.CIRCUIT_SIZES[cfg.dataset]
    if clouds is None:
        clouds = _load_circuit_clouds(cfg, range(n))
    if init_poses is None:
        init_poses = poses_io.load_relative_circuit(cfg.out_dir("relative_poses_FGR"), n)
    metrics = metrics if metrics is not None else PairMetrics()
    pairs = circuit_pairs(n)
    caps = cfg.scale_capacities
    if caps == "auto":
        caps = cloud_mod.plan_scale_caps(clouds, ms_mod.create_scales(cfg.mgicp_scales))
    mine = slice(0, n)
    refine = ms_mod.multiscale_gicp_pyramids
    if mesh is not None:
        mine = mesh.block("pairs", n)
        if "points" in mesh.axis_names:
            from .parallel import point_sharding

            refine = functools.partial(point_sharding.point_sharded_multiscale_gicp, mesh)
    first_row = len(metrics.rows)
    out = np.zeros((n, 4, 4))
    pyramids = _ScanCache(n, lambda i: ms_mod.build_pyramid(
        clouds[i], n_scales=cfg.mgicp_scales, scale_capacities=caps))
    failures: list[tuple] = []

    def submit(k):
        s, t = pairs[k]
        res = refine(pyramids[s], pyramids[t], np.asarray(init_poses[k], np.float32),
                     n_scales=cfg.mgicp_scales, iterations=cfg.mgicp_iterations)
        pyramids.evict(s)
        return res

    def read(k, res):
        fit = float(res.fitness)
        out[k] = res.transformation.double().cpu().numpy()
        return fit, float(res.inlier_rmse), res.scale_iterations.tolist()

    def row(k, res, values, seconds):
        fit, rmse, its = values
        if cfg.retry_failed and fit <= cfg.retry_fitness:
            failures.append((k, len(metrics.rows), res))
        metrics.add("mgicp", *pairs[k], fit, rmse, seconds, status="ok", scale_iterations=its)

    _stream_pairs(range(mine.start, mine.stop), submit, read, row, cfg.inflight,
                  _partial_checkpoint(cfg, metrics, stage2=out) if writes else None)
    _retry_failures(cfg, clouds, pyramids, failures, out, metrics)
    # the retried rows' gate_fitness, the ladder's score, is overwritten here
    _annotate_gate_fitness(cfg, clouds, pairs[mine], out[mine], metrics)
    if mesh is not None:   # every rank gets every block; rank order is pair order
        parts = collectives.all_gather_objects((mine, out[mine], metrics.rows[first_row:]),
                                               mesh.group("pairs"))
        metrics.rows[first_row:] = [row for _, _, rows in parts for row in rows]
        for block, poses, _ in parts:
            out[block] = poses
    if writes:
        poses_io.save_relative_circuit(cfg.out_dir("relative_poses_FGR_GICP"), out)
        poses_io.save_absolute_poses(cfg.out_dir("absolute_poses_FGR_GICP"),
                                     se3.relative_to_absolute(out))
        metrics.save(os.path.join(cfg.out_dir("metrics"), "stage2.jsonl"), stage="mgicp")
    if mesh is not None:
        collectives.barrier()
    return out


@trace.spanned("run_pair")
def run_pair(cfg: PipelineConfig, src_i: int, tgt_i: int, init: np.ndarray | str = "fgr",
             metrics: PairMetrics | None = None, point_mesh=None, device=None) -> dict:
    """Register ONE scan pair end to end: [FGR ->] M-GICP -> information matrix.

    The single-pair workflow for datasets whose circuit is incomplete on disk
    (Courtyard ships 2 of 8 scans).  The two scans are loaded onto ``device``
    (default: the CUDA card).  ``init``: 'fgr' runs stage-1 FGR first, each
    scan featurized at its own capacity bucket and the pair padded to the
    larger one, seeded with fgr_seed + src_i; 'fixture' takes the seed from
    the shipped absolute FGR_GICP fixtures (inv(A_tgt) @ A_src); or a 4x4
    array.  Writes ``pose_{src}_{tgt}.txt`` and ``metrics/pair_{src}_{tgt}.jsonl``.
    Returns {"src", "tgt", "dataset", ["fgr_fitness"], "T", "fitness", "rmse",
    "mgicp_seconds", "seconds", "info_trace"[, "point_mesh"]}.  ``point_mesh``:
    a 'points' mesh (``parallel.mesh.make_point_mesh``); the M-GICP runs
    with the source rows sharded over its ranks
    (``point_sharding.point_sharded_multiscale_gicp``) from rank 0's seed."""
    writes = _writes(point_mesh)
    metrics = metrics if metrics is not None else PairMetrics()
    src_c, tgt_c = cloud_mod.load_dataset(cfg.dataset, indices=[src_i, tgt_i], device=device)
    out: dict = {"src": src_i, "tgt": tgt_i, "dataset": cfg.dataset}
    t0 = time.time()
    if isinstance(init, str) and init == "fgr":
        # both buckets read before the first launch, so neither read waits on it
        buckets = [cloud_mod.bucket_capacity(c) for c in (src_c, tgt_c)]
        (src_f, feat_s), (tgt_f, feat_t) = (
            _prep_features(c, b, cfg.voxel_size, cfg.stage1_band, cfg.stage1_features)
            for c, b in zip((src_c, tgt_c), buckets))
        B = max(src_f.capacity, tgt_f.capacity)
        res_fgr = _fgr_pair_step(src_f, feat_s, tgt_f, feat_t, cfg.fgr_seed + src_i, B,
                                 fgr_mod.default_options_capacity(B, cfg.voxel_size))
        with trace.span("sync", site="run_pair"):
            T0 = res_fgr.transformation.double().cpu().numpy()
            fit, rmse = float(res_fgr.fitness), float(res_fgr.inlier_rmse)
        out["fgr_fitness"] = fit
        metrics.add("fgr", src_i, tgt_i, fit, rmse, time.time() - t0)
    elif isinstance(init, str) and init == "fixture":
        A = poses_io.load_reference_absolute(cfg.dataset)
        T0 = np.linalg.inv(A[tgt_i]) @ A[src_i]
    else:
        T0 = np.asarray(init, np.float64)
    caps = cfg.scale_capacities
    if caps == "auto":
        caps = cloud_mod.plan_scale_caps([src_c, tgt_c], ms_mod.create_scales(cfg.mgicp_scales))
    t1 = time.time()
    if point_mesh is not None:
        from .parallel import point_sharding

        # every rank starts from the same bits: a pose the ranks computed
        # apart may differ in its last bits on other cards
        T0 = collectives.broadcast(torch.as_tensor(np.asarray(T0, np.float64),
                                                   device=src_c.device)).cpu().numpy()
        pyr_s, pyr_t = (ms_mod.build_pyramid(c, n_scales=cfg.mgicp_scales,
                                             scale_capacities=caps) for c in (src_c, tgt_c))
        res = point_sharding.point_sharded_multiscale_gicp(
            point_mesh, pyr_s, pyr_t, np.asarray(T0, np.float32), n_scales=cfg.mgicp_scales,
            iterations=cfg.mgicp_iterations)
        out["point_mesh"] = int(point_mesh.shape["points"])
    else:
        res = ms_mod.multiscale_gicp(src_c, tgt_c, np.asarray(T0, np.float32),
                                     n_scales=cfg.mgicp_scales, iterations=cfg.mgicp_iterations,
                                     scale_capacities=caps)
    with trace.span("sync", site="run_pair"):
        T = res.transformation.double().cpu().numpy()
        fit, rmse = float(res.fitness), float(res.inlier_rmse)
    out.update(T=T.tolist(), fitness=fit, rmse=rmse,
               mgicp_seconds=round(time.time() - t1, 3), seconds=round(time.time() - t0, 3))
    metrics.add("mgicp", src_i, tgt_i, fit, rmse, time.time() - t1)
    info = eval_mod.information_matrix(tgt_c, src_c, cfg.voxel_size,
                                       se3.invert(T).astype(np.float32))
    with trace.span("sync", site="run_pair"):
        out["info_trace"] = float(torch.trace(info))
    if writes:
        with trace.span("write"):
            poses_io.save_pose(os.path.join(cfg.out_dir("relative_poses_FGR_GICP"),
                                            f"pose_{src_i}_{tgt_i}.txt"), T)
            metrics.save(os.path.join(cfg.out_dir("metrics"), f"pair_{src_i}_{tgt_i}.jsonl"))
    if point_mesh is not None:
        collectives.barrier()
    return out


@trace.spanned("run_full")
def run_full(cfg: PipelineConfig, clouds=None, n: int | None = None,
             metrics: PairMetrics | None = None,
             methods=("LUM", "SLERP", "SLERP_LUM", "pose_graph"), mesh=None) -> dict:
    """Stages 1 -> 3, with stage 2 streamed behind stage 1 in one window:
    the main path.  With a pair ``mesh`` the staged runners, sharded over it
    (``_run_full_mesh``).

    Per pair: FGR on the two scans' cached banded (or selection) features,
    then M-GICP over their cached pyramids seeded from the FGR pose as it
    lies on the card (no host read between), then the gate evaluation at
    2*voxel on the padded feature clouds.  Results are read ``cfg.inflight``
    pairs behind, so each read overlaps the next pairs' work.  The stage
    contract is the staged runners': both stages' pose files, partial
    checkpoints every 50 pairs, per-stage metrics jsonl, ``gate_fitness`` on
    every stage-2 row.  Then the retry ladder over the failed pairs, the
    stage-1 outlier flags and stage 3.  ``batch_size`` is not read (as in
    the JAX package), so the default configuration runs.  ``clouds``
    (default: the dataset's scans, loaded onto the card) are on one device,
    where the run happens; on a ``LazyClouds`` each pair also starts the
    uploads of the next two scans.  Returns {"stage1", "stage2", "stage3"}."""
    n = n or poses_io.CIRCUIT_SIZES[cfg.dataset]
    if mesh is not None:
        return _run_full_mesh(cfg, clouds, n, metrics, methods, mesh)
    if clouds is None:
        clouds = _load_circuit_clouds(cfg, range(n))
    metrics = metrics if metrics is not None else PairMetrics()
    pairs = circuit_pairs(n)
    caps = cfg.scale_capacities
    if caps == "auto":
        caps = cloud_mod.plan_scale_caps(clouds, ms_mod.create_scales(cfg.mgicp_scales))
    eval_dist = 2 * cfg.voxel_size
    buckets = _buckets(clouds, n, cfg.bucket_granularity)
    features = _ScanCache(n, lambda i: _prep_features(
        clouds[i], buckets[i], cfg.voxel_size, cfg.stage1_band, cfg.stage1_features))
    pyramids = _ScanCache(n, lambda i: ms_mod.build_pyramid(
        clouds[i], n_scales=cfg.mgicp_scales, scale_capacities=caps))
    out1, out2 = np.zeros((n, 4, 4)), np.zeros((n, 4, 4))
    failures: list[tuple] = []

    def submit(k):
        s, t = pairs[k]
        if isinstance(clouds, cloud_mod.LazyClouds):
            # start the next two scans' non-blocking uploads now, so they run
            # ahead of the pairs that need them (the LRU keeps at least 8)
            clouds[(s + 1) % n]
            clouds[(s + 2) % n]
        (src_f, feat_src), pyr_s = features[s], pyramids[s]
        (tgt_f, feat_tgt), pyr_t = features[t], pyramids[t]
        B = max(src_f.capacity, tgt_f.capacity)
        opts = fgr_mod.default_options_capacity(B, cfg.voxel_size)
        src_p, fs, tgt_p, ft = _pad_pair(src_f, feat_src, tgt_f, feat_tgt, B)
        res1 = fgr_mod.registration_fgr(src_p, tgt_p, fs, ft, opts, seed=cfg.fgr_seed + s)
        res2 = ms_mod.multiscale_gicp_pyramids(pyr_s, pyr_t, res1.transformation,
                                               n_scales=cfg.mgicp_scales,
                                               iterations=cfg.mgicp_iterations)
        # the gate on the padded feature clouds: the same valid points as the
        # full clouds (compact drops only masked rows), at the pair bucket
        with trace.span("gate"):
            gate, _, _ = eval_mod.evaluate_registration(src_p, tgt_p, eval_dist,
                                                        res2.transformation)
        features.evict(s)
        pyramids.evict(s)
        return res1, res2, gate

    def read(k, results):
        res1, res2, gate = results
        out1[k] = res1.transformation.double().cpu().numpy()
        fit1, rmse1 = float(res1.fitness), float(res1.inlier_rmse)
        out2[k] = res2.transformation.double().cpu().numpy()
        fit, rmse = float(res2.fitness), float(res2.inlier_rmse)
        return fit1, rmse1, fit, rmse, res2.scale_iterations.tolist(), float(gate)

    def row(k, results, values, seconds):
        fit1, rmse1, fit, rmse, its, gate_fit = values
        metrics.add("fgr", *pairs[k], fit1, rmse1, seconds)
        if cfg.retry_failed and fit <= cfg.retry_fitness:
            failures.append((k, len(metrics.rows), results[1]))
        metrics.add("mgicp", *pairs[k], fit, rmse, seconds, status="ok", scale_iterations=its,
                    gate_fitness=gate_fit)

    _stream_pairs(range(n), submit, read, row, cfg.inflight,
                  _partial_checkpoint(cfg, metrics, stage1=out1, stage2=out2))
    _retry_failures(cfg, clouds, pyramids, failures, out2, metrics)
    _flag_stage1_outliers(out1, metrics)
    with trace.span("write"):
        poses_io.save_relative_circuit(cfg.out_dir("relative_poses_FGR"), out1)
        poses_io.save_relative_circuit(cfg.out_dir("relative_poses_FGR_GICP"), out2)
        poses_io.save_absolute_poses(cfg.out_dir("absolute_poses_FGR_GICP"),
                                     se3.relative_to_absolute(out2))
        metrics.save(os.path.join(cfg.out_dir("metrics"), "stage1.jsonl"), stage="fgr")
        metrics.save(os.path.join(cfg.out_dir("metrics"), "stage2.jsonl"), stage="mgicp")
    stage3 = run_stage3_global(cfg, relative_poses=out2, clouds=clouds, n=n, methods=methods)
    return {"stage1": out1, "stage2": out2, "stage3": stage3}


def _run_full_mesh(cfg: PipelineConfig, clouds, n: int, metrics: PairMetrics | None,
                   methods, mesh) -> dict:
    """``run_full`` on a pair mesh (``parallel.mesh.make_pair_mesh``): stage 1
    and stage 2 sharded over its 'pairs' axis (``run_stage1_fgr(mesh=)``,
    ``run_stage2_mgicp(mesh=)``), then stage 3, unsharded as in pcr_tpu, on
    rank 0 (span ``mesh.stage3``), whose result every rank receives.  Every
    rank returns the same poses and gathers every pair's metrics rows; only
    rank 0 writes files.  A (pairs, points) mesh is refused: its stage 1 is
    not sharded over 'points', so the CLI runs the staged runners on it."""
    lead = _writes(mesh)    # refuses a mesh that is not a Mesh
    if mesh.axis_names != ("pairs",):
        raise ValueError(f"run_full takes a pair mesh (the one axis 'pairs'), got {mesh}")
    if clouds is None:
        clouds = _load_circuit_clouds(cfg, range(n))
    metrics = metrics if metrics is not None else PairMetrics()
    rel1 = run_stage1_fgr(cfg, clouds=clouds, n=n, metrics=metrics, mesh=mesh)
    rel2 = run_stage2_mgicp(cfg, init_poses=rel1, clouds=clouds, n=n, metrics=metrics, mesh=mesh)
    stage3 = None
    if lead:
        with trace.span("mesh.stage3"):
            stage3 = run_stage3_global(cfg, relative_poses=rel2, clouds=clouds, n=n,
                                       methods=methods)
    stage3 = collectives.broadcast_object(stage3, mesh.group("pairs"))
    return {"stage1": rel1, "stage2": rel2, "stage3": stage3}


@trace.spanned("stage3.information")
def information_matrices(cfg: PipelineConfig, clouds, relative_poses) -> torch.Tensor:
    """(n, 6, 6) information matrix of every circuit edge, on the clouds'
    device: for edge k, pair (s, t) = circuit_pairs(n)[k], the band-NN
    (kernel K1, band 2048) matrix of clouds[t] -> clouds[s] at the INVERTED
    relative pose inv(rel_k), the transform of frame t into frame s, within
    voxel_size (the reference's stage 3)."""
    n = len(relative_poses)
    pairs = circuit_pairs(n)
    T_edges = se3.invert(np.asarray(relative_poses)).astype(np.float32)
    return torch.cat([eval_mod.information_matrix_batch(
        cloud_mod.stack_clouds([clouds[pairs[k][1]] for k in idx]),
        cloud_mod.stack_clouds([clouds[pairs[k][0]] for k in idx]),
        cfg.voxel_size, T_edges[idx]) for idx in _chunks(n)])


@trace.spanned("stage3")
def run_stage3_global(cfg: PipelineConfig, relative_poses: np.ndarray | None = None,
                      clouds=None, n: int | None = None,
                      methods=("LUM", "SLERP", "SLERP_LUM", "pose_graph")) -> dict:
    """Global refinement: each method on the same relative poses, its
    absolute poses written to ``absolute_poses_{method}`` and every
    trajectory scored against the measured edges in
    ``metrics/stage3_consistency.json``.  Returns {method: (n, 4, 4)}.

    The closed forms run on the host in float64.  The pose graph runs on the
    clouds' device: information matrices by ``information_matrices``, nodes
    started from the STANDARD chain of the relatives (the optimiser is
    standard SE(3), so every odometry edge starts at zero residual), loop
    edge pruned below a line-process weight of 0.25."""
    n = n or poses_io.CIRCUIT_SIZES[cfg.dataset]
    if relative_poses is None:
        relative_poses = poses_io.load_relative_circuit(cfg.out_dir("relative_poses_FGR_GICP"),
                                                        n)
    relative_poses = np.asarray(relative_poses, np.float64)
    results = {}
    if "LUM" in methods:
        results["LUM"] = closed_form.refine_lum(relative_poses)
    if "SLERP" in methods:
        results["SLERP"] = closed_form.refine_slerp(relative_poses)
    if "SLERP_LUM" in methods:
        results["SLERP_LUM"] = closed_form.refine_slerp_lum(relative_poses)
    if "pose_graph" in methods:
        if clouds is None:
            clouds = _load_circuit_clouds(cfg, range(n))
        infos = information_matrices(cfg, clouds, relative_poses)
        graph = pg_mod.build_circuit_graph(se3.relative_to_absolute_standard(relative_poses),
                                           relative_poses, infos, device=infos.device)
        out, pg_info = pg_mod.global_optimization(
            graph, max_correspondence_distance=2 * cfg.voxel_size, edge_prune_threshold=0.25,
            return_info=True)
        with trace.span("sync", site="stage3"):
            results["pose_graph"] = out.nodes.double().cpu().numpy()
            pruned_edges = int((~out.edge_mask).sum())
    with trace.span("write"):
        for name, poses in results.items():
            poses_io.save_absolute_poses(cfg.out_dir(f"absolute_poses_{name}"), poses)
    # each trajectory scored in its native convention: the closed forms and
    # the reference chain in the reference recovery, the pose graph and the
    # standard chain in standard SE(3)
    diag = {
        "raw_chain": _consistency_summary(se3.relative_to_absolute(relative_poses),
                                          relative_poses),
        "raw_chain_standard": _consistency_summary(
            se3.relative_to_absolute_standard(relative_poses), relative_poses,
            convention="standard"),
    }
    for name, poses in results.items():
        conv = "standard" if name == "pose_graph" else "reference"
        diag[name] = _consistency_summary(poses, relative_poses, convention=conv)
        diag[name]["convention"] = conv
    if "pose_graph" in results:
        diag["pose_graph"]["pruned_edges"] = pruned_edges
        diag["pose_graph"]["optimizer"] = pg_info
    path = os.path.join(cfg.out_dir("metrics"), "stage3_consistency.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with trace.span("write"), open(path, "w") as fh:
        json.dump(diag, fh, indent=2)
    return results


def _consistency_summary(absolute_poses, relative_poses, convention: str = "reference") -> dict:
    c = eval_mod.circuit_edge_consistency(absolute_poses, relative_poses, convention=convention)
    return {k: v for k, v in c.items() if isinstance(v, float)}


def evaluate_circuit(clouds, relative_poses, max_dist: float, batch: int = PAIR_CHUNK):
    """Per-pair fitness and RMSE of a circuit's relative poses (the
    reference's ``calculate_RMSE_and_fitness``): evaluate_registration(
    clouds[i+1] -> clouds[i], max_dist, rel[i]) for every pair, the
    wraparound included, by band-NN, ``batch`` pairs a stacked call.
    Returns (fitness (n,), rmse (n,))."""
    n = len(relative_poses)
    pairs = circuit_pairs(n)
    rel = np.asarray(relative_poses, np.float32)
    cols = [eval_mod.evaluate_registration_batch(
        cloud_mod.stack_clouds([clouds[pairs[k][0]] for k in idx]),
        cloud_mod.stack_clouds([clouds[pairs[k][1]] for k in idx]), max_dist, rel[idx])[:2]
        for idx in _chunks(n, batch)]
    fit, rmse = (torch.cat(c).double().cpu().numpy() for c in zip(*cols))
    return fit, rmse


def evaluate_against(poses: np.ndarray, reference: np.ndarray):
    """Per-pose (rotation, translation) errors by the reference's metric."""
    return se3.pose_errors(np.asarray(poses), np.asarray(reference))
