"""Stage 1 (pcr_tpu_torch.models.fgr, ops/knn and pipeline.run_stage1_fgr on
CPU) held against pcr_tpu on the same numpy inputs.

Tolerances:
  * mutual matching: both packages take the argmin of the same expanded d2
    (|a|^2 + |b|^2 - 2 a.b over 33-dim features), but XLA and PyTorch sum
    the cross term in other orders, so near-ties can swap; at least 99% of
    the nearest-neighbour indices and mutual flags agree;
  * the tuple test, handed JAX's own uniforms, makes the same keep mask
    (same arithmetic, the ratios far from the 0.95 edges);
  * GNC on identical correspondences: 300 f32 Gauss-Newton steps, an LU solve
    in pcr_tpu and a Cholesky solve here, reductions in other orders: poses
    within 1e-4;
  * the whole stage, on the banded and on the selection features: the
    tuple test draws other random numbers in the two packages (torch cannot
    replay jax.random), so the packages agree statistically: every pair
    within 0.25 m of ground truth in both, the JAX test's own bound
    (tests/test_fpfh_sorted.py:97-98).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pcr_tpu import pipeline as j_pipe
from pcr_tpu.models import fgr as j_fgr
from pcr_tpu.ops import fpfh_sorted as j_fs
from pcr_tpu.ops import knn as j_knn
from pcr_tpu.utils import cloud as j_cloud
from pcr_tpu_torch import pipeline as t_pipe
from pcr_tpu_torch.models import fgr as t_fgr
from pcr_tpu_torch.ops import knn as t_knn
from pcr_tpu_torch.utils import cloud as t_cloud
from pcr_tpu_torch.utils import poses_io, se3
from tests.test_torch_stage2 import bumpy_circuit

torch.set_num_threads(1)
VOXEL = 0.2


@pytest.fixture(scope="module")
def pair():
    """Scans 1 (source) and 0 (target) of a bumpy circuit with pcr_tpu's
    banded features, as numpy leaves, plus the ground-truth pose."""
    scans, gt = bumpy_circuit(np.random.default_rng(0), n_clouds=2, n=900, step=0.3)
    out = []
    for s in scans:
        c, f = j_fs.fgr_features_sorted(j_cloud.from_numpy(s, capacity=1024), VOXEL,
                                        q_tile=256, band=512)
        out.append((np.asarray(c.points), np.asarray(c.mask), np.asarray(f)))
    (pt, mt, ft), (ps, ms, fs) = out
    return dict(ps=ps, ms=ms, fs=fs, pt=pt, mt=mt, ft=ft, gt=gt[0])


def _t(x):
    return torch.from_numpy(np.array(x))


def test_nn1_mutual_and_matching_match_pcr_tpu(pair):
    ij_j, ji_j = map(np.asarray, j_knn.nn1_mutual(
        jnp.asarray(pair["fs"]), jnp.asarray(pair["ms"]), jnp.asarray(pair["ft"]),
        jnp.asarray(pair["mt"])))
    ij_t, ji_t = t_knn.nn1_mutual(_t(pair["fs"]), _t(pair["ms"]), _t(pair["ft"]),
                                  _t(pair["mt"]))
    ms, mt = pair["ms"], pair["mt"]
    assert (ij_t.numpy()[ms] == ij_j[ms]).mean() >= 0.99
    assert (ji_t.numpy()[mt] == ji_j[mt]).mean() >= 0.99
    _, _, mut_j = j_fgr.match_features(jnp.asarray(pair["fs"]), jnp.asarray(ms),
                                       jnp.asarray(pair["ft"]), jnp.asarray(mt))
    _, _, mut_t = t_fgr.match_features(_t(pair["fs"]), _t(ms), _t(pair["ft"]), _t(mt))
    mut_j = np.asarray(mut_j)
    assert mut_j.sum() > 50
    assert (mut_t.numpy() == mut_j).mean() >= 0.99


def _jax_correspondences(pair):
    ci, cj, cm = j_fgr.match_features(jnp.asarray(pair["fs"]), jnp.asarray(pair["ms"]),
                                      jnp.asarray(pair["ft"]), jnp.asarray(pair["mt"]))
    return np.asarray(ci), np.asarray(cj), np.asarray(cm)


def test_tuple_test_with_jax_uniforms(pair):
    ci, cj, cm = _jax_correspondences(pair)
    seed, n_trials = 3, 4096
    keep_j = np.asarray(j_fgr.tuple_test(
        jnp.asarray(pair["ps"]), jnp.asarray(pair["pt"]), jnp.asarray(ci), jnp.asarray(cj),
        jnp.asarray(cm), seed, max_tuples=256, n_trials=n_trials))
    u = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), (n_trials, 3)))
    keep_t = t_fgr.tuple_test(_t(pair["ps"]), _t(pair["pt"]), _t(ci), _t(cj), _t(cm), seed,
                              max_tuples=256, n_trials=n_trials, u=_t(u)).numpy()
    assert 10 < keep_j.sum() < cm.sum()
    np.testing.assert_array_equal(keep_t, keep_j)
    # without ``u`` the port draws its own (seeded, reproducible) triples
    a = t_fgr.tuple_test(_t(pair["ps"]), _t(pair["pt"]), _t(ci), _t(cj), _t(cm), seed,
                         max_tuples=256, n_trials=n_trials)
    b = t_fgr.tuple_test(_t(pair["ps"]), _t(pair["pt"]), _t(ci), _t(cj), _t(cm), seed,
                         max_tuples=256, n_trials=n_trials)
    assert torch.equal(a, b) and int(a.sum()) > 10


def test_gnc_matches_pcr_tpu_on_identical_correspondences(pair):
    ci, cj, cm = _jax_correspondences(pair)
    keep = np.asarray(j_fgr.tuple_test(
        jnp.asarray(pair["ps"]), jnp.asarray(pair["pt"]), jnp.asarray(ci), jnp.asarray(cj),
        jnp.asarray(cm), 1, max_tuples=256))
    src_j = j_cloud.Cloud(points=jnp.asarray(pair["ps"]), mask=jnp.asarray(pair["ms"]))
    tgt_j = j_cloud.Cloud(points=jnp.asarray(pair["pt"]), mask=jnp.asarray(pair["mt"]))
    opts = j_fgr.default_options(src_j, tgt_j, VOXEL)
    T_j = np.asarray(j_fgr.fgr_from_correspondences(
        src_j, tgt_j, jnp.asarray(ci), jnp.asarray(cj), jnp.asarray(keep), opts))
    src_t = t_cloud.Cloud(points=_t(pair["ps"]), mask=_t(pair["ms"]))
    tgt_t = t_cloud.Cloud(points=_t(pair["pt"]), mask=_t(pair["mt"]))
    T_t = t_fgr.fgr_from_correspondences(src_t, tgt_t, _t(ci), _t(cj), _t(keep),
                                         t_fgr.FgrOptions(*opts)).numpy()
    np.testing.assert_allclose(T_t, T_j, atol=1e-4)
    _, dt = se3.pose_errors(T_t.astype(np.float64), pair["gt"])
    assert float(dt) < 0.25


N_SCANS = 4
KW = dict(dataset="Facade", voxel_size=VOXEL, batch_size=1, bucket_granularity=256,
          stage1_band=512)


def _stage1_runs(root, features: str):
    scans, gt = bumpy_circuit(np.random.default_rng(1), n_clouds=N_SCANS, n=800, step=0.3)
    kw = dict(KW, stage1_features=features)
    cfg_t = t_pipe.PipelineConfig(output_root=str(root / "torch"), **kw)
    cfg_j = j_pipe.PipelineConfig(output_root=str(root / "jax"), **kw)
    m_t = t_pipe.PairMetrics()
    out_t = t_pipe.run_stage1_fgr(cfg_t, n=N_SCANS, metrics=m_t, clouds=[
        t_cloud.from_numpy(s, 1024, device="cpu") for s in scans])
    out_j = j_pipe.run_stage1_fgr(cfg_j, n=N_SCANS, clouds=[
        j_cloud.from_numpy(s, capacity=1024) for s in scans])
    return cfg_t, out_t, m_t, out_j, gt


@pytest.fixture(scope="module")
def stage1_runs(tmp_path_factory):
    return _stage1_runs(tmp_path_factory.mktemp("stage1"), "banded")


def test_stage1_recovers_poses_like_pcr_tpu(stage1_runs):
    _, out_t, m_t, out_j, gt = stage1_runs
    assert out_t.shape == (N_SCANS, 4, 4) and np.isfinite(out_t).all()
    for k in range(N_SCANS):
        _, dt_t = se3.pose_errors(out_t[k], gt[k])
        _, dt_j = se3.pose_errors(out_j[k], gt[k])
        assert float(dt_t) < 0.25 and float(dt_j) < 0.25, (k, dt_t, dt_j)
    assert all(r["fitness"] > 0.3 for r in m_t.rows)


def test_stage1_selection_features_recover_poses_like_pcr_tpu(tmp_path):
    """stage1_features='selection': the exact k=200 selection + gather
    features (models/fgr.fgr_features) in both packages."""
    _, out_t, m_t, out_j, gt = _stage1_runs(tmp_path, "selection")
    for k in range(N_SCANS):
        _, dt_t = se3.pose_errors(out_t[k], gt[k])
        _, dt_j = se3.pose_errors(out_j[k], gt[k])
        assert float(dt_t) < 0.25 and float(dt_j) < 0.25, (k, dt_t, dt_j)
    assert all(r["fitness"] > 0.3 for r in m_t.rows)


def test_stage1_writes_pose_files(stage1_runs):
    cfg_t, out_t, _, _, _ = stage1_runs
    rel_dir = cfg_t.out_dir("relative_poses_FGR")
    assert sorted(os.listdir(rel_dir)) == sorted(
        [f"pose_{i + 1}_{i}.txt" for i in range(N_SCANS - 1)] + [f"pose_0_{N_SCANS - 1}.txt"])
    np.testing.assert_allclose(poses_io.load_relative_circuit(rel_dir, N_SCANS), out_t,
                               atol=1e-9)
    metrics = os.path.join(cfg_t.out_dir("metrics"), "stage1.jsonl")
    with open(metrics) as fh:
        assert len(fh.readlines()) == N_SCANS


def test_stage1_refuses_unported_branches(tmp_path):
    """A mesh that is not a ``parallel.mesh.Mesh`` and an unknown feature
    kind are refused at either batch size: both raise instead of running
    something else.  (The batched branch: tests/test_torch_batched.py; the
    mesh branch: tests/test_torch_parallel.py.)"""
    clouds = [t_cloud.from_numpy(np.zeros((10, 3), np.float32), 256, device="cpu")] * 2
    for batch_size in (1, 2):
        for kw, mesh, exc in ((dict(), object(), TypeError),
                              (dict(stage1_features="sorted"), None, ValueError)):
            cfg = t_pipe.PipelineConfig(**dict(KW, output_root=str(tmp_path),
                                               **dict(kw, batch_size=batch_size)))
            with pytest.raises(exc):
                t_pipe.run_stage1_fgr(cfg, clouds=clouds, n=2, mesh=mesh)


def test_stage1_ignores_fgr_iterations_as_pcr_tpu_does(stage1_runs, tmp_path):
    """pcr_tpu's stage 1 never reads ``PipelineConfig.fgr_iterations``: its
    GNC always runs the reference's 300 steps (``default_options_capacity``).
    The port does the same, so a non-default value leaves the stage-1 poses
    equal, bit for bit, to those at the default."""
    _, out_t, _, _, _ = stage1_runs
    scans, _ = bumpy_circuit(np.random.default_rng(1), n_clouds=N_SCANS, n=800, step=0.3)
    cfg = t_pipe.PipelineConfig(output_root=str(tmp_path), fgr_iterations=30, **KW)
    out = t_pipe.run_stage1_fgr(cfg, n=N_SCANS, clouds=[
        t_cloud.from_numpy(s, 1024, device="cpu") for s in scans])
    np.testing.assert_array_equal(out, out_t)
