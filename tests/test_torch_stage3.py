"""Stage 3 of the port: pcr_tpu_torch.pipeline.run_stage3_global (all four
methods), the information matrices it builds, evaluate_circuit /
evaluate_against, and the stacked-cloud batch evaluations (fault F4), held
against pcr_tpu on an 8-scan bumpy circuit made from one numpy seed.

Tolerances:
  * closed forms: 1e-9 (the same float64 host operations);
  * information matrices and batch evaluations: 1e-5 relative (float32
    sums over the same band-NN correspondences); n_corr exactly;
  * pose-graph nodes: 1e-5 (an 8-node circuit is well conditioned; its
    information matrices carry the 1e-5 above);
  * the consistency record: the same keys, values within 1e-5 of pcr_tpu's
    (1e-9 for the closed forms and the raw chains)."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcr_tpu import pipeline as j_pipe
from pcr_tpu.models import evaluate as j_eval
from pcr_tpu.utils import cloud as j_cloud
from pcr_tpu_torch import pipeline as t_pipe
from pcr_tpu_torch.models import evaluate as t_eval
from pcr_tpu_torch.utils import cloud as t_cloud
from pcr_tpu_torch.utils import poses_io, se3
from tests.test_torch_stage2 import _rot_z, bumpy_circuit

torch.set_num_threads(1)
N = 8
METHODS = ("LUM", "SLERP", "SLERP_LUM", "pose_graph")
KW = dict(dataset="Facade", voxel_size=0.2, batch_size=1)


@pytest.fixture(scope="module")
def circuit():
    """Scans, and the circuit's relative poses as stage 2 would leave them:
    ground truth with a few mm / mrad of seeded error on every pair."""
    rng = np.random.default_rng(3)
    scans, gt = bumpy_circuit(rng, n_clouds=N, n=800, step=0.3)
    rel = gt.copy()
    for k in range(N):
        E = np.eye(4)
        E[:3, :3] = _rot_z(rng.normal(scale=2e-3))
        E[:3, 3] = rng.normal(scale=5e-3, size=3)
        rel[k] = E @ gt[k]
    return scans, rel


@pytest.fixture(scope="module")
def clouds(circuit):
    scans, _ = circuit
    return ([t_cloud.from_numpy(s, 1024, device="cpu") for s in scans],
            [j_cloud.from_numpy(s, 1024) for s in scans])


@pytest.fixture(scope="module")
def runs(circuit, clouds, tmp_path_factory):
    _, rel = circuit
    root = tmp_path_factory.mktemp("stage3")
    cfg_t = t_pipe.PipelineConfig(output_root=str(root / "torch"), **KW)
    cfg_j = j_pipe.PipelineConfig(output_root=str(root / "jax"), **KW)
    out_t = t_pipe.run_stage3_global(cfg_t, relative_poses=rel.copy(), clouds=clouds[0], n=N,
                                     methods=METHODS)
    out_j = j_pipe.run_stage3_global(cfg_j, relative_poses=rel.copy(), clouds=clouds[1], n=N,
                                     methods=METHODS)
    return cfg_t, out_t, cfg_j, out_j


def test_stage3_methods_match_pcr_tpu(runs):
    _, out_t, _, out_j = runs
    assert set(out_t) == set(METHODS)
    for name in ("LUM", "SLERP", "SLERP_LUM"):
        np.testing.assert_allclose(out_t[name], out_j[name], atol=1e-9, err_msg=name)
    pg = out_t["pose_graph"]
    assert pg.shape == (N, 4, 4) and pg.dtype == np.float64 and np.isfinite(pg).all()
    np.testing.assert_allclose(pg, out_j["pose_graph"], atol=1e-5)


def test_stage3_writes_the_same_files_and_record(runs):
    cfg_t, out_t, cfg_j, _ = runs
    for name in METHODS:
        d = cfg_t.out_dir(f"absolute_poses_{name}")
        assert sorted(os.listdir(d)) == sorted(f"pose{i}.txt" for i in range(N))
        np.testing.assert_allclose(poses_io.load_absolute_poses(d, N), out_t[name], atol=1e-9)

    def record(cfg):
        with open(os.path.join(cfg.out_dir("metrics"), "stage3_consistency.json")) as fh:
            return json.load(fh)

    got, want = record(cfg_t), record(cfg_j)
    assert got.keys() == want.keys()
    for entry in want:
        assert got[entry].keys() == want[entry].keys(), entry
        tol = 1e-5 if entry == "pose_graph" else 1e-9
        for key, value in want[entry].items():
            if isinstance(value, float):
                np.testing.assert_allclose(got[entry][key], value, atol=tol,
                                           err_msg=f"{entry}.{key}")
    opt_t, opt_j = got["pose_graph"]["optimizer"], want["pose_graph"]["optimizer"]
    assert opt_t.keys() == opt_j.keys()
    for key in ("pruned_edges", "reseeded_from_chain"):
        assert opt_t[key] == opt_j[key]
    assert got["pose_graph"]["pruned_edges"] == want["pose_graph"]["pruned_edges"] == 0
    assert got["pose_graph"]["convention"] == "standard"
    # the pose graph distributes the closure the standard chain leaves on edge n-1
    assert (got["pose_graph"]["dt_closure_edge_m"]
            < got["raw_chain_standard"]["dt_closure_edge_m"])


def test_information_matrices_pair_order(circuit, clouds):
    """Edge k's matrix is clouds[k] -> clouds[k+1] at inv(rel_k), the
    inverted edge pose, as pcr_tpu's stage 3 computes it."""
    _, rel = circuit
    t_clouds, j_clouds = clouds
    cfg = t_pipe.PipelineConfig(**KW)
    infos = t_pipe.information_matrices(cfg, t_clouds, rel).numpy()
    assert infos.shape == (N, 6, 6)
    for k in (0, N - 1):
        T = np.linalg.inv(rel[k]).astype(np.float32)
        want = j_eval.information_matrix(j_clouds[k], j_clouds[(k + 1) % N], 0.2,
                                         jnp.asarray(T))
        np.testing.assert_allclose(infos[k], np.asarray(want), rtol=1e-5,
                                   atol=1e-5 * np.abs(np.asarray(want)).max())
        assert infos[k][3, 3] > 100                     # real overlap at the edge pose


def test_batch_evaluations_take_stacked_clouds_like_pcr_tpu(circuit, clouds):
    """F4: evaluate_registration_batch and information_matrix_batch take
    stacked Clouds (leading dim B, cloud.stack_clouds) and give the same
    (B, ...) results as pcr_tpu's on the same stacked pairs."""
    _, rel = circuit
    t_clouds, j_clouds = clouds
    idx = [0, 3, 7]
    src = [(k + 1) % N for k in idx]
    T = rel[idx].astype(np.float32)
    s_t = t_cloud.stack_clouds([t_clouds[i] for i in src])
    g_t = t_cloud.stack_clouds([t_clouds[i] for i in idx])
    assert s_t.points.shape == (3, 1024, 3) and s_t.capacity == 1024
    torch.testing.assert_close(s_t[1].points, t_clouds[src[1]].points)
    s_j = j_cloud.stack_clouds([j_clouds[i] for i in src])
    g_j = j_cloud.stack_clouds([j_clouds[i] for i in idx])
    for method in ("band", "exact"):
        fit, rmse, n_corr = t_eval.evaluate_registration_batch(s_t, g_t, 0.4, T, method=method)
        want = j_eval.evaluate_registration_batch(s_j, g_j, 0.4, jnp.asarray(T), method=method)
        assert fit.shape == (3,)
        np.testing.assert_array_equal(n_corr.numpy(), np.asarray(want[2]))
        np.testing.assert_allclose(fit.numpy(), np.asarray(want[0]), rtol=1e-6)
        np.testing.assert_allclose(rmse.numpy(), np.asarray(want[1]), rtol=1e-5)
        info = t_eval.information_matrix_batch(s_t, g_t, 0.4, T, method=method).numpy()
        want_i = np.asarray(j_eval.information_matrix_batch(s_j, g_j, 0.4, jnp.asarray(T),
                                                            method=method))
        assert info.shape == (3, 6, 6)
        np.testing.assert_allclose(info, want_i, rtol=1e-5, atol=1e-5 * np.abs(want_i).max())


def test_evaluate_circuit_and_against(circuit, clouds):
    _, rel = circuit
    t_clouds, j_clouds = clouds
    fit, rmse = t_pipe.evaluate_circuit(t_clouds, rel, 0.4)
    want_f, want_r = j_pipe.evaluate_circuit(j_clouds, rel, 0.4)
    assert fit.shape == rmse.shape == (N,)
    np.testing.assert_allclose(fit, want_f, rtol=1e-6)
    np.testing.assert_allclose(rmse, want_r, rtol=1e-5)
    assert (fit > 0.5).all()
    A, B = se3.relative_to_absolute(rel), se3.relative_to_absolute_standard(rel)
    for got, want in zip(t_pipe.evaluate_against(A, B), j_pipe.evaluate_against(A, B)):
        np.testing.assert_allclose(got, want, atol=1e-12)


def test_stage3_pose_graph_needs_clouds(circuit, runs, tmp_path, monkeypatch):
    """The pose graph without clouds loads the dataset's scans (written here
    as binary PCD under a temporary reference root; the loader is asked for
    the CPU) and lands on the poses of the run given the same clouds; the
    closed forms alone run from the stage-2 pose files and load nothing."""
    from pcr_tpu_torch.utils import pcd

    scans, rel = circuit
    d = tmp_path / "nuvens" / "nuvens_pre_processadas" / "Facade"
    d.mkdir(parents=True)
    for i, s in enumerate(scans):
        pcd.write_pcd(str(d / f"s{i}.pcd"), s)
    monkeypatch.setattr(poses_io, "REFERENCE_ROOT", str(tmp_path))
    monkeypatch.setitem(t_cloud.BUCKETS, "Facade", 1024)
    loads = []
    load = t_pipe._load_circuit_clouds

    def load_on_cpu(cfg, indices=None, device=None):
        loads.append(list(indices))
        return load(cfg, indices, device="cpu")

    monkeypatch.setattr(t_pipe, "_load_circuit_clouds", load_on_cpu)
    cfg = t_pipe.PipelineConfig(output_root=str(tmp_path / "out"), **KW)
    poses_io.save_relative_circuit(cfg.out_dir("relative_poses_FGR_GICP"), rel)
    out = t_pipe.run_stage3_global(cfg, n=N, methods=("LUM",))
    np.testing.assert_allclose(out["LUM"], se3.relative_to_absolute(rel), atol=0.05)
    assert not loads
    out = t_pipe.run_stage3_global(cfg, n=N)
    assert loads == [list(range(N))]
    np.testing.assert_allclose(out["pose_graph"], runs[1]["pose_graph"], atol=1e-9)
