"""The port's viz.py and models/gicp.gicp_loss_log against pcr_tpu's, on
clouds and poses made from one numpy seed (the 4-scan bumpy circuit of
tests/test_torch_stage2.py).

Tolerances:
  * PLY files (write_ply, export_trajectory, export_registered_clouds,
    export_correspondences, report_circuit's trajectories): byte for byte.
    Both format the same float32 / float64 numbers with the same format
    strings and draw the same numpy random numbers;
  * animate_pair's frames: vertices within 1e-6 (pcr_tpu's se3.interpolate
    takes t through float32, the port's keeps float64 on numpy; the PLY
    prints six decimals, so a vertex may differ by one unit in the last);
  * plots: the file exists and is a non-empty image (matplotlib draws them);
  * gicp_loss_log: logs and poses within 1e-5 of pcr_tpu's, 'brute'
    against 'brute' and the default on CPU tensors ('grid') against 'grid'
    (each exact within max_corr_dist: the same correspondences, float32
    sums in another order).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcr_tpu import viz as j_viz
from pcr_tpu.models import gicp as j_gicp
from pcr_tpu.utils import cloud as j_cloud
from pcr_tpu_torch import viz as t_viz
from pcr_tpu_torch.models import gicp as t_gicp
from pcr_tpu_torch.ops import normals as t_normals
from pcr_tpu_torch.utils import cloud as t_cloud
from pcr_tpu_torch.utils import se3
from tests.test_torch_stage2 import bumpy_circuit

torch.set_num_threads(1)
N = 4


@pytest.fixture(scope="module")
def circuit():
    scans, gt = bumpy_circuit(np.random.default_rng(0), n_clouds=N, n=800, step=0.3)
    rng = np.random.default_rng(1)
    colors = [rng.uniform(size=(len(s), 3)).astype(np.float32) for s in scans]
    t = [t_cloud.from_numpy(s, 1024, colors=c, device="cpu") for s, c in zip(scans, colors)]
    j = [j_cloud.from_numpy(s, 1024, colors=c) for s, c in zip(scans, colors)]
    return scans, gt, se3.relative_to_absolute(gt), t, j


def _same_file(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        data = fa.read()
        assert data == fb.read(), (a, b)
    assert data


def test_write_ply_matches_pcr_tpu(tmp_path):
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    cols = rng.uniform(size=(50, 3))
    edges = np.stack([np.arange(49), np.arange(1, 50)], axis=1)
    for name, kw in (("plain", {}), ("colors", {"colors": cols}),
                     ("edges", {"colors": cols, "edges": edges})):
        got = t_viz.write_ply(tmp_path / f"t_{name}.ply", pts, **kw)
        j_viz.write_ply(tmp_path / f"j_{name}.ply", pts, **kw)
        _same_file(got, tmp_path / f"j_{name}.ply")
    # tensors (any device) are read to the host
    t_viz.write_ply(tmp_path / "tensor.ply", torch.from_numpy(pts),
                    colors=torch.from_numpy(cols), edges=torch.from_numpy(edges))
    _same_file(tmp_path / "tensor.ply", tmp_path / "j_edges.ply")


@pytest.mark.parametrize("closed", [True, False])
def test_export_trajectory_matches_pcr_tpu(circuit, tmp_path, closed):
    absolute = circuit[2]
    got = t_viz.export_trajectory(tmp_path / "t.ply", absolute, closed=closed)
    _same_file(got, j_viz.export_trajectory(tmp_path / "j.ply", absolute, closed=closed))


def test_export_registered_clouds_matches_pcr_tpu(circuit, tmp_path):
    _, _, absolute, t, j = circuit
    got = t_viz.export_registered_clouds(tmp_path / "t.ply", t, absolute,
                                         max_points_per_cloud=500, seed=3)
    _same_file(got, j_viz.export_registered_clouds(tmp_path / "j.ply", j, absolute,
                                                   max_points_per_cloud=500, seed=3))


def test_export_correspondences_matches_pcr_tpu(circuit, tmp_path):
    _, gt, _, t, j = circuit
    corr = np.stack([np.arange(300), np.arange(300)[::-1]], axis=1)
    got = t_viz.export_correspondences(tmp_path / "t.ply", t[1], t[0], gt[0], corr, n=50)
    _same_file(got, j_viz.export_correspondences(tmp_path / "j.ply", j[1], j[0], gt[0], corr,
                                                 n=50))


def test_report_circuit_matches_pcr_tpu(circuit, tmp_path):
    _, gt, absolute, _, _ = circuit
    results = {"SLERP": absolute, "LUM": se3.relative_to_absolute(gt * 1.0001)}
    got = t_viz.report_circuit(str(tmp_path / "t"), None, results, reference=absolute)
    want = j_viz.report_circuit(str(tmp_path / "j"), None, results, reference=absolute)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    assert os.path.basename(got[-1]) == "pose_errors.png"
    for a, b in zip(got[:-1], want[:-1]):
        _same_file(a, b)
    assert os.path.getsize(got[-1]) > 1000


def test_animate_pair_frames_match_pcr_tpu(circuit, tmp_path):
    _, gt, _, t, j = circuit
    got = t_viz.animate_pair(tmp_path / "t", t[1], t[0], gt[0], n_frames=4, max_points=300)
    want = j_viz.animate_pair(tmp_path / "j", j[1], j[0], gt[0], n_frames=4, max_points=300)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    for a, b in zip(got, want):
        va = np.loadtxt(a, skiprows=10)
        vb = np.loadtxt(b, skiprows=10)
        np.testing.assert_allclose(va, vb, atol=1e-6)


def test_plots_are_written(circuit, tmp_path):
    _, gt, absolute, t, _ = circuit
    rng = np.random.default_rng(4)
    log = {"fitness": torch.linspace(0.5, 0.9, 10), "inlier_rmse": torch.linspace(0.2, 0.05, 10)}
    paths = [
        t_viz.plot_pose_errors(tmp_path / "errors.png", {"a": rng.uniform(size=N)}),
        t_viz.plot_pair_metric(tmp_path / "pairs.png", {"a": rng.uniform(size=N),
                                                         "b": rng.uniform(size=N)}, "RMSE"),
        t_viz.plot_time_bars(tmp_path / "bars.png", rng.uniform(size=N), ["a", "b", "c", "d"]),
        t_viz.plot_rmse_vs_iterations(tmp_path / "rmse.png", log),
        t_viz.plot_rmse_vs_iterations(tmp_path / "rmse_scales.png", [log, log], per_scale=True),
        t_viz.plot_pair_metric_bars(tmp_path / "pair_bars.png", {"a": rng.uniform(size=N)},
                                    "fitness"),
        t_viz.plot_nn_distance_boxplot(tmp_path / "knn.png", {"s0": t[0], "s1": t[1]}),
        *t_viz.animate_reconstruction(tmp_path / "anim", t[:2], absolute[:2], frames_per_cloud=2,
                                      max_points=200),
    ]
    assert os.path.basename(paths[-1]) == "reconstruction.gif"
    for p in paths:
        assert os.path.getsize(p) > 1000, p


def _with_covariances(scan):
    c = t_normals.with_normals_knn(t_cloud.from_numpy(scan, 1024, device="cpu"), 20)
    cov = c.covariances.numpy()
    t = t_cloud.from_arrays(c.points.numpy(), c.mask.numpy(), covariances=cov, device="cpu")
    j = j_cloud.Cloud(points=jnp.asarray(c.points.numpy()), mask=jnp.asarray(c.mask.numpy()),
                      covariances=jnp.asarray(cov))
    return t, j


@pytest.mark.parametrize("j_method", ["brute", "grid"])
def test_gicp_loss_log_matches_pcr_tpu(circuit, j_method):
    scans, gt = circuit[0], circuit[1]
    src_t, src_j = _with_covariances(scans[1])
    tgt_t, tgt_j = _with_covariances(scans[0])
    E = np.eye(4)
    E[:3, 3] = [0.05, -0.04, 0.02]
    T0 = (E @ gt[0]).astype(np.float32)
    # on CPU tensors the port's default is pcr_tpu's: 'grid'
    kw = {} if j_method == "grid" else {"corr_method": j_method}
    res, log = t_gicp.gicp_loss_log(src_t, tgt_t, 0.5, T0, max_iteration=12, **kw)
    res_j, log_j = j_gicp.gicp_loss_log(src_j, tgt_j, 0.5, T0, max_iteration=12,
                                        corr_method=j_method)
    assert log["fitness"].shape == log["inlier_rmse"].shape == (12,)
    np.testing.assert_allclose(log["fitness"].numpy(), np.asarray(log_j["fitness"]), atol=1e-5)
    np.testing.assert_allclose(log["inlier_rmse"].numpy(), np.asarray(log_j["inlier_rmse"]),
                               atol=1e-5)
    np.testing.assert_allclose(res.transformation.numpy(), np.asarray(res_j.transformation),
                               atol=1e-5)
    np.testing.assert_allclose(float(res.fitness), float(res_j.fitness), atol=1e-5)
    np.testing.assert_allclose(float(res.inlier_rmse), float(res_j.inlier_rmse), atol=1e-5)
    assert int(res.iterations) == int(res_j.iterations) == 12
    # the loss falls as the pose converges
    assert float(log["inlier_rmse"][-1]) < float(log["inlier_rmse"][0])
    with pytest.raises(ValueError):
        t_gicp.gicp_loss_log(src_t, tgt_t, 0.5, T0, corr_method="kdtree")
