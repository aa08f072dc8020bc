"""The whole stage-2 slice: pcr_tpu_torch.pipeline.run_stage2_mgicp against
pcr_tpu.pipeline.run_stage2_mgicp (streamed branch, batch_size=1,
retry_failed=False) on a 4-scan bumpy circuit made from one numpy seed.

Tolerance: poses within 5e-3, as tests/test_pipeline.py holds pcr_tpu's
batched path to its streamed one.  The retry ladder's twin of
tests/test_pipeline.py:359-388 holds the rescued pair to 0.1 m of ground
truth in both packages (their tuple tests draw other random numbers, so the
FGR seeds differ) and the other pairs to 5e-3.  The two do not run the same
correspondence search: on the CPU pcr_tpu's corr_method='auto' resolves to
its hash grid (pcr_tpu/models/gicp.py:237-238), the port always runs the
band sweep.  Gate fitness (band evaluation in both) within 1e-3.
"""

import json
import os

import numpy as np
import pytest
import torch

from pcr_tpu import pipeline as j_pipe
from pcr_tpu.utils import cloud as j_cloud
from pcr_tpu_torch import pipeline as t_pipe
from pcr_tpu_torch.models import multiscale as t_ms
from pcr_tpu_torch.utils import cloud as t_cloud
from pcr_tpu_torch.utils import poses_io, se3

torch.set_num_threads(1)
N = 4


def _rot_z(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])


def bumpy_circuit(rng, n_clouds=N, n=1500, step=0.4):
    """tests/test_pipeline._bumpy_clouds in numpy: scan i views a fixed
    bumpy surface from a frame shifted by i*step with yaw 0.05*i."""
    scans, poses = [], []
    for i in range(n_clouds):
        xy = rng.uniform(-4, 4, size=(n, 2)).astype(np.float32)
        xy[:, 0] += i * step
        z = (np.sin(1.3 * xy[:, :1]) * 0.5 + np.cos(0.9 * xy[:, 1:2]) * 0.4
             + 0.2 * np.sin(2.7 * xy[:, :1] * xy[:, 1:2] / 4))
        T = np.eye(4)
        T[:3, :3] = _rot_z(0.05 * i)
        T[:3, 3] = [i * step, 0.1 * i, 0.0]
        Ti = np.linalg.inv(T)
        world = np.concatenate([xy, z], axis=1).astype(np.float32)
        scans.append((world @ Ti[:3, :3].T + Ti[:3, 3]).astype(np.float32))
        poses.append(T)
    gt = np.stack([np.linalg.inv(poses[k]) @ poses[(k + 1) % n_clouds]
                   for k in range(n_clouds)])
    return scans, gt


@pytest.fixture(scope="module")
def circuit():
    scans, gt = bumpy_circuit(np.random.default_rng(0))
    E = np.eye(4)
    E[:3, :3] = _rot_z(0.02)
    E[:3, 3] = [0.05, -0.03, 0.02]
    return scans, gt, np.stack([E @ T for T in gt])


KW = dict(dataset="Facade", voxel_size=0.2, mgicp_scales=2, mgicp_iterations=25,
          batch_size=1, retry_failed=False)


@pytest.fixture(scope="module")
def runs(circuit, tmp_path_factory):
    scans, gt, init = circuit
    root = tmp_path_factory.mktemp("stage2")
    cfg_t = t_pipe.PipelineConfig(output_root=str(root / "torch"), **KW)
    cfg_j = j_pipe.PipelineConfig(output_root=str(root / "jax"), **KW)
    m_t, m_j = t_pipe.PairMetrics(), j_pipe.PairMetrics()
    out_t = t_pipe.run_stage2_mgicp(
        cfg_t, init_poses=init.copy(), n=N, metrics=m_t,
        clouds=[t_cloud.from_numpy(s, 2048, device="cpu") for s in scans])
    out_j = j_pipe.run_stage2_mgicp(cfg_j, init_poses=init.copy(), n=N, metrics=m_j,
                                    clouds=[j_cloud.from_numpy(s, 2048) for s in scans])
    return cfg_t, out_t, m_t, out_j, m_j


def test_stage2_poses_match_pcr_tpu(runs, circuit):
    _, out_t, _, out_j, _ = runs
    _, gt, _ = circuit
    assert out_t.shape == (N, 4, 4) and np.isfinite(out_t).all()
    np.testing.assert_allclose(out_t, out_j, atol=5e-3)
    for k in range(N):                      # and both refine toward ground truth
        _, dt = se3.pose_errors(out_t[k], gt[k])
        assert float(dt) < 0.02, (k, dt)


def test_stage2_gate_fitness_matches(runs):
    _, _, m_t, _, m_j = runs
    g_t = [r["gate_fitness"] for r in m_t.rows]
    g_j = [r["gate_fitness"] for r in m_j.rows]
    np.testing.assert_allclose(g_t, g_j, atol=1e-3)
    assert m_t.success_rate(0.4, key="gate_fitness", stage="mgicp") == 1.0


def test_stage2_writes_pose_file_contract(runs):
    """pose_{i+1}_{i}.txt + pose_0_{n-1}.txt relative files, pose{i}.txt
    absolutes (the reference's chain) and the stage2.jsonl metrics."""
    cfg_t, out_t, _, _, _ = runs
    rel_dir = cfg_t.out_dir("relative_poses_FGR_GICP")
    names = sorted(os.listdir(rel_dir))
    assert names == sorted([f"pose_{i + 1}_{i}.txt" for i in range(N - 1)]
                           + [f"pose_0_{N - 1}.txt"])
    np.testing.assert_allclose(poses_io.load_relative_circuit(rel_dir, N), out_t, atol=1e-9)
    absolute = poses_io.load_absolute_poses(cfg_t.out_dir("absolute_poses_FGR_GICP"), N)
    np.testing.assert_allclose(absolute, se3.relative_to_absolute(out_t), atol=1e-9)
    with open(os.path.join(cfg_t.out_dir("metrics"), "stage2.jsonl")) as fh:
        rows = [json.loads(line) for line in fh]
    assert [(r["src"], r["tgt"]) for r in rows] == t_pipe.circuit_pairs(N)
    assert all(len(r["scale_iterations"]) == 2 and r["status"] == "ok" for r in rows)


def test_stage2_refuses_unported_branches(circuit, tmp_path):
    """A mesh that is not a ``parallel.mesh.Mesh`` is refused at either
    batch size instead of running something else.  (Batch sizes above 1
    run: tests/test_torch_batched.py; the mesh branch:
    tests/test_torch_parallel.py.)"""
    scans, _, init = circuit
    clouds = [t_cloud.from_numpy(s, 2048, device="cpu") for s in scans]
    kw = dict(KW, output_root=str(tmp_path))
    for batch_size in (1, 2):
        with pytest.raises(TypeError, match="Mesh"):
            t_pipe.run_stage2_mgicp(t_pipe.PipelineConfig(**dict(kw, batch_size=batch_size)),
                                    init_poses=init, clouds=clouds, n=N, mesh=object())


def test_stage2_retry_ladder_rescues_like_pcr_tpu(tmp_path):
    """Pair (2, 1) gets a 50 m initial pose (fitness 0 at every scale): with
    the reference defaults (retry_failed=True) both packages re-seed it with
    FGR at 2x and 4x the voxel, rescue it to under 0.1 m and record a
    ``retried...`` status; the other pairs agree within 5e-3."""
    scans, gt = bumpy_circuit(np.random.default_rng(0), n_clouds=N, n=800, step=0.3)
    init = gt.copy()
    init[1] = np.eye(4)
    init[1][:3, 3] = [50.0, 50.0, 50.0]
    kw = dict(dataset="Facade", voxel_size=0.2, mgicp_scales=2, mgicp_iterations=25,
              batch_size=1)
    outs, rows = [], []
    for pipe, clouds in (
            (t_pipe, [t_cloud.from_numpy(s, 1024, device="cpu") for s in scans]),
            (j_pipe, [j_cloud.from_numpy(s, 1024) for s in scans])):
        cfg = pipe.PipelineConfig(output_root=str(tmp_path / pipe.__name__), **kw)
        assert cfg.retry_failed and tuple(cfg.retry_voxel_mults) == (2.0, 4.0)
        outs.append(pipe.run_stage2_mgicp(cfg, init_poses=init.copy(), clouds=clouds, n=N))
        with open(os.path.join(cfg.out_dir("metrics"), "stage2.jsonl")) as fh:
            rows.append({(r["src"], r["tgt"]): r for r in map(json.loads, fh)})
    for out, row in zip(outs, rows):
        _, dt = se3.pose_errors(out[1], gt[1])
        assert float(dt) < 0.1, (dt, row[(2, 1)])
        assert row[(2, 1)]["status"].startswith("retried"), row[(2, 1)]
        assert all(row[p]["status"] == "ok" for p in row if p != (2, 1))
    assert "scale_iterations" in rows[0][(2, 1)]
    keep = [0, 2, 3]
    np.testing.assert_allclose(outs[0][keep], outs[1][keep], atol=5e-3)


@pytest.mark.parametrize("schedule", ["linear", "doubling"])
def test_multiscale_gicp_schedules(circuit, schedule):
    """multiscale_gicp (preprocess per call) with both schedules recovers the
    first pair; the doubling schedule clamps each radius to 10x its voxel."""
    scans, gt, init = circuit
    src = t_cloud.from_numpy(scans[1], 2048, device="cpu")
    tgt = t_cloud.from_numpy(scans[0], 2048, device="cpu")
    res = t_ms.multiscale_gicp(src, tgt, init[0], n_scales=2, iterations=25,
                               schedule=schedule)
    _, dt = se3.pose_errors(res.transformation.double().numpy(), gt[0])
    assert float(dt) < 0.02
    assert res.scale_iterations.shape == (2,)
