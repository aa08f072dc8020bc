"""pcr_tpu_torch.pipeline.run_full, stages 1 -> 3 in one window (the main
path), held against the port's own staged runners and against
pcr_tpu.run_full, on a 4-scan bumpy circuit made from one numpy seed (the
port twin of tests/test_pipeline.py::test_run_full_streamed_matches_staged).

Tolerances:
  * run_full against the staged runners: 1e-5.  The same kernels run on the
    same inputs in the same order; the M-GICP is seeded with the FGR pose as
    it lies on the device instead of its float64 copy cast back to float32,
    which is the same float32 value;
  * against pcr_tpu.run_full: stage-2 poses within 5e-3, the stage-2
    tolerance of tests/test_torch_stage2.py (the two tuple tests draw other
    random numbers, so the stage-1 poses differ and are each held to ground
    truth within 0.25 m, as tests/test_torch_fgr.py does); the closed forms
    of stage 3 follow their stage-2 inputs (1e-2 on a 4-pair circuit)."""

import json
import os

import numpy as np
import pytest
import torch

from pcr_tpu import pipeline as j_pipe
from pcr_tpu.utils import cloud as j_cloud
from pcr_tpu_torch import pipeline as t_pipe
from pcr_tpu_torch.utils import cloud as t_cloud
from pcr_tpu_torch.utils import poses_io, se3
from tests.test_torch_stage2 import bumpy_circuit

torch.set_num_threads(1)
N = 4
KW = dict(dataset="Facade", voxel_size=0.2, mgicp_scales=2, mgicp_iterations=25,
          bucket_granularity=256, stage1_band=512)
METHODS = ("LUM", "SLERP", "SLERP_LUM", "pose_graph")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("full")
    scans, gt = bumpy_circuit(np.random.default_rng(0), n_clouds=N, n=800, step=0.3)
    clouds = [t_cloud.from_numpy(s, 1024, device="cpu") for s in scans]
    staged = t_pipe.PipelineConfig(output_root=str(root / "staged"), batch_size=1, **KW)
    rel1 = t_pipe.run_stage1_fgr(staged, clouds=clouds, n=N)
    rel2 = t_pipe.run_stage2_mgicp(staged, init_poses=rel1, clouds=clouds, n=N)
    # the default configuration (batch_size=2, which run_full does not read)
    cfg = t_pipe.PipelineConfig(output_root=str(root / "full"), **KW)
    assert cfg.batch_size == 2 and cfg.retry_failed
    metrics = t_pipe.PairMetrics()
    out = t_pipe.run_full(cfg, clouds=clouds, n=N, metrics=metrics, methods=METHODS)
    cfg_j = j_pipe.PipelineConfig(output_root=str(root / "jax"), **KW)
    out_j = j_pipe.run_full(cfg_j, clouds=[j_cloud.from_numpy(s, 1024) for s in scans], n=N,
                            methods=METHODS)
    return dict(cfg=cfg, out=out, metrics=metrics, rel1=rel1, rel2=rel2, out_j=out_j, gt=gt,
                clouds=clouds, root=root)


def test_run_full_equals_the_staged_runners(runs):
    out = runs["out"]
    np.testing.assert_allclose(out["stage1"], runs["rel1"], atol=1e-5)
    np.testing.assert_allclose(out["stage2"], runs["rel2"], atol=1e-5)
    assert set(out["stage3"]) == set(METHODS)
    for name, poses in out["stage3"].items():
        assert poses.shape == (N, 4, 4) and np.isfinite(poses).all(), name


def test_run_full_matches_pcr_tpu(runs):
    out, out_j, gt = runs["out"], runs["out_j"], runs["gt"]
    for k in range(N):
        for rel in (out["stage1"], out_j["stage1"]):
            _, dt = se3.pose_errors(rel[k], gt[k])
            assert float(dt) < 0.25, (k, dt)
    np.testing.assert_allclose(out["stage2"], out_j["stage2"], atol=5e-3)
    for name in METHODS:
        np.testing.assert_allclose(out["stage3"][name], out_j["stage3"][name], atol=1e-2,
                                   err_msg=name)


def test_run_full_keeps_the_stage_contract(runs):
    """Both stages' pose files in the reference layout, the stage-2
    absolutes, stage 3's poses and record, and the per-stage jsonl:
    gate_fitness on every stage-2 row, outlier fields on every stage-1 row."""
    cfg, out, metrics = runs["cfg"], runs["out"], runs["metrics"]
    np.testing.assert_allclose(
        poses_io.load_relative_circuit(cfg.out_dir("relative_poses_FGR"), N), out["stage1"],
        atol=1e-9)
    np.testing.assert_allclose(
        poses_io.load_relative_circuit(cfg.out_dir("relative_poses_FGR_GICP"), N),
        out["stage2"], atol=1e-9)
    np.testing.assert_allclose(
        poses_io.load_absolute_poses(cfg.out_dir("absolute_poses_FGR_GICP"), N),
        se3.relative_to_absolute(out["stage2"]), atol=1e-9)
    for name in METHODS:
        np.testing.assert_allclose(
            poses_io.load_absolute_poses(cfg.out_dir(f"absolute_poses_{name}"), N),
            out["stage3"][name], atol=1e-9)
    with open(os.path.join(cfg.out_dir("metrics"), "stage3_consistency.json")) as fh:
        assert set(json.load(fh)) == {"raw_chain", "raw_chain_standard", *METHODS}

    def rows(name):
        with open(os.path.join(cfg.out_dir("metrics"), name)) as fh:
            return [json.loads(line) for line in fh]

    s1, s2 = rows("stage1.jsonl"), rows("stage2.jsonl")
    assert [(r["src"], r["tgt"]) for r in s1] == t_pipe.circuit_pairs(N)
    assert [(r["src"], r["tgt"]) for r in s2] == t_pipe.circuit_pairs(N)
    assert all(r["stage"] == "fgr" and "t_norm_m" in r for r in s1)
    assert all(r["stage"] == "mgicp" and r["status"] == "ok" and len(r["scale_iterations"]) == 2
               for r in s2)
    assert all(r["gate_fitness"] > 0.4 for r in s2)
    assert metrics.success_rate(0.4, key="gate_fitness", stage="mgicp") == 1.0


def test_run_full_retry_pass_matches_the_staged_ladder(runs):
    """With retry_fitness=1.0 every pair takes the retry pass: run_full's
    stage-2 poses, statuses and gate_fitness (the ladder's gate score,
    the third value of _retry_pair) equal run_stage2_mgicp's, whose
    gate_fitness is the full-cloud evaluation of the same poses."""
    kw = dict(KW, retry_fitness=1.0, retry_voxel_mults=(2.0,))
    clouds, root = runs["clouds"], runs["root"]
    staged = t_pipe.PipelineConfig(output_root=str(root / "ladder_staged"), batch_size=1, **kw)
    m_s = t_pipe.PairMetrics()
    rel2 = t_pipe.run_stage2_mgicp(staged, init_poses=runs["rel1"], clouds=clouds, n=N,
                                   metrics=m_s)
    m_f = t_pipe.PairMetrics()
    out = t_pipe.run_full(t_pipe.PipelineConfig(output_root=str(root / "ladder_full"), **kw),
                          clouds=clouds, n=N, metrics=m_f, methods=("LUM",))
    np.testing.assert_allclose(out["stage2"], rel2, atol=1e-5)
    rows_s = [r for r in m_s.rows if r["stage"] == "mgicp"]
    rows_f = [r for r in m_f.rows if r["stage"] == "mgicp"]
    assert [r["status"] for r in rows_f] == [r["status"] for r in rows_s]
    assert all(r["status"].endswith("low_fitness") for r in rows_f)
    np.testing.assert_allclose([r["gate_fitness"] for r in rows_f],
                               [r["gate_fitness"] for r in rows_s], atol=1e-6)


def test_run_full_needs_clouds(tmp_path, monkeypatch):
    """Without clouds run_full loads the dataset's scans (it no longer
    raises NotImplementedError): with none under the reference root, the
    loader's FileNotFoundError names the indices on disk."""
    monkeypatch.setattr(poses_io, "REFERENCE_ROOT", str(tmp_path))
    with pytest.raises(FileNotFoundError, match=r"available indices: \[\]"):
        t_pipe.run_full(t_pipe.PipelineConfig(output_root=str(tmp_path), **KW), n=N)
