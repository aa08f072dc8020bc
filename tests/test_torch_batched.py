"""The batched branches (``batch_size > 1``, one card) of the port held
against pcr_tpu's on the same numpy inputs: ``fpfh_sorted.
batched_fgr_features_sorted``, ``fgr.batched_registration_fgr`` (and its
one GNC over the batch against the per-pair loop) and the two staged runners
at ``batch_size`` 2 and 3.

Tolerances:
  * features: each scan bit for bit the port's ``fgr_features_sorted``, and
    against pcr_tpu tests/test_torch_fpfh_sorted.py's bounds on its surface
    patch (pcr_tpu ranks neighbours by the expanded d2, the port by
    (q - r)^2).  Its normal bound, 1e-4, holds on every row but one of the
    three patches: there one bisection step flips (the case that file's
    docstring describes), drops one of the 20 neighbours and moves that
    normal by 9.4e-4, so one row a scan may lie within 1e-2;
  * batched FGR on pcr_tpu's features, handed JAX's uniforms pair by pair:
    the mutual matches are equal on these inputs, so the GNC runs on the
    same correspondences, and the poses agree within
    tests/test_torch_fgr.py's 1e-4 for that case;
  * the batched GNC against ``fgr_from_correspondences`` pair by pair: the
    same arithmetic a pair, batched reductions: 1e-5 on the pose;
  * stage 2: 5e-3 against pcr_tpu's batched branch, as
    tests/test_torch_stage2.py (on the CPU pcr_tpu runs its hash grid, the
    port the band sweep); gate fitness within 1e-3; the rescued pair within
    0.1 m of ground truth in both.  The port runs its streamed branch at
    every batch size, so its poses equal its batch_size=1 run bit for bit;
  * stage 1: both packages within 0.25 m of ground truth a pair
    (tests/test_torch_fgr.py's bound: their tuple tests draw other random
    numbers), the same per-pair tuple caps, and the same metrics rows,
    checkpoint and pose files.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pcr_tpu import pipeline as j_pipe
from pcr_tpu.models import fgr as j_fgr
from pcr_tpu.ops import fpfh_sorted as j_fs
from pcr_tpu.utils import cloud as j_cloud
from pcr_tpu_torch import pipeline as t_pipe
from pcr_tpu_torch.models import fgr as t_fgr
from pcr_tpu_torch.ops import fpfh_sorted as t_fs
from pcr_tpu_torch.utils import cloud as t_cloud
from pcr_tpu_torch.utils import se3
from tests.test_torch_fpfh_sorted import _surface
from tests.test_torch_stage2 import bumpy_circuit

torch.set_num_threads(1)
VOXEL = 0.2


def test_batched_features_match_pcr_tpu():
    """Three surface patches stacked: every scan's banded features as the
    port's own per-scan function's, and as pcr_tpu's vmapped ones."""
    pts = [_surface(np.random.default_rng(s)) for s in range(3)]
    cj, fj = j_fs.batched_fgr_features_sorted(
        j_cloud.stack_clouds([j_cloud.from_numpy(p, capacity=1024) for p in pts]), VOXEL,
        q_tile=256, band=512)
    ct, ft = t_fs.batched_fgr_features_sorted(
        t_cloud.stack_clouds([t_cloud.from_numpy(p, 1024, device="cpu") for p in pts]), VOXEL,
        q_tile=256, band=512)
    assert ft.shape == (3, 1024, 33) and ct.covariances.shape == (3, 1024, 3, 3)
    for b in range(3):
        c1, f1 = t_fs.fgr_features_sorted(t_cloud.from_numpy(pts[b], 1024, device="cpu"), VOXEL,
                                          q_tile=256, band=512)
        for x, y in ((ct.points[b], c1.points), (ct.normals[b], c1.normals),
                     (ct.covariances[b], c1.covariances), (ft[b], f1)):
            assert torch.equal(x, y)
        M = np.asarray(cj.mask[b])
        np.testing.assert_array_equal(ct.mask[b].numpy(), M)
        np.testing.assert_array_equal(ct.points[b].numpy(), np.asarray(cj.points[b]))
        Nj, Nt = np.asarray(cj.normals[b])[M], ct.normals[b].numpy()[M]
        nd = np.minimum(np.linalg.norm(Nj - Nt, axis=1), np.linalg.norm(Nj + Nt, axis=1))
        assert (nd > 1e-4).sum() <= 1 and nd.max() < 1e-2, (b, np.sort(nd)[-3:])
        Fj, Ft = np.asarray(fj[b])[M], ft[b].numpy()[M]
        l1 = np.abs(Fj - Ft).sum(1) / (np.abs(Fj).sum(1) + 1e-9)
        assert np.median(l1) < 2e-5 and np.percentile(l1, 99) < 1e-3 and l1.max() < 0.03, (
            b, np.median(l1), l1.max())


@pytest.fixture(scope="module")
def chunk():
    """Two pairs (1 -> 0, 2 -> 1) of a bumpy circuit with pcr_tpu's banded
    features, as numpy leaves, with their seeds, tuple caps and ground truth."""
    scans, gt = bumpy_circuit(np.random.default_rng(2), n_clouds=3, n=900, step=0.3)
    c, f = j_fs.batched_fgr_features_sorted(
        j_cloud.stack_clouds([j_cloud.from_numpy(s, capacity=1024) for s in scans]), VOXEL,
        q_tile=256, band=512)
    P, M, F = np.asarray(c.points), np.asarray(c.mask), np.asarray(f)
    src, tgt = [1, 2], [0, 1]
    return dict(ps=P[src], ms=M[src], fs=F[src], pt=P[tgt], mt=M[tgt], ft=F[tgt],
                seeds=[1, 2], max_tuples=[256, 300], gt=gt[:2], n_trials=4096,
                opts=j_fgr.default_options_capacity(1024, VOXEL))


def _t_pairs(ch):
    src = t_cloud.Cloud(points=torch.as_tensor(ch["ps"]), mask=torch.as_tensor(ch["ms"]))
    tgt = t_cloud.Cloud(points=torch.as_tensor(ch["pt"]), mask=torch.as_tensor(ch["mt"]))
    return src, tgt, torch.as_tensor(ch["fs"]), torch.as_tensor(ch["ft"])


def _jax_uniforms(ch):
    return torch.as_tensor(np.stack([np.asarray(jax.random.uniform(
        jax.random.PRNGKey(s), (ch["n_trials"], 3))) for s in ch["seeds"]]))


def test_batched_registration_fgr_matches_pcr_tpu(chunk):
    ch = chunk
    rj = j_fgr.batched_registration_fgr(
        j_cloud.Cloud(points=jnp.asarray(ch["ps"]), mask=jnp.asarray(ch["ms"])),
        j_cloud.Cloud(points=jnp.asarray(ch["pt"]), mask=jnp.asarray(ch["mt"])),
        jnp.asarray(ch["fs"]), jnp.asarray(ch["ft"]), ch["opts"], jnp.asarray(ch["seeds"]),
        n_trials=ch["n_trials"], max_tuples=jnp.asarray(ch["max_tuples"]))
    src, tgt, fs, ft = _t_pairs(ch)
    for b in range(2):   # the premise of the 1e-4 bound: equal correspondences
        _, cj_j, cm_j = j_fgr.match_features(jnp.asarray(ch["fs"][b]), jnp.asarray(ch["ms"][b]),
                                             jnp.asarray(ch["ft"][b]), jnp.asarray(ch["mt"][b]))
        _, cj_t, cm_t = t_fgr.match_features(fs[b], src.mask[b], ft[b], tgt.mask[b])
        np.testing.assert_array_equal(cm_t.numpy(), np.asarray(cm_j))
    rt = t_fgr.batched_registration_fgr(src, tgt, fs, ft, t_fgr.FgrOptions(*ch["opts"]),
                                        ch["seeds"], n_trials=ch["n_trials"],
                                        max_tuples=ch["max_tuples"], u=_jax_uniforms(ch))
    assert rt.transformation.shape == (2, 4, 4) and rt.fitness.shape == (2,)
    np.testing.assert_allclose(rt.transformation.numpy(), np.asarray(rj.transformation),
                               atol=1e-4)
    np.testing.assert_allclose(rt.fitness.numpy(), np.asarray(rj.fitness), atol=1e-6)
    np.testing.assert_allclose(rt.inlier_rmse.numpy(), np.asarray(rj.inlier_rmse), atol=1e-5)
    assert rt.iterations.tolist() == [300, 300]
    for b in range(2):
        _, dt = se3.pose_errors(rt.transformation[b].double().numpy(), ch["gt"][b])
        assert float(dt) < 0.25


def test_batched_gnc_equals_the_per_pair_loop(chunk):
    """One GNC over the batch against ``fgr_from_correspondences`` pair by
    pair on the same correspondences: 1e-5 on the pose."""
    ch = chunk
    src, tgt, fs, ft = _t_pairs(ch)
    opts = t_fgr.FgrOptions(*ch["opts"])
    u = _jax_uniforms(ch)
    corr = [t_fgr._correspondences(src[b], tgt[b], fs[b], ft[b], opts, ch["seeds"][b],
                                   ch["n_trials"], ch["max_tuples"][b], u[b]) for b in range(2)]
    T_loop = torch.stack([t_fgr.fgr_from_correspondences(src[b], tgt[b], *corr[b], opts)
                          for b in range(2)])
    T_batch = t_fgr.fgr_from_correspondences(src, tgt, *(torch.stack(c) for c in zip(*corr)),
                                             opts)
    assert T_batch.shape == (2, 4, 4)
    np.testing.assert_allclose(T_batch.numpy(), T_loop.numpy(), atol=1e-5)
    assert float((T_loop[0] - T_loop[1]).abs().max()) > 1e-2   # two different pairs


N_SCANS = 4
# valid points a scan: capacity buckets 1536 / 2048 / 1536 / 1024 at granularity
# 256, so the pairs' tuple caps differ (0.2 x the larger bucket, at least 256)
COUNTS = (1300, 1900, 1500, 1000)


def _spy(monkeypatch, module, calls: list):
    """Record the per-pair tuple caps of every batched FGR call."""
    orig = module.batched_registration_fgr

    def spy(*args, max_tuples=None, **kw):
        calls.append([int(x) for x in np.asarray(max_tuples)])
        return orig(*args, max_tuples=max_tuples, **kw)

    monkeypatch.setattr(module, "batched_registration_fgr", spy)


@pytest.fixture(scope="module")
def stage1_circuit():
    scans, gt = bumpy_circuit(np.random.default_rng(3), n_clouds=N_SCANS, n=max(COUNTS),
                              step=0.3)
    return [s[:c] for s, c in zip(scans, COUNTS)], gt


@pytest.mark.parametrize("batch_size", [2, 3])
def test_stage1_batched_matches_pcr_tpu(stage1_circuit, batch_size, tmp_path, monkeypatch):
    """run_stage1_fgr at batch_size 2 and 3 (a padded tail chunk) against
    pcr_tpu's ``_run_stage1_fgr_batched``."""
    scans, gt = stage1_circuit
    kw = dict(dataset="Facade", voxel_size=VOXEL, batch_size=batch_size,
              bucket_granularity=256, stage1_band=512)
    caps = {"torch": [], "jax": []}
    _spy(monkeypatch, t_pipe.fgr_mod, caps["torch"])
    _spy(monkeypatch, j_pipe.fgr_mod, caps["jax"])
    cfg_t = t_pipe.PipelineConfig(output_root=str(tmp_path / "torch"), **kw)
    cfg_j = j_pipe.PipelineConfig(output_root=str(tmp_path / "jax"), **kw)
    m_t, m_j = t_pipe.PairMetrics(), j_pipe.PairMetrics()
    out_t = t_pipe.run_stage1_fgr(cfg_t, n=N_SCANS, metrics=m_t, clouds=[
        t_cloud.from_numpy(s, 2048, device="cpu") for s in scans])
    out_j = j_pipe.run_stage1_fgr(cfg_j, n=N_SCANS, metrics=m_j, clouds=[
        j_cloud.from_numpy(s, capacity=2048) for s in scans])
    assert caps["torch"] == caps["jax"] and len(caps["torch"]) == -(-N_SCANS // batch_size)
    assert len(set(sum(caps["torch"], []))) > 1          # the caps do differ by pair
    assert out_t.shape == (N_SCANS, 4, 4) and np.isfinite(out_t).all()
    for k in range(N_SCANS):
        _, dt_t = se3.pose_errors(out_t[k], gt[k])
        _, dt_j = se3.pose_errors(out_j[k], gt[k])
        assert float(dt_t) < 0.25 and float(dt_j) < 0.25, (k, dt_t, dt_j)
    # metrics rows, checkpoint and pose files in pcr_tpu's layout
    assert [(r["src"], r["tgt"], sorted(r)) for r in m_t.rows] == [
        (r["src"], r["tgt"], sorted(r)) for r in m_j.rows]
    for cfg in (cfg_t, cfg_j):
        assert np.load(os.path.join(cfg.out_dir("metrics"), "stage1_partial.npy")).shape == (
            N_SCANS, 4, 4)
        with open(os.path.join(cfg.out_dir("metrics"), "stage1.jsonl")) as fh:
            assert len(fh.readlines()) == N_SCANS
    names = sorted(os.listdir(cfg_t.out_dir("relative_poses_FGR")))
    assert names == sorted(os.listdir(cfg_j.out_dir("relative_poses_FGR")))
    np.testing.assert_allclose(
        np.stack([np.loadtxt(os.path.join(cfg_t.out_dir("relative_poses_FGR"), f))
                  for f in [f"pose_{i + 1}_{i}.txt" for i in range(N_SCANS - 1)]
                  + [f"pose_0_{N_SCANS - 1}.txt"]]), out_t, atol=1e-9)


def test_stage2_batched_retry_matches_pcr_tpu(tmp_path):
    """run_stage2_mgicp at batch_size=2, ladder on, pair (2, 1) thrown 50 m
    off: both packages rescue it and record a ``retried...`` status, as in
    test_torch_stage2.py; the other pairs agree within 5e-3 and every gate
    fitness within 1e-3."""
    scans, gt = bumpy_circuit(np.random.default_rng(0), n_clouds=N_SCANS, n=800, step=0.3)
    init = gt.copy()
    init[1] = np.eye(4)
    init[1][:3, 3] = [50.0, 50.0, 50.0]
    kw = dict(dataset="Facade", voxel_size=0.2, mgicp_scales=2, mgicp_iterations=25,
              batch_size=2, retry_failed=True)
    outs, rows = [], []
    for pipe, clouds in (
            (t_pipe, [t_cloud.from_numpy(s, 1024, device="cpu") for s in scans]),
            (j_pipe, [j_cloud.from_numpy(s, 1024) for s in scans])):
        cfg = pipe.PipelineConfig(output_root=str(tmp_path / pipe.__name__), **kw)
        outs.append(pipe.run_stage2_mgicp(cfg, init_poses=init.copy(), clouds=clouds, n=N_SCANS))
        with open(os.path.join(cfg.out_dir("metrics"), "stage2.jsonl")) as fh:
            rows.append({(r["src"], r["tgt"]): r for r in map(json.loads, fh)})
        assert sorted(os.listdir(cfg.out_dir("relative_poses_FGR_GICP"))) == sorted(
            [f"pose_{i + 1}_{i}.txt" for i in range(N_SCANS - 1)] + [f"pose_0_{N_SCANS - 1}.txt"])
    for out, row in zip(outs, rows):
        _, dt = se3.pose_errors(out[1], gt[1])
        assert float(dt) < 0.1, (dt, row[(2, 1)])
        assert row[(2, 1)]["status"].startswith("retried"), row[(2, 1)]
        assert all(row[p]["status"] == "ok" for p in row if p != (2, 1))
    assert all(len(r["scale_iterations"]) == 2 for r in rows[0].values())
    keep = [0, 2, 3]
    np.testing.assert_allclose(outs[0][keep], outs[1][keep], atol=5e-3)
    np.testing.assert_allclose([rows[0][p]["gate_fitness"] for p in t_pipe.circuit_pairs(N_SCANS)],
                               [rows[1][p]["gate_fitness"] for p in t_pipe.circuit_pairs(N_SCANS)],
                               atol=1e-3)


@pytest.mark.parametrize("batch_size", [2, 3])
def test_stage2_batched_matches_pcr_tpu(batch_size, tmp_path):
    """run_stage2_mgicp at batch_size 2 and 3 (pcr_tpu pads its tail chunk),
    ladder off, against pcr_tpu's batched branch (pyramids built per pair):
    poses within 5e-3 and gate fitness within 1e-3; the port's poses and
    GICP iterations equal its own batch_size=1 run's."""
    scans, gt = bumpy_circuit(np.random.default_rng(1), n_clouds=N_SCANS, n=800, step=0.3)
    E = np.eye(4)
    E[:3, 3] = [0.05, -0.03, 0.02]
    init = np.stack([E @ g for g in gt])
    kw = dict(dataset="Facade", voxel_size=0.2, mgicp_scales=2, mgicp_iterations=25,
              retry_failed=False)
    t_clouds = [t_cloud.from_numpy(s, 1024, device="cpu") for s in scans]
    runs = {}
    for name, pipe, clouds, b in (
            ("torch", t_pipe, t_clouds, batch_size), ("torch1", t_pipe, t_clouds, 1),
            ("jax", j_pipe, [j_cloud.from_numpy(s, 1024) for s in scans], batch_size)):
        cfg = pipe.PipelineConfig(output_root=str(tmp_path / name), batch_size=b, **kw)
        out = pipe.run_stage2_mgicp(cfg, init_poses=init.copy(), clouds=clouds, n=N_SCANS)
        with open(os.path.join(cfg.out_dir("metrics"), "stage2.jsonl")) as fh:
            rows = [json.loads(line) for line in fh]
        runs[name] = out, rows
    (out_t, rows_t), (out_1, rows_1), (out_j, rows_j) = runs["torch"], runs["torch1"], runs["jax"]
    np.testing.assert_array_equal(out_t, out_1)
    assert [r["scale_iterations"] for r in rows_t] == [r["scale_iterations"] for r in rows_1]
    assert [(r["src"], r["tgt"], r["status"]) for r in rows_t] == [
        (r["src"], r["tgt"], r["status"]) for r in rows_j]
    np.testing.assert_allclose(out_t, out_j, atol=5e-3)
    np.testing.assert_allclose([r["gate_fitness"] for r in rows_t],
                               [r["gate_fitness"] for r in rows_j], atol=1e-3)
    for k in range(N_SCANS):
        _, dt = se3.pose_errors(out_t[k], gt[k])
        assert float(dt) < 0.02, (k, dt)
