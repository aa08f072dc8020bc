"""The port's entry points (port twin of tests/test_cli.py):
``python -m pcr_tpu_torch`` through ``__main__.main(argv, device="cpu")``,
``pipeline.run_pair`` and ``run_full`` over a ``LazyClouds``, against
``pcr_tpu``'s CLI and ``run_pair`` on the same PCD files.

The dataset is a 4-scan bumpy circuit made from one numpy seed and written
with write_pcd into a temporary reference root, which both packages'
REFERENCE_ROOT, CIRCUIT_SIZES and BUCKETS point at.  The CLI builds its own
PipelineConfig; both packages' get the test sizes of tests/test_torch_full.py
(stage-1 band 512, bucket granularity 256) so that the four circuit runs fit
the CPU's time.

Tolerances:
  * the port's stage-2 poses within 5e-3 of pcr_tpu's, the stage-2
    tolerance of tests/test_torch_full.py and tests/test_torch_stage2.py,
    for the same reason (the two tuple tests draw other random numbers, so
    stage 1 differs; each stage-1 pose is held to ground truth within
    0.25 m instead); the closed forms follow their stage-2 inputs (1e-2);
  * the port's CLI against the port's run_full on port-loaded clouds, and
    run_full over LazyClouds(keep=2) against the eager clouds: 1e-5 (binary
    PCD round-trips float32 exactly and the loaders keep row order, so the
    same kernels see the same tensors; 1e-5 is the bound tests/test_torch_full.py
    holds run_full to against the staged runners);
  * pair: within 0.1 m of ground truth (tests/test_cli.py) and 5e-3 of
    pcr_tpu.pipeline.run_pair;
  * stage 3 from fixture files: closed forms within 1e-9 of pcr_tpu's CLI
    (the same float64 host operations); the report's trajectory PLY byte
    for byte.
"""

import contextlib
import dataclasses
import functools
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pcr_tpu import __main__ as j_cli
from pcr_tpu import pipeline as j_pipe
from pcr_tpu.utils import cloud as j_cloud
from pcr_tpu.utils import poses_io as j_poses
from pcr_tpu_torch import __main__ as t_cli
from pcr_tpu_torch import pipeline as t_pipe
from pcr_tpu_torch.utils import cloud as t_cloud
from pcr_tpu_torch.utils import pcd as t_pcd
from pcr_tpu_torch.utils import poses_io as t_poses
from pcr_tpu_torch.utils import se3
from tests.test_torch_stage2 import bumpy_circuit

torch.set_num_threads(1)
N = 4
SMALL = dict(stage1_band=512, bucket_granularity=256)
ARGS = ["--dataset", "Facade", "--n", str(N), "--voxel-size", "0.2"]
REFINE = ["--scales", "2", "--iterations", "15"]
CLOSED = ("LUM", "SLERP", "SLERP_LUM")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def mini(tmp_path_factory):
    """The 4-scan circuit as binary PCD files, its ground truth as the
    absolute FGR_GICP fixture; both packages pointed at it."""
    root = tmp_path_factory.mktemp("reference")
    scans, gt = bumpy_circuit(np.random.default_rng(0), n_clouds=N, n=800, step=0.3)
    d = root / "nuvens" / "nuvens_pre_processadas" / "Facade"
    d.mkdir(parents=True)
    for i, s in enumerate(scans):
        t_pcd.write_pcd(str(d / f"s{i}.pcd"), s)
    absolute = se3.relative_to_absolute_standard(gt)
    with pytest.MonkeyPatch.context() as mp:
        for mod in (t_poses, j_poses):
            mp.setattr(mod, "REFERENCE_ROOT", str(root))
            mp.setitem(mod.CIRCUIT_SIZES, "Facade", N)
        for mod in (t_cloud, j_cloud):
            mp.setitem(mod.BUCKETS, "Facade", 1024)
        for mod in (t_pipe, j_pipe):
            mp.setattr(mod, "PipelineConfig", functools.partial(mod.PipelineConfig, **SMALL))
        t_poses.save_absolute_poses(t_poses.reference_fixture_dir("absolute_FGR_GICP", "Facade"),
                                    absolute)
        t_poses.save_relative_circuit(t_poses.reference_fixture_dir("FGR_GICP", "Facade"), gt)
        yield dict(root=root, gt=gt, scans=scans, absolute=absolute)


def _main(cli, argv, **kw) -> dict:
    """Run a CLI's main; returns its JSON summary line."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(argv, **kw) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def _rel(out_root, stage):
    return t_poses.load_relative_circuit(os.path.join(out_root, stage, "Facade"), N)


def _abs(out_root, method):
    return t_poses.load_absolute_poses(os.path.join(out_root, f"absolute_poses_{method}",
                                                    "Facade"), N)


@pytest.fixture(scope="module")
def full(mini, tmp_path_factory):
    out = tmp_path_factory.mktemp("full")
    summary_t = _main(t_cli, ["full", *ARGS, *REFINE, "--output-root", str(out / "cli")],
                      device="cpu")
    summary_j = _main(j_cli, ["full", *ARGS, *REFINE, "--output-root", str(out / "jax")])
    cfg = t_pipe.PipelineConfig(dataset="Facade", voxel_size=0.2, mgicp_scales=2,
                                mgicp_iterations=15, batch_size=1)
    eager = t_pipe.run_full(dataclasses.replace(cfg, output_root=str(out / "eager")),
                            clouds=t_cloud.load_dataset("Facade", device="cpu"), n=N)
    lazy_clouds = t_cloud.load_dataset_lazy("Facade", keep=2, device="cpu")
    lazy = t_pipe.run_full(dataclasses.replace(cfg, output_root=str(out / "lazy")),
                           clouds=lazy_clouds, n=N)
    return dict(out=out, summary_t=summary_t, summary_j=summary_j, eager=eager, lazy=lazy,
                lazy_clouds=lazy_clouds)


def test_cli_full_matches_pcr_tpu(mini, full):
    out, gt = full["out"], mini["gt"]
    s_t, s_j = full["summary_t"], full["summary_j"]
    assert set(s_t) == set(s_j)
    assert s_t["methods"] == s_j["methods"] == ["LUM", "SLERP", "SLERP_LUM", "pose_graph"]
    assert s_t["config"] == {**s_j["config"], "output_root": s_t["config"]["output_root"]}
    assert s_t["success_rate"] == s_j["success_rate"] == 1.0
    for root in ("cli", "jax"):
        rel1 = _rel(out / root, "relative_poses_FGR")
        for k in range(N):
            _, dt = se3.pose_errors(rel1[k], gt[k])
            assert float(dt) < 0.25, (root, k, dt)
    np.testing.assert_allclose(_rel(out / "cli", "relative_poses_FGR_GICP"),
                               _rel(out / "jax", "relative_poses_FGR_GICP"), atol=5e-3)
    for m in CLOSED:
        np.testing.assert_allclose(_abs(out / "cli", m), _abs(out / "jax", m), atol=1e-2,
                                   err_msg=m)
    assert np.isfinite(_abs(out / "cli", "pose_graph")).all()


def test_cli_full_equals_run_full_on_port_loaded_clouds(full):
    out, eager = full["out"], full["eager"]
    np.testing.assert_allclose(_rel(out / "cli", "relative_poses_FGR"), eager["stage1"],
                               atol=1e-5)
    np.testing.assert_allclose(_rel(out / "cli", "relative_poses_FGR_GICP"), eager["stage2"],
                               atol=1e-5)
    for m, poses in eager["stage3"].items():
        np.testing.assert_allclose(_abs(out / "cli", m), poses, atol=1e-5, err_msg=m)


def test_run_full_over_lazy_clouds_equals_eager(full):
    eager, lazy = full["eager"], full["lazy"]
    for stage in ("stage1", "stage2"):
        np.testing.assert_allclose(lazy[stage], eager[stage], atol=1e-5, err_msg=stage)
    for m, poses in eager["stage3"].items():
        np.testing.assert_allclose(lazy["stage3"][m], poses, atol=1e-5, err_msg=m)
    assert len(full["lazy_clouds"]._cache) == 2      # the LRU held keep=2 scans


def test_cli_stage1_then_stage2(mini, tmp_path):
    out = str(tmp_path / "out")
    s1 = _main(t_cli, ["stage1", *ARGS, "--output-root", out], device="cpu")
    assert s1["success_rate"] > 0.7
    assert os.path.exists(os.path.join(out, "relative_poses_FGR", "Facade", "pose_1_0.txt"))
    s2 = _main(t_cli, ["stage2", *ARGS, *REFINE, "--output-root", out], device="cpu")
    assert s2["success_rate"] > 0.7 and "success_rate_finest_scale" in s2
    rel = _rel(out, "relative_poses_FGR_GICP")
    for k in range(N):
        _, dt = se3.pose_errors(rel[k], mini["gt"][k])
        assert float(dt) < 0.08, (k, dt)


def test_cli_pair_matches_pcr_tpu(mini, tmp_path):
    out = str(tmp_path / "out")
    s = _main(t_cli, ["pair", "--dataset", "Facade", "--src", "2", "--tgt", "0",
                      "--voxel-size", "0.2", *REFINE, "--output-root", out], device="cpu")
    T_gt = np.linalg.inv(mini["absolute"][0]) @ mini["absolute"][2]
    _, dt = se3.pose_errors(np.asarray(s["T"]), T_gt)
    assert float(dt) < 0.1, dt
    assert os.path.exists(os.path.join(out, "relative_poses_FGR_GICP", "Facade", "pose_2_0.txt"))
    assert os.path.exists(os.path.join(out, "metrics", "Facade", "pair_2_0.jsonl"))
    cfg_j = j_pipe.PipelineConfig(dataset="Facade", voxel_size=0.2, mgicp_scales=2,
                                  mgicp_iterations=15, output_root=str(tmp_path / "jax"))
    want = j_pipe.run_pair(cfg_j, 2, 0)
    assert set(s) == set(want) | {"command", "n", "config"}
    np.testing.assert_allclose(s["T"], want["T"], atol=5e-3)


@pytest.mark.parametrize("init", ["fixture", "array"])
def test_run_pair_seeds_match_pcr_tpu(mini, tmp_path, init):
    """run_pair seeded from the absolute fixtures (inv(A_tgt) @ A_src) or
    from a given 4x4 pose: no FGR, then the same M-GICP as pcr_tpu's."""
    A = mini["absolute"]
    seed = "fixture" if init == "fixture" else np.linalg.inv(A[1]) @ A[3]
    kw = dict(dataset="Facade", voxel_size=0.2, mgicp_scales=2, mgicp_iterations=15)
    got = t_pipe.run_pair(t_pipe.PipelineConfig(output_root=str(tmp_path / "t"), **kw), 3, 1,
                          init=seed, device="cpu")
    want = j_pipe.run_pair(j_pipe.PipelineConfig(output_root=str(tmp_path / "j"), **kw), 3, 1,
                           init=seed)
    assert set(got) == set(want) and "fgr_fitness" not in got
    np.testing.assert_allclose(got["T"], want["T"], atol=5e-3)
    _, dt = se3.pose_errors(np.asarray(got["T"]), np.linalg.inv(A[1]) @ A[3])
    assert float(dt) < 0.1, dt
    assert got["info_trace"] == pytest.approx(want["info_trace"], rel=1e-3)
    # a point mesh is a parallel.mesh.Mesh (the point-sharded branch runs:
    # tests/test_torch_parallel.py)
    with pytest.raises(TypeError, match="Mesh"):
        t_pipe.run_pair(t_pipe.PipelineConfig(**kw), 3, 1, init=seed, point_mesh=object(),
                        device="cpu")


def test_stage3_closed_form_from_reference_fixtures(mini, tmp_path):
    """Twin of tests/test_cli.py's, on fixture files written into a
    temporary reference root."""
    argv = ["stage3", "--dataset", "Facade", "--relative", "reference",
            "--methods", *CLOSED]
    s = _main(t_cli, [*argv, "--output-root", str(tmp_path / "t")], device="cpu")
    _main(j_cli, [*argv, "--output-root", str(tmp_path / "j")])
    assert s["methods"] == sorted(CLOSED)
    for name in s["methods"]:
        poses = _abs(tmp_path / "t", name)
        assert poses.shape == (N, 4, 4)
        np.testing.assert_allclose(poses[0], np.eye(4), atol=1e-9)
        np.testing.assert_allclose(poses, _abs(tmp_path / "j", name), atol=1e-9)


def test_stage3_without_the_pose_graph_loads_no_scans(mini, tmp_path, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("stage3 loaded scans for the closed forms")

    monkeypatch.setattr(t_pipe, "_load_circuit_clouds", refuse)
    s = _main(t_cli, ["stage3", "--dataset", "Facade", "--relative", "reference",
                      "--methods", "SLERP", "--output-root", str(tmp_path)], device="cpu")
    assert s["methods"] == ["SLERP"]


def test_report_exports_artifacts(mini, tmp_path):
    """Twin of tests/test_cli.py's: stage 3's output is the report's input;
    the trajectory PLY byte for byte as pcr_tpu's report writes it, and the
    pose-error plot (the reference absolutes are on disk here)."""
    for cli, root, kw in ((t_cli, tmp_path / "t", {"device": "cpu"}), (j_cli, tmp_path / "j", {})):
        _main(cli, ["stage3", "--dataset", "Facade", "--relative", "reference",
                    "--methods", "SLERP", "--output-root", str(root)], **kw)
    s = _main(t_cli, ["report", "--dataset", "Facade", "--methods", "SLERP",
                      "--output-root", str(tmp_path / "t")], device="cpu")
    want = _main(j_cli, ["report", "--dataset", "Facade", "--methods", "SLERP",
                         "--output-root", str(tmp_path / "j")])
    assert [os.path.basename(p) for p in s["artifacts"]] == ["traj_SLERP.ply", "pose_errors.png"]
    assert ([os.path.basename(p) for p in s["artifacts"]]
            == [os.path.basename(p) for p in want["artifacts"]])
    for p in s["artifacts"]:
        assert os.path.exists(p)
    with open(s["artifacts"][0], "rb") as a, open(want["artifacts"][0], "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("flag", ["--devices", "--shard-points"])
def test_cli_refuses_device_meshes(mini, tmp_path, flag):
    """Outside a launcher a mesh of more than one device is refused, naming
    the torchrun command that starts its ranks (one process a device): a
    pair mesh of 2 (``--devices 2``), a (2, 2) mesh (``--devices 2
    --shard-points 2``) or a point mesh of 2 (``pair --shard-points 2``).
    The branches run under a launcher: tests/test_torch_parallel.py."""
    for command in ("full", "stage2", "pair"):
        extra = ["--src", "1", "--tgt", "0"] if command == "pair" else []
        mesh = (["--devices", "2"] if flag == "--devices"
                else ["--shard-points", "2"] if command == "pair"
                else ["--devices", "2", "--shard-points", "2"])
        ranks = 4 if len(mesh) == 4 else 2
        with pytest.raises(ValueError, match=f"torchrun --nproc-per-node {ranks}"):
            t_cli.main([command, *ARGS, *extra, *mesh, "--output-root", str(tmp_path)],
                       device="cpu")


def test_runners_load_the_dataset_when_given_no_clouds(tmp_path, monkeypatch):
    """clouds=None reads the scans (no NotImplementedError any more): with
    none on disk every runner raises the loader's FileNotFoundError."""
    monkeypatch.setattr(t_poses, "REFERENCE_ROOT", str(tmp_path))
    cfg = t_pipe.PipelineConfig(dataset="Facade", output_root=str(tmp_path), batch_size=1)
    for run in (lambda: t_pipe.run_stage1_fgr(cfg, n=N),
                lambda: t_pipe.run_stage2_mgicp(cfg, init_poses=np.tile(np.eye(4), (N, 1, 1)),
                                                n=N),
                lambda: t_pipe.run_full(cfg, n=N),
                lambda: t_pipe.run_stage3_global(cfg, relative_poses=np.tile(np.eye(4), (N, 1, 1)),
                                                 n=N, methods=("pose_graph",)),
                lambda: t_pipe.run_pair(cfg, 1, 0, device="cpu")):
        with pytest.raises(FileNotFoundError, match=r"available indices: \[\]"):
            run()


def test_load_circuit_clouds_streams_large_circuits(mini, monkeypatch):
    """Above 32 scans the runners' loader returns a LazyClouds, as pcr_tpu's
    does; at or below, the eager list."""
    cfg = t_pipe.PipelineConfig(dataset="Facade")
    eager = t_pipe._load_circuit_clouds(cfg, range(N), device="cpu")
    assert isinstance(eager, list) and len(eager) == N
    monkeypatch.setattr(t_cloud, "load_dataset_host",
                        lambda d, indices=None, capacity=None, device=None:
                        [eager[i % N] for i in indices])
    lazy = t_pipe._load_circuit_clouds(cfg, range(33), device="cpu")
    assert isinstance(lazy, t_cloud.LazyClouds) and len(lazy) == 33


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_module_entry_defaults_to_the_card(mini):
    """`python -m pcr_tpu_torch` runs on the card; without one it stops at
    the first load and names device='cpu'."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PCR_REFERENCE_ROOT"] = str(mini["root"])
    proc = subprocess.run([sys.executable, "-m", "pcr_tpu_torch", "pair", "--dataset", "Facade",
                           "--src", "1", "--tgt", "0", "--output-root", str(mini["root"] / "o")],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "device='cpu'" in proc.stderr, proc.stderr
