"""CPU tests of the benchmark's own parts (``python3 -m pytest portbench``).

The generators repeat by seed, the counting functions match hand counts,
the reference is right on tiny inputs, each cell's control (the reference,
one precision lower, in the program's place) fails the cell's limits at a
small size, the result line has its keys, the harness finds an added
configuration, traffic mix, kind, end-to-end and per-layer metric and
limits by name, and the check for JAX compares whole top-level names.  None
of them needs a card.
"""

from __future__ import annotations

import json
import math
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import reference as ref
from portbench import roofline, run, scene, trace, work

ROOT = Path(__file__).resolve().parent.parent
SMALL = dict(capacity=4096, target_points=1500, noise_m=0.01, side_step_m=1.0)


def _pose(rx, ry, rz, tx, ty, tz):
    T = ref.exp_se3(torch.tensor([rx, ry, rz, tx, ty, tz], dtype=torch.float64))
    return T.numpy()


def test_circuit_repeats_by_seed():
    a = scene.make_circuit(4, 5, 0, **SMALL)
    b = scene.make_circuit(4, 5, 0, **SMALL)
    c = scene.make_circuit(4, 6, 0, **SMALL)
    assert all(np.array_equal(x, y) for x, y in zip(a[0], b[0]))
    assert np.array_equal(a[1], b[1])
    assert not np.array_equal(a[0][0][:100], c[0][0][:100])
    np.testing.assert_allclose(a[1], c[1])               # the path is the configuration's


def test_circuit_closes_and_neighbours_are_near():
    _, gt, absolute = scene.make_circuit(8, 1, 0, **SMALL)
    chain = absolute[0]
    for k in range(8):
        chain = chain @ gt[k]
    np.testing.assert_allclose(chain, absolute[0], atol=1e-9)
    steps = np.linalg.norm(gt[:, :3, 3], axis=1)
    assert steps.min() > 0.2 and steps.max() < 2.0


def test_kgraph_path_repeats_by_seed():
    kw = dict(points=(1500, 2500), steps_m=(0.5, 1.5), noise_m=0.01)
    a = scene.make_kgraph_path(4, 9, 22, **kw)
    b = scene.make_kgraph_path(4, 9, 22, **kw)
    assert all(np.array_equal(x, y) for x, y in zip(a[0], b[0]))
    assert abs(len(a[0][0]) - 1500) < 200 and abs(len(a[0][-1]) - 2500) < 250


def test_large_seed(tmp_path):
    scans, _, _ = scene.make_circuit(4, 2**31 + 12345, 0, **SMALL)
    assert len(scans) == 4


def test_pcd_writer_layout(tmp_path):
    pts = np.arange(12, dtype=np.float32).reshape(4, 3)
    path = tmp_path / "s0.pcd"
    scene.write_pcd(path, pts)
    raw = path.read_bytes()
    head, body = raw.split(b"DATA binary\n")
    assert b"POINTS 4" in head and b"FIELDS x y z" in head
    np.testing.assert_array_equal(np.frombuffer(body, "<f4").reshape(4, 3), pts)


def test_union_by_hand():
    assert trace.union_s([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == pytest.approx(4.0)
    assert trace.union_s([]) == 0.0


def test_k1_bound_by_hand():
    # 2 tiles of 4 queries against 2*8 slab rows: 9 * 2 * 4 * 16 = 1152 ops;
    # bytes 4*2 + 12*8 + 12*40 + 8*8 = 648
    assert roofline.k1_bound_s(2, 8, 40, 4, 8) == pytest.approx(
        max(648 / 3.35e12, 1152 / 67e12))
    # at NCLT's finest GICP shape the operations bound it
    big = roofline.k1_bound_s(21, 21504, 21504, 1024, 1024)
    assert big == pytest.approx(9 * 21 * 1024 * 2048 / 67e12)


def test_k11_bound_by_hand():
    assert roofline.k11_bound_s(24576, 24576) == pytest.approx(71 * 24576 ** 2 / 67e12)
    assert roofline.k11_bound_s(1, 1) == pytest.approx((4 * 33 * 2 + 18) / 3.35e12)


def test_se3_round_trip():
    xi = torch.tensor([[0.3, -0.2, 0.1, 1.0, 2.0, -3.0], [1e-9, 0, 0, 0.1, 0, 0]],
                      dtype=torch.float64)
    np.testing.assert_allclose(ref.log_se3(ref.exp_se3(xi)).numpy(), xi.numpy(), atol=1e-12)


def test_icp_recovers_a_known_pose():
    rng = np.random.default_rng(0)
    # three perpendicular planes and a sphere: all six degrees constrained
    u = rng.uniform(-2, 2, (3000, 2))
    pts = np.concatenate([np.c_[u, np.zeros(3000)], np.c_[u[:, :1], np.zeros(3000), u[:, 1:]],
                          np.c_[np.zeros(3000), u], scene._sphere(rng, 3000, [1, 1, 1], 0.7)])
    T = _pose(0.02, -0.01, 0.03, 0.05, -0.04, 0.02)
    src = (pts - T[:3, 3]) @ T[:3, :3]                   # T maps src into pts
    got = ref.icp(src, pts, np.eye(4), voxel=1e-3, max_dist=0.3)   # no merging
    np.testing.assert_allclose(got, T, atol=1e-6)


def test_fitness_and_information_by_hand():
    tgt = np.array([[0.0, 0, 0], [1, 0, 0], [0, 1, 0]])
    src = np.array([[0.0, 0, 0.05], [5, 5, 5]])
    assert ref.fitness(src, tgt, np.eye(4), 0.1) == pytest.approx(0.5)
    info = ref.information(src, tgt, np.eye(4), 0.1)
    # one correspondence, matched point q = 0: G = [0 | I]
    want = np.zeros((6, 6))
    want[3:, 3:] = np.eye(3)
    np.testing.assert_allclose(info, want)


def _consistent_circuit(n=6):
    # yaws alone, so the reference's reversed rotation chain closes too
    rel = [_pose(0, 0, 0.01 * k + 0.02, 0.5 + 0.1 * k, 0.1, 0.0) for k in range(n - 1)]
    chain = np.eye(4)
    for T in rel:
        chain = chain @ T
    rel.append(np.linalg.inv(chain))                     # closes exactly
    return np.stack(rel)


def test_closed_forms_return_the_chain_on_a_closed_circuit():
    rel = _consistent_circuit()
    # the reference convention: node i rotation R_{i-1} ... R_0
    lum = ref.lum(rel)
    Rabs = np.eye(3)
    for i in range(1, len(rel)):
        Rabs = rel[i - 1][:3, :3] @ Rabs
        np.testing.assert_allclose(lum[i][:3, :3], Rabs, atol=1e-12)
    np.testing.assert_allclose(ref.slerp(rel)[:, :3, :3], lum[:, :3, :3], atol=1e-9)
    np.testing.assert_allclose(ref.slerp_lum(rel), ref.lum(rel), atol=1e-9)


def test_pose_graph_keeps_a_consistent_circuit():
    rel = _consistent_circuit()
    n = len(rel)
    info = np.broadcast_to(np.diag([2e6] * 3 + [2e4] * 3), (n, 6, 6))
    nodes, it = ref.pose_graph(ref.chain_standard(rel), np.arange(n), np.r_[np.arange(1, n), 0],
                               np.linalg.inv(rel), info, np.arange(n) == n - 1, max_corr=0.2,
                               prune=0.25)
    np.testing.assert_allclose(nodes, ref.chain_standard(rel), atol=1e-9)
    assert it["pruned"] == 0


def test_pose_graph_spreads_a_closure_error():
    rel = _consistent_circuit()
    rel[-1] = rel[-1] @ _pose(0, 0, 0, 0.01, 0, 0)        # 1 cm off
    n = len(rel)
    info = np.broadcast_to(np.eye(6) * 1e3, (n, 6, 6))
    nodes, it = ref.pose_graph(ref.chain_standard(rel), np.arange(n), np.r_[np.arange(1, n), 0],
                               np.linalg.inv(rel), info, np.arange(n) == n - 1, max_corr=0.2,
                               prune=0.25)
    assert it["pruned"] == 0
    loop = np.linalg.inv(nodes[0]) @ nodes[-1] @ rel[-1]
    # the loop edge keeps part of the error and the chain takes the rest
    assert 1e-4 < np.linalg.norm(loop[:3, 3] - nodes[0][:3, 3]) < 0.01


def test_pose_gap_by_hand():
    T = _pose(0, 0, math.radians(0.001), 0.003, 0.004, 0)
    mm, mdeg = work.pose_gap(T, np.eye(4))
    assert mm == pytest.approx(5.0, rel=1e-6) and mdeg == pytest.approx(1.0, rel=1e-6)


def test_result_line_parts():
    units = [(0.0, 0.3, 32), (0.3, 0.5, 32), (0.5, 1.0, 32)]
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    m = run.end_to_end(ROOT / "portbench", bench["end_to_end"], units, 1.0, 12.5)
    assert m["pairs_per_s"] == (96.0, "pairs/s")
    assert m["refine_s"] == (1.0 / 3, "s")
    assert m["setup_s"] == (12.5, "s")
    assert m["pair_p90_ms"][0] == pytest.approx(460.0)
    ok, checks = run.check_lines({"a": 1.0, "b": 3.0}, {"a": 2.0, "b": 2.0})
    assert not ok and list(checks) == ["a", "b"] and checks["b"] == {"value": 3.0, "limit": 2.0}
    ok, _ = run.check_lines({"a": 1.0}, {"a": 2.0, "c": 1.0})
    assert not ok                                       # a limited number must be read


def test_forbidden_modules_by_whole_names():
    assert run.forbidden_modules({"pcr_tpu_torch", "pcr_tpu_torch.ops", "numpy"}) == []
    assert run.forbidden_modules({"pcr_tpu.ops.knn", "jaxlib.xla", "flax"}) == [
        "flax", "jaxlib", "pcr_tpu"]
    assert run.forbidden_modules({"jax_thing", "jaxlibs"}) == []


def test_harness_imports_no_jax():
    code = ("import sys; import portbench.run, portbench.work, portbench.reference, "
            "portbench.trace, portbench.control; "
            "print(portbench.run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_every_entry_has_its_files():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    pb = ROOT / "portbench"
    for w in bench["workloads"]:
        spec = run.load_spec(ROOT, w["name"])
        assert (pb / "kinds" / f"{spec['traffic']['kind']}.py").is_file()
        assert spec["limits"]
    for m in bench["end_to_end"]:
        assert callable(work.load_file(pb / "end_to_end" / f"{m['name']}.py", m["name"]).read)
    for m in bench["per_layer"]:
        assert callable(run.load_reader(pb, m["name"]).read)


KIND = '''
from portbench.work import Kind


class Runner(Kind):
    def setup(self):
        self.clouds = [self.seed]

    def unit(self, k):
        return {"k": k, "value": self.traffic["value"]}

    def work(self, out):
        return 2

    def judge(self, outputs):
        return {"off": max(abs(o["value"] - 1.0) for o in outputs)}
'''


def test_added_files_are_found_by_name(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    pb = tmp_path / "portbench"
    cfg = json.loads((pb / "configs" / "nclt-circuit.json").read_text())
    cfg["scans"]["target_points"] = 12000
    (pb / "configs" / "nclt-sparse.json").write_text(json.dumps(cfg))
    (pb / "traffic" / "seq16.json").write_text(json.dumps(
        {"kind": "circuit", "scans": 16, "methods": ["LUM"], "trace_units": 1}))
    (pb / "limits" / "nclt-sparse16.json").write_text(json.dumps({"gicp_mm": 5.0}))
    # a new kind of traffic, its mix, cell and limits, and a new end-to-end metric
    (pb / "kinds" / "echo.py").write_text(KIND)
    (pb / "traffic" / "echo1.json").write_text(json.dumps({"kind": "echo", "value": 1.0}))
    (pb / "limits" / "nclt-echo.json").write_text(json.dumps({"off": 0.0}))
    (pb / "end_to_end" / "units_per_s.py").write_text(
        "def read(units, window_s, setup_s):\n    return len(units) / window_s\n")
    (pb / "metrics" / "units_traced.py").write_text(
        "def read(trace):\n    return trace.units\n")
    bench["configs"].append({"name": "nclt-sparse", "source": "x",
                             "file": "portbench/configs/nclt-sparse.json", "reduced": [],
                             "why": "x"})
    bench["workloads"] += [{"name": "nclt-sparse16", "config": "nclt-sparse",
                            "traffic": "seq16", "chips": 1, "why": "x"},
                           {"name": "nclt-echo", "config": "nclt-circuit", "traffic": "echo1",
                            "chips": 1, "why": "x"}]
    bench["end_to_end"][0]["workloads"].append("nclt-sparse16")
    bench["end_to_end"].append({"name": "units_per_s", "unit": "units/s", "better": "higher",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["nclt-echo"]})
    bench["per_layer"] += [
        {"name": "units_traced.new", "unit": "units", "better": "higher",
         "source": "program_counter", "layer": "device", "moves": "pairs_per_s"},
        {"name": "units_traced.echo", "unit": "units", "better": "higher",
         "source": "program_counter", "layer": "device", "moves": "units_per_s",
         "workloads": ["nclt-echo"]}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = run.load_spec(tmp_path, "nclt-sparse16")
    assert spec["config"]["scans"]["target_points"] == 12000
    assert spec["traffic"]["scans"] == 16 and spec["limits"] == {"gicp_mm": 5.0}
    assert [m["name"] for m in spec["end_to_end"]] == ["pairs_per_s", "setup_s"]
    names = [m["name"] for m in spec["per_layer"]]
    assert "units_traced.new" in names and "plan_caps_ms.pairs" not in names
    # a metric without a workloads key goes to every cell that reports what it moves
    assert "units_traced.new" in [m["name"] for m in run.load_spec(tmp_path, "nclt-seq32")
                                  ["per_layer"]]
    assert "units_traced.new" not in [m["name"] for m in run.load_spec(
        tmp_path, "nclt-refine901")["per_layer"]]
    # two metrics share the reader of their name's first part
    for name in ("units_traced.new", "units_traced.echo"):
        reader = run.load_reader(spec["base"], name)
        assert reader.read(trace.Trace(1.0, 0.5, 3, 96, {}, {}, [])) == 3
    # the new kind's cell runs a window, is judged and read by its own files
    spec = run.load_spec(tmp_path, "nclt-echo")
    assert [m["name"] for m in spec["end_to_end"]] == ["setup_s", "units_per_s"]
    assert [m["name"] for m in spec["per_layer"]] == ["units_traced.echo"]
    runner = work.make(spec["base"], spec["config"], spec["traffic"], 2**40 + 3, "cpu", "")
    runner.setup()
    units, window_s, outputs = run.run_window(runner, 0.01)
    ok, checks = run.check_lines(runner.judge(outputs), spec["limits"])
    assert ok and checks == {"off": {"value": 0.0, "limit": 0.0}}
    m = run.end_to_end(spec["base"], spec["end_to_end"], units, window_s, 7.0)
    assert m["setup_s"] == (7.0, "s") and m["units_per_s"][1] == "units/s"
    assert m["units_per_s"][0] == pytest.approx(len(units) / window_s)


SMALL_CELLS = {
    "nclt-seq32": {"scans": {"capacity": 4096, "target_points": 1500}, "traffic": {"scans": 4}},
    "facade-k2": {"scans": {"capacity": 4096, "points": [1500, 2500]}, "traffic": {"scans": 4}},
    "nclt-pair-online": {"scans": {"capacity": 4096, "target_points": 1500},
                         "traffic": {"scans": 4, "check_pairs": 4}},
    "nclt-refine901": {"traffic": {"nodes": 60}},
}


@pytest.mark.parametrize("workload", sorted(SMALL_CELLS))
def test_control_fails_the_cells_limits(workload, tmp_path, monkeypatch):
    """The reference one precision lower in the program's place (bfloat16 for
    the card's float32, float32 for the host's float64 closed forms), as
    ``control.py`` reads it on the card at the cell's own size, here at a
    small size: it has to come out not correct."""
    spec = run.load_spec(ROOT, workload)
    cfg, traffic = json.loads(json.dumps(spec["config"])), dict(spec["traffic"])
    cfg.get("scans", {}).update(SMALL_CELLS[workload].get("scans", {}))
    traffic.update(SMALL_CELLS[workload]["traffic"])
    monkeypatch.setenv("PCR_REFERENCE_ROOT", str(tmp_path / "reference"))
    runner = work.make(spec["base"], cfg, traffic, 4100000021, torch.device("cpu"),
                       str(tmp_path))
    runner.setup()
    outs = runner.control(torch.bfloat16)
    runner.release()
    nums = runner.judge(outs if isinstance(outs, list) else [outs])
    ok, checks = run.check_lines(nums, spec["limits"])
    print(workload, json.dumps(checks))
    assert not ok


def test_refuses_without_the_program(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, "-m", "portbench", "--workload", "nclt-seq32",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout == ""


def test_spans_are_counted_from_the_profile():
    wraps = trace.Wraps({"bound": ("portbench.roofline", "bound_s",
                                   lambda n_bytes, ops: (n_bytes, ops))})
    with wraps.installed(), trace.profiler() as prof:
        with torch.profiler.record_function(trace.SPAN_PREFIX + "window"):
            for k in range(3):
                roofline.bound_s(k, torch.ones(4).sum().item())
    assert roofline.bound_s.__name__ == "bound_s" and not hasattr(roofline.bound_s,
                                                                  "__wrapped__")
    # the profiler observed the spans and none of the operators on the host
    assert not [e for e in prof.profiler.kineto_results.events() if e.name().startswith("aten::")]
    busy, spans, kernels, gaps = trace.reduce(prof, ["bound"])
    assert spans["bound"].count == 3 and wraps.shapes["bound"] == [(0, 4.0), (1, 4.0),
                                                                   (2, 4.0)]
    assert busy == 0.0 and kernels == {}            # no device here
    assert len(gaps) == 1                           # the whole window, idle
