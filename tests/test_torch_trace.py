"""The port's tracer (``pcr_tpu_torch.utils.trace``): off it is one shared
no-op and records nothing; on, a small circuit through ``run_full`` gives one
``pair`` span a pair, one ``gicp.scale`` span a scale of each pair, the GICP
and LM iteration counters the rows and the optimiser report, every span
inside its root, and the same poses and metrics rows as with it off; a span's
clock is the profiler's; ``LAUNCHES`` stays the launch counter; ``--trace
FILE`` writes the spans as Chrome trace-event JSON; on 2 gloo ranks each
collective is one span with the payload it sends.  On the card (``cuda``
marker) the tracer adds no device read.

This file imports neither jax nor pcr_tpu, so it also runs on the card:

    python -m pytest tests/test_torch_trace.py -q --noconftest
"""

import collections
import contextlib
import io
import json
import pickle
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import pcr_tpu_torch
from pcr_tpu_torch import __main__ as cli
from pcr_tpu_torch import pipeline
from pcr_tpu_torch.ops.kernels import nn_kernels
from pcr_tpu_torch.utils import cloud, pcd, poses_io, trace

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
N = 4
KW = dict(dataset="Facade", voxel_size=0.2, mgicp_scales=2, mgicp_iterations=25,
          bucket_granularity=256, stage1_band=512)
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy")


def bumpy_circuit(n_clouds=N, n=800, step=0.3):
    """Scan i views one bumpy surface from a frame shifted by i*step with
    yaw 0.05*i (tests/test_torch_stage2.bumpy_circuit, seed 0)."""
    rng = np.random.default_rng(0)
    scans = []
    for i in range(n_clouds):
        xy = rng.uniform(-4, 4, size=(n, 2)).astype(np.float32)
        xy[:, 0] += i * step
        z = (np.sin(1.3 * xy[:, :1]) * 0.5 + np.cos(0.9 * xy[:, 1:2]) * 0.4
             + 0.2 * np.sin(2.7 * xy[:, :1] * xy[:, 1:2] / 4))
        c, s = np.cos(0.05 * i), np.sin(0.05 * i)
        R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
        t = np.array([i * step, 0.1 * i, 0.0])
        world = np.concatenate([xy, z], axis=1)
        scans.append(((world - t) @ R).astype(np.float32))
    return scans


@contextlib.contextmanager
def tracing():
    trace.reset()
    trace.enable()
    try:
        yield
    finally:
        trace.disable()


def run_full(out_root, device, traced: bool):
    """(run_full's output, its metrics, the tracer's snapshot) of the circuit."""
    clouds = [cloud.from_numpy(s, 1024, device=device) for s in bumpy_circuit()]
    metrics = pipeline.PairMetrics()
    with tracing() if traced else contextlib.nullcontext():
        out = pipeline.run_full(pipeline.PipelineConfig(output_root=str(out_root), **KW),
                                clouds=clouds, n=N, metrics=metrics)
    return out, metrics, trace.snapshot()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("trace")
    trace.reset()
    return {"off": run_full(root / "off", "cpu", False), "on": run_full(root / "on", "cpu", True),
            "root": root}


def _by_name(spans, name):
    return [(i, s) for i, s in enumerate(spans) if s[0] == name]


def test_off_is_one_shared_noop_and_records_nothing(runs):
    assert trace.span("a") is trace.span("b", k=1)
    _, _, snap = runs["off"]
    assert snap.spans == [] and snap.shapes == {}
    assert all(k.startswith("launches.") and v == 0 for k, v in snap.counters.items())


def test_one_pair_span_a_pair_and_one_scale_span_a_scale(runs):
    _, metrics, snap = runs["on"]
    rows = [r for r in metrics.rows if r["stage"] == "mgicp"]
    assert [r["status"] for r in rows] == ["ok"] * N        # no retry ran
    pairs = _by_name(snap.spans, "pair")
    assert [s[5]["k"] for _, s in pairs] == list(range(N))
    scales = _by_name(snap.spans, "gicp.scale")
    assert [s[5]["scale"] for _, s in scales] == list(range(KW["mgicp_scales"])) * N
    # the GICP loop counts its iterations where it runs them: the counter is
    # the rows' sum, and each scale's convergence reads are its iterations
    assert snap.counters["gicp.iterations"] == sum(sum(r["scale_iterations"]) for r in rows)
    reads = collections.Counter(s[3] for s in snap.spans
                                if s[0] == "sync" and s[5]["site"] == "gicp")
    its = [reads[i] for i, _ in scales]
    assert np.reshape(its, (N, -1)).tolist() == [r["scale_iterations"] for r in rows]


def test_scale_and_sync_counters(runs):
    """``gicp.iterations.s<i>`` is scale i's share of ``gicp.iterations``;
    ``syncs`` counts the blocking reads."""
    _, metrics, snap = runs["on"]
    rows = [r for r in metrics.rows if r["stage"] == "mgicp"]
    per_scale = np.sum([r["scale_iterations"] for r in rows], axis=0).tolist()
    assert [snap.counters[f"gicp.iterations.s{i}"]
            for i in range(KW["mgicp_scales"])] == per_scale
    assert sum(per_scale) == snap.counters["gicp.iterations"]
    assert snap.counters["syncs"] == sum(s[0] == "sync" for s in snap.spans) > 0


def test_pair_seconds_are_the_pair_spans(runs):
    """A row's ``seconds`` is its pair's submission-to-read interval."""
    _, metrics, snap = runs["on"]
    spans = {s[5]["k"]: (s[2] - s[1]) * 1e-9 for _, s in _by_name(snap.spans, "pair")}
    for stage in ("fgr", "mgicp"):
        rows = [r for r in metrics.rows if r["stage"] == stage]
        assert [r["seconds"] for r in rows] == [spans[k] for k in range(N)]


def test_lm_iterations_are_counted_where_they_run(runs):
    _, _, snap = runs["on"]
    path = runs["root"] / "on" / "metrics" / "Facade" / "stage3_consistency.json"
    opt = json.loads(path.read_text())["pose_graph"]["optimizer"]
    its = opt["pass1_iterations"] + opt["pass2_iterations"]
    iterations = _by_name(snap.spans, "lm.iteration")
    assert snap.counters["lm.iterations"] == len(iterations) == its > 0
    cost_reads = [s for s in snap.spans if s[0] == "sync" and s[3] in dict(iterations)]
    assert len(cost_reads) == its and {s[5]["site"] for s in cost_reads} == {"lm.cost"}


def test_every_span_nests_in_its_root(runs):
    spans = runs["on"][2].spans
    assert spans[0][0] == "run_full" and spans[0][3] == -1
    for i, (name, a, b, parent, root, _) in enumerate(spans):
        assert a <= b, name
        assert root == 0, name
        if i:
            assert 0 <= parent < i, name
            assert spans[parent][1] <= a and b <= spans[parent][2], name


def test_tracing_changes_no_result(runs):
    (out0, m0, _), (out1, m1, _) = runs["off"], runs["on"]
    for stage in ("stage1", "stage2"):
        assert np.array_equal(out0[stage], out1[stage]), stage
    assert all(np.array_equal(out0["stage3"][m], out1["stage3"][m]) for m in out0["stage3"])

    def rows(m):
        return [{k: v for k, v in r.items() if k != "seconds"} for r in m.rows]

    assert rows(m0) == rows(m1)


def test_span_names_are_not_the_benchmarks():
    """The program's spans and the benchmark's own (each reader's ``WRAPS``)
    have distinct names, so a trace holding both is read without doubt."""
    from portbench import work

    src = "".join(p.read_text() for p in Path(pcr_tpu_torch.__file__).parent.rglob("*.py"))
    program = set(re.findall(r'trace\.(?:span|spanned|record)\("([^"]+)"', src))
    assert {"run_full", "run_pair", "pair", "gicp.scale", "sync", "lm.iteration"} <= program
    wraps = set()
    for path in sorted((ROOT / "portbench" / "metrics").glob("*.py")):
        wraps |= set(getattr(work.load_file(path, f"wraps_{path.stem}"), "WRAPS", {}))
    assert wraps and not program & wraps, program & wraps


def test_span_clock_is_the_profilers():
    """A span starts within 1 ms of a ``record_function`` opened beside it
    (on the card with the device traced as well)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with tracing(), torch.profiler.profile(activities=acts) as prof:
        for i in range(20):
            with trace.span("clock", i=i), torch.profiler.record_function(f"clock{i}"):
                pass
    starts = {e.name(): e.start_ns() for e in prof.profiler.kineto_results.events()
              if e.name().startswith("clock")}
    spans = trace.snapshot().spans
    assert len(spans) == 20
    for _, a, _, _, _, attrs in spans:
        assert abs(starts[f"clock{attrs['i']}"] - a) < 1_000_000, (attrs, starts, a)


def test_launch_counters_stay_in_place():
    """``LAUNCHES`` is the only launch counter: the snapshot reads its change
    since ``reset``, and a shape is kept only while tracing is on."""
    before = dict(nn_kernels.LAUNCHES)
    try:
        with tracing():
            nn_kernels.LAUNCHES["nn1"] += 2
            trace.shape("nn1", 8, 16)
        trace.shape("nn1", 1, 1)
        snap = trace.snapshot()
        assert snap.counters["launches.nn1"] == 2 and snap.shapes == {"nn1": [(8, 16)]}
        trace.reset()
        assert nn_kernels.LAUNCHES["nn1"] == before["nn1"] + 2
        assert trace.snapshot().counters["launches.nn1"] == 0
    finally:
        nn_kernels.LAUNCHES.update(before)


def test_cli_trace_file(tmp_path, monkeypatch):
    """``pair --trace FILE``: the run's spans as Chrome trace events, one
    root, the counters and launch counts under ``otherData``."""
    d = tmp_path / "nuvens" / "nuvens_pre_processadas" / "Facade"
    d.mkdir(parents=True)
    for i, s in enumerate(bumpy_circuit()):
        pcd.write_pcd(str(d / f"s{i}.pcd"), s)
    monkeypatch.setattr(poses_io, "REFERENCE_ROOT", str(tmp_path))
    monkeypatch.setitem(poses_io.CIRCUIT_SIZES, "Facade", N)
    monkeypatch.setitem(cloud.BUCKETS, "Facade", 1024)
    path = tmp_path / "pair.json"
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli.main(["pair", "--dataset", "Facade", "--src", "1", "--tgt", "0",
                         "--voxel-size", "0.2", "--scales", "2", "--iterations", "15",
                         "--output-root", str(tmp_path / "out"), "--trace", str(path)],
                        device="cpu") == 0
    doc = json.loads(path.read_text())
    events = doc["traceEvents"]
    names = collections.Counter(e["name"] for e in events)
    assert names["run_pair"] == 1 and names["gicp.scale"] == 2 and names["data.plan_caps"] == 1
    assert names["data.load"] == 1 and names["features"] == 2 and names["write"] == 1
    assert {e["args"]["root"] for e in events} == {0}
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in events)
    assert doc["otherData"]["counters"]["gicp.iterations"] == names["sync"] - 3
    assert "launches.nn1_band" in doc["otherData"]["counters"]
    assert not trace._on


OBJECT = {"poses": np.arange(32.0).reshape(2, 4, 4), "rows": [{"stage": "mgicp", "src": 1}]}
ROWS = 5


@pytest.fixture(scope="module")
def collective_ranks(tmp_path_factory):
    """Two gloo ranks (tests/torch_parallel_worker.py), each collective
    traced alone."""
    from tests import torch_parallel_worker as worker

    ranks = worker.start(2, "collectives", {"ops": ["all_gather_rows", "all_gather_objects",
                                                    "broadcast_object"],
                                            "rows": ROWS, "object": OBJECT},
                         tmp_path_factory.mktemp("collectives"), limit_s=120)
    try:
        return ranks.join()
    finally:
        ranks.kill()


@pytest.mark.parametrize("op, payloads", [
    ("all_gather_rows", [ROWS * 3 * 4] * 2),
    ("all_gather_objects", [len(pickle.dumps(OBJECT))] * 2),
    ("broadcast_object", [len(pickle.dumps(OBJECT)), 0]),
])
def test_collective_spans_count_the_payload(collective_ranks, op, payloads):
    """On 2 gloo ranks a traced collective is one span ``collective`` with
    its ``op`` and, as ``bytes``, the payload this rank sends (a (5, 3)
    float32 block, an object's pickled size, nothing for a broadcast's
    receiver); the counters ``collective.calls`` and ``collective.bytes``
    say the same."""
    for out, payload in zip(collective_ranks, payloads):
        assert out[op]["spans"] == [("collective", {"op": op, "bytes": payload})]
        assert out[op]["counters"] == {"collective.calls": 1, "collective.bytes": payload}


@pytest.mark.cuda
def test_tracing_adds_no_device_read(tmp_path):
    """On the card: the runtime's synchronising calls and copies per
    circuit are the same with the tracer on and off; every K1 launch left its
    shape; a launch made inside a span lies inside it on the profiler's
    clock, which is how device work is credited to a span."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    run_full(tmp_path / "warm", "cuda", False)          # builds and loads the kernels

    def profiled(traced):
        with torch.profiler.profile(activities=acts) as prof:
            out, _, snap = run_full(tmp_path / str(traced), "cuda", traced)
            torch.cuda.synchronize()
        calls = collections.Counter(e.name() for e in prof.profiler.kineto_results.events()
                                    if e.name().startswith(SYNC_CALLS))
        return out, snap, calls

    out0, _, off = profiled(False)
    out1, snap, on = profiled(True)
    assert sum(off.values()) > 0 and on == off, (off, on)
    assert np.array_equal(out0["stage2"], out1["stage2"])
    assert snap.counters["launches.nn1_band"] == len(snap.shapes["nn1_band"]) > 0

    x = torch.ones(1 << 20, device="cuda")
    torch.cuda.synchronize()
    with tracing(), torch.profiler.profile(activities=acts) as prof:
        with trace.span("clock"):
            y = x * 2.0
            torch.cuda.synchronize()
    _, a, b, _, _, _ = trace.snapshot().spans[0]
    events = prof.profiler.kineto_results.events()
    launch = [e for e in events if e.name().startswith("cudaLaunchKernel")]
    assert len(launch) == 1 and float(y[0]) == 2.0
    assert a <= launch[0].start_ns() <= b
