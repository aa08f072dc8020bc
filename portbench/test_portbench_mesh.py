"""CPU tests of the ``circuit_mesh`` kind (``kinds/circuit_mesh.py``,
``mesh_worker.py``): four gloo ranks on the CPU, three of them spawned as on
the cards.  At a small size a window runs, its judge meets the cell's
limits and the bfloat16 control fails them; a rank that raises makes
``unit`` raise within the timeout and leaves no rank running; a program
whose ``run_full`` takes no ``mesh=`` (the parent of this kind) fails at
once, before any rank starts; the two readers of the mesh layer give known
values, and nothing without their span and counter.

    python3 -m pytest portbench/test_portbench_mesh.py
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from portbench import mesh_worker, program, run, trace, work

ROOT = Path(__file__).resolve().parent.parent
WORKLOAD = "nclt-seq128-4card"
TIMEOUT_S = 60.0
# the window's size: 4 scans (a pair a rank) at half the cell's density, the
# sparsest at which the pose gaps come within the cell's limits on the CPU
SMALL_SCANS, SMALL_POINTS, SMALL_CAPACITY = 4, 12000, 16384


def _runner(tmp_path, monkeypatch, scans: int, points: int, capacity: int,
            timeout_s: float = TIMEOUT_S):
    spec = run.load_spec(ROOT, WORKLOAD)
    cfg, traffic = json.loads(json.dumps(spec["config"])), dict(spec["traffic"])
    cfg["scans"].update(capacity=capacity, target_points=points)
    cfg["mesh"]["timeout_s"] = timeout_s
    traffic["scans"] = scans
    monkeypatch.setenv("PCR_REFERENCE_ROOT", str(tmp_path / "reference"))
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    runner = work.make(spec["base"], cfg, traffic, 4100000021, torch.device("cpu"),
                       str(tmp_path))
    return spec, runner


def run_full_without_mesh(cfg, clouds=None, n=None, metrics=None,
                          methods=("LUM", "SLERP", "SLERP_LUM", "pose_graph")):
    """``pipeline.run_full`` as the parent of this kind has it: no ``mesh=``."""
    raise AssertionError("never called")


def rank_main_failing_on_rank_2(rank, world, port, conn, spec):
    """``mesh_worker.rank_main``, but rank 2's ``run_full`` raises before its
    first collective."""
    if rank == 2:
        from pcr_tpu_torch import pipeline

        def run_full(*args, **kwargs):
            raise RuntimeError("planted failure on rank 2")

        pipeline.run_full = run_full
    mesh_worker.rank_main(rank, world, port, conn, spec)


def test_mesh_window_meets_the_limits_and_the_control_fails_them(tmp_path, monkeypatch):
    spec, runner = _runner(tmp_path, monkeypatch, SMALL_SCANS, SMALL_POINTS, SMALL_CAPACITY,
                           timeout_s=900.0)
    runner.setup()
    try:
        procs = list(runner.ranks.procs)
        units, _, outputs = run.run_window(runner, 0.01)
        control = runner.control(torch.bfloat16)
    finally:
        runner.release()
    assert not any(p.is_alive() for p in procs)
    assert len(units) == 1 and units[0][2] == SMALL_SCANS
    ok, checks = run.check_lines(runner.judge(outputs), spec["limits"])
    print("program", json.dumps(checks))
    assert ok, checks
    ok, checks = run.check_lines(runner.judge([control]), spec["limits"])
    print("control", json.dumps(checks))
    assert not ok


def test_a_rank_that_raises_makes_unit_raise(tmp_path, monkeypatch):
    _, runner = _runner(tmp_path, monkeypatch, 8, 1500, 4096)
    runner.rank_main = rank_main_failing_on_rank_2
    runner.setup()
    procs = list(runner.ranks.procs)
    try:
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="planted failure on rank 2"):
            runner.unit(0)
        assert time.monotonic() - t0 < TIMEOUT_S
        assert not any(p.is_alive() for p in procs)
    finally:
        runner.release()


def test_a_program_without_run_full_mesh_fails_at_once(tmp_path, monkeypatch):
    from pcr_tpu_torch import pipeline

    _, runner = _runner(tmp_path, monkeypatch, 8, 1500, 4096)
    monkeypatch.setattr(pipeline, "run_full", run_full_without_mesh)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="takes no mesh="):
        runner.setup()
    assert time.monotonic() - t0 < 5.0 and runner.ranks is None


def test_mesh_readers_give_known_values_and_none_without_their_span(monkeypatch):
    ms = 1_000_000
    snap = SimpleNamespace(
        spans=[("run_full", 0, 100 * ms, -1, 0, {}),
               ("collective", 10 * ms, 12 * ms, 0, 0, {"op": "all_gather_rows", "bytes": 800}),
               ("mesh.stage3", 50 * ms, 90 * ms, 0, 0, {}),
               ("collective", 90 * ms, 96 * ms, 0, 0, {"op": "broadcast_object", "bytes": 0})],
        counters={"collective.calls": 2, "collective.bytes": 800}, shapes={})
    monkeypatch.setitem(program._state, "snap", snap)
    tr = trace.Trace(1.0, 0.5, 1, 4, {}, {}, [])

    def read(name):
        return run.load_reader(ROOT / "portbench", name).read(tr)

    assert read("collective_ms_per_pair.mesh") == pytest.approx(2.0)     # 8 ms / 4 pairs
    assert read("collective_bytes_per_pair.mesh") == 200.0
    monkeypatch.setattr(snap, "spans", [])
    monkeypatch.setattr(snap, "counters", {})
    assert read("collective_ms_per_pair.mesh") is None
    assert read("collective_bytes_per_pair.mesh") is None
