"""CPU tests of the readers of the program's own spans and counters
(``portbench/program.py`` and the five readers that use it): each gives a
known value on a built ``Trace`` and tracer snapshot, and ``None`` where the
spans or counters are missing or the program has no tracer; the wrapper of a
unit entry point turns the tracer on once, at the window's first unit.

    python3 -m pytest portbench/test_portbench_program.py
"""

from __future__ import annotations

from pathlib import Path
from types import SimpleNamespace

import pytest

from portbench import program, run, trace

ROOT = Path(__file__).resolve().parent.parent
MS = 1_000_000
NEW = ("gicp_iterations_per_pair.pairs", "gicp_iterations_per_pair.online",
       "gicp_launches_per_iteration.pairs", "host_wait_ms_per_pair.pairs",
       "host_wait_ms_per_pair.online", "lm_wait_ms_per_iteration.refine",
       "caps_ms_per_request.online")


def _snap():
    spans = [("run_full", 0, 100 * MS, -1, 0, {}),
             ("data.plan_caps", 1 * MS, 21 * MS, 0, 0, {}),
             ("gicp.scale", 30 * MS, 40 * MS, 0, 0, {"scale": 0}),
             ("sync", 31 * MS, 32 * MS, 2, 0, {"site": "gicp"}),
             ("sync", 35 * MS, 38 * MS, 2, 0, {"site": "gicp"}),
             ("lm.iteration", 50 * MS, 60 * MS, 0, 0, {}),
             ("sync", 58 * MS, 60 * MS, 5, 0, {"site": "lm.cost"})]
    return SimpleNamespace(spans=spans, shapes={},
                           counters={"gicp.iterations": 8, "lm.iterations": 1})


@pytest.fixture
def snap(monkeypatch):
    s = _snap()
    monkeypatch.setitem(program._state, "snap", s)
    return s


def _trace(work=2, spans=None):
    return trace.Trace(1.0, 0.5, 1, work, spans or {}, {}, [])


def _read(name, tr):
    return run.load_reader(ROOT / "portbench", name).read(tr)


def test_readers_of_the_program_give_known_values(snap):
    tr = _trace(spans={"gicp.registration": trace.SpanStat(4, 0.1, 0.01, 2000)})
    assert _read("gicp_iterations_per_pair.pairs", tr) == 4.0
    assert _read("gicp_launches_per_iteration.pairs", tr) == 250.0
    assert _read("host_wait_ms_per_pair.online", tr) == pytest.approx(3.0)   # 6 ms / 2
    assert _read("lm_wait_ms_per_iteration.refine", tr) == pytest.approx(2.0)
    assert _read("caps_ms_per_request.online", tr) == pytest.approx(10.0)


def test_readers_give_none_without_their_spans_or_counters(snap, monkeypatch):
    tr = _trace()
    assert _read("gicp_launches_per_iteration.pairs", tr) is None   # no benchmark span
    monkeypatch.setattr(snap, "spans", [])
    monkeypatch.setattr(snap, "counters", {})
    for name in NEW:
        assert _read(name, _trace(spans={"gicp.registration": trace.SpanStat(1, 0, 0, 9)})) \
            is None, name


def test_a_program_without_the_tracer_gives_none(monkeypatch):
    monkeypatch.setattr(program, "_tracer", lambda: None)
    monkeypatch.setattr(program, "_state", {"on": False, "snap": None})
    program._start()
    assert program.snapshot() is None
    for name in NEW:
        assert _read(name, _trace()) is None, name


def test_the_first_unit_turns_the_tracer_on_once(monkeypatch):
    calls = []
    fake = SimpleNamespace(reset=lambda: calls.append("reset"),
                           enable=lambda: calls.append("enable"),
                           disable=lambda: calls.append("disable"),
                           snapshot=lambda: "snap")
    monkeypatch.setattr(program, "_tracer", lambda: fake)
    monkeypatch.setattr(program, "_state", {"on": False, "snap": None})
    assert program.snapshot() is None                   # the window never started it
    program._start("args", k=1)
    program._start()
    assert calls == ["reset", "enable"]
    assert program.snapshot() == "snap" and program.snapshot() == "snap"
    assert calls == ["reset", "enable", "disable"]


def test_new_readers_wrap_functions_the_program_has():
    import importlib

    for name in NEW:
        for spec in run.load_reader(ROOT / "portbench", name).WRAPS.values():
            assert callable(getattr(importlib.import_module(spec[0]), spec[1])), spec
