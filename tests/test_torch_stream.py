"""The streamed runners' shared mechanism in pcr_tpu_torch/pipeline.py, held
with a fake runner and no clouds: the pair window (``_stream_pairs``: when
each pair is read, in which order, what the tracer and the checkpoint see)
and the scan cache (``_ScanCache``: what it builds and what it keeps).  And
the one check of the stage-1 feature kind (``models/fgr.stage1_features``),
reached through every runner: an unknown kind raises, with no silent
fallback to the selection features.

The runners themselves are held against pcr_tpu and against each other by
tests/test_torch_full.py, test_torch_stage2.py, test_torch_fgr.py,
test_torch_batched.py, test_torch_cli.py and test_torch_parallel.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pcr_tpu_torch import pipeline as t_pipe
from pcr_tpu_torch.models import fgr as t_fgr
from pcr_tpu_torch.utils import cloud as t_cloud
from pcr_tpu_torch.utils import trace


class FakeRunner:
    """Logs the window's calls in order: ("submit", k), ("read", k),
    ("row", k), ("checkpoint", m)."""

    def __init__(self, with_checkpoint=True):
        self.events, self.rows = [], []
        self.checkpoint = self._checkpoint if with_checkpoint else None

    def submit(self, k):
        self.events.append(("submit", k))
        return {"k": k}

    def read(self, k, results):
        assert results == {"k": k}
        self.events.append(("read", k))
        return 10 * k

    def row(self, k, results, value, seconds):
        assert results == {"k": k} and value == 10 * k and seconds > 0
        self.events.append(("row", k))
        self.rows.append(k)

    def _checkpoint(self, m):
        assert len(self.rows) == m      # after the m-th pair's row
        self.events.append(("checkpoint", m))

    def stream(self, ks, inflight):
        t_pipe._stream_pairs(ks, self.submit, self.read, self.row, inflight, self.checkpoint)


@pytest.mark.parametrize("inflight", [0, 1, 2, 4, 7])
def test_window_reads_a_pair_once_inflight_pairs_are_submitted(inflight):
    """Pair k is read right after pair k + max(inflight, 1) - 1 is
    submitted, and before the next submission; the last pairs are read at
    the end.  inflight=0 behaves as 1: each pair is read at once."""
    depth = max(inflight, 1)
    ks = list(range(12))
    runner = FakeRunner()
    runner.stream(ks, inflight)
    want = []
    for k in ks:
        want.append(("submit", k))
        if k - depth + 1 >= 0:
            want += [("read", k - depth + 1), ("row", k - depth + 1)]
    for k in ks[len(ks) - depth + 1:] if depth > 1 else []:
        want += [("read", k), ("row", k)]
    assert runner.events == want


def test_window_reads_in_submission_order():
    """A block of pairs that does not start at 0 (a mesh rank's) is read in
    the order it was submitted, each read's values going to its own row."""
    ks = range(5, 17)
    runner = FakeRunner()
    runner.stream(ks, 3)
    assert [k for e, k in runner.events if e == "read"] == list(ks)
    assert runner.rows == list(ks)


@pytest.mark.parametrize("with_checkpoint", [True, False])
def test_window_checkpoints_every_50_pairs_read(with_checkpoint):
    """The checkpoint runs after pairs 50 and 100 of 120 are read (not
    after the last), and never for a runner that passes none."""
    runner = FakeRunner(with_checkpoint)
    runner.stream(range(120), 4)
    checkpoints = [m for e, m in runner.events if e == "checkpoint"]
    assert checkpoints == ([50, 100] if with_checkpoint else [])
    assert runner.rows == list(range(120))


def test_window_traces_each_read_and_each_pair():
    """Each read is one ``sync`` span at site ``drain`` and each pair one
    ``pair`` span with its k, both nested in the span open around the
    window, in the order of the reads."""
    runner = FakeRunner(with_checkpoint=False)
    trace.reset()
    trace.enable()
    try:
        with trace.span("runner"):
            runner.stream(range(6), 2)
    finally:
        trace.disable()
    spans = trace.snapshot().spans
    trace.reset()
    names = [(s[0], s[5]) for s in spans[1:]]
    assert names == [x for k in range(6)
                     for x in (("sync", {"site": "drain"}), ("pair", {"k": k}))]
    assert all(s[3] == 0 for s in spans[1:])
    assert all(s[1] <= s[2] for s in spans)


def test_scan_cache_keeps_only_scans_s_and_s_plus_1():
    """Over a circuit's pairs (s, s-1), with ``evict(s)`` after each, a
    cache keeps only scans s and s+1: scan s-1 goes, scan s+1 (here built
    ahead for the features) stays.  So each scan is built once a cache,
    plus scan 0 again for the closing pair (0, n-1), and scan 1 again where
    it is built ahead of that pair."""
    n = 5
    built = []
    features = t_pipe._ScanCache(n, lambda i: built.append(("features", i)) or i)
    pyramids = t_pipe._ScanCache(n, lambda i: built.append(("pyramid", i)) or -i)
    for s, t in t_pipe.circuit_pairs(n):
        assert (features[s], pyramids[s]) == (s, -s)
        assert (features[t], pyramids[t]) == (t, -t)
        features[(s + 1) % n]        # built ahead of its pair
        features.evict(s)
        pyramids.evict(s)
        assert set(features) == {s, (s + 1) % n}
        assert set(pyramids) == {s}
    assert sorted(i for kind, i in built if kind == "pyramid") == [0, 0, 1, 2, 3, 4]
    assert sorted(i for kind, i in built if kind == "features") == [0, 0, 1, 1, 2, 3, 4]


def _clouds(n=2, points=300, capacity=512):
    rng = np.random.default_rng(3)
    return [t_cloud.from_numpy(rng.uniform(-2, 2, (points, 3)).astype(np.float32), capacity,
                               device="cpu") for _ in range(n)]


@pytest.mark.parametrize("entry", ["run_full", "run_stage1_fgr_bs1", "run_stage1_fgr_bs2",
                                   "run_pair", "batched_stage1_features", "stage1_features"])
def test_unknown_stage1_features_raises_everywhere(entry, tmp_path, monkeypatch):
    """An unknown ``stage1_features`` raises the one ValueError of
    ``fgr.stage1_features`` through every runner, and from the batched
    function that ``pair_sharding.sharded_fgr_features`` calls: none of
    them runs the selection features in its place."""
    cfg = t_pipe.PipelineConfig(dataset="Facade", output_root=str(tmp_path), batch_size=1,
                                mgicp_scales=2, stage1_features="sorted",
                                bucket_granularity=256, stage1_band=512)
    clouds = _clouds()
    monkeypatch.setattr(t_fgr, "fgr_features", lambda *a, **k: pytest.fail("selection ran"))
    monkeypatch.setattr(t_cloud, "load_dataset", lambda *a, **k: clouds)
    runs = {
        "run_full": lambda: t_pipe.run_full(cfg, clouds=clouds, n=2),
        "run_stage1_fgr_bs1": lambda: t_pipe.run_stage1_fgr(cfg, clouds=clouds, n=2),
        "run_stage1_fgr_bs2": lambda: t_pipe.run_stage1_fgr(
            dataclasses.replace(cfg, batch_size=2), clouds=clouds, n=2),
        "run_pair": lambda: t_pipe.run_pair(cfg, 1, 0, init="fgr", device="cpu"),
        "batched_stage1_features": lambda: t_fgr.batched_stage1_features(
            t_cloud.stack_clouds(clouds), 0.1, "sorted", 512),
        "stage1_features": lambda: t_fgr.stage1_features(clouds[0], 0.1, "sorted", 512),
    }
    with pytest.raises(ValueError, match="unknown stage1_features 'sorted'"):
        runs[entry]()


@pytest.mark.parametrize("kind", ["banded", "selection"])
def test_stage1_features_batched_equals_one_scan_at_a_time(kind):
    """``batched_stage1_features`` is ``stage1_features`` scan by scan, bit
    for bit, for both kinds."""
    clouds = _clouds(3)
    c, f = t_fgr.batched_stage1_features(t_cloud.stack_clouds(clouds), 0.2, kind, 512)
    for b, one in enumerate(clouds):
        c1, f1 = t_fgr.stage1_features(one, 0.2, kind, 512)
        assert torch.equal(f[b], f1) and torch.equal(c.points[b], c1.points)
        assert torch.equal(c.normals[b], c1.normals)
