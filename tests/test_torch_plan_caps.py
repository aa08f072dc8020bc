"""The pyramid's capacity planner (``utils/cloud.plan_scale_caps``) on the
CPU: its routes, the ``voxel_counts`` wrapper's refusals and chunks, and the
LazyClouds upload that feeds the card's count.  The kernel itself runs in
test_torch_kernels_cuda.py, held bit for bit to ``native.count_voxels``.
This file imports neither jax nor pcr_tpu.
"""

import numpy as np
import pytest
import torch

from pcr_tpu_torch import native
from pcr_tpu_torch.ops.kernels import feature_kernels as fk
from pcr_tpu_torch.utils import cloud, trace

SCALES = [0.8, 0.4, 0.2, 0.1]


def _scans(rng, sizes, capacity):
    """Host clouds of ``sizes`` points (uniform in a 20 m box) padded to
    ``capacity``, valid rows first as the loaders put them."""
    return [cloud.from_numpy(rng.uniform(-10, 10, size=(n, 3)).astype(np.float32), capacity,
                             device="cpu") for n in sizes]


def _with_holes(c: cloud.Cloud, rng) -> cloud.Cloud:
    """The same cloud with every third valid row masked off and the rows
    shuffled, so the valid rows are no prefix."""
    order = torch.as_tensor(rng.permutation(c.capacity))
    mask = c.mask.clone()
    mask[::3] = False
    return cloud.Cloud(points=c.points[order].contiguous(), mask=mask[order].contiguous())


def _expected(clouds, scales):
    """The host count of every (cloud, scale), one native call each."""
    return np.array([[native.count_voxels(c.points.numpy()[c.mask.numpy()], v)
                      for v in scales] for c in clouds], dtype=np.int64)


def _fake_voxel_counts(calls):
    """A stand-in for the kernel on CPU tensors: the native count of each
    view's rows (every row valid), and the number of clouds a call."""
    def count(points, masks, scales):
        assert all(m is None for m in masks)
        calls.append(len(points))
        return torch.tensor([[native.count_voxels(p.numpy(), v) for v in scales]
                             for p in points], dtype=torch.int64)
    return count


def _cpu_points(n=64):
    return torch.zeros((n, 3), dtype=torch.float32)


REFUSALS = {
    "float64 points": lambda: fk.voxel_counts([_cpu_points().double()], [None], [0.1]),
    "points of width 2": lambda: fk.voxel_counts([torch.zeros((64, 2))], [None], [0.1]),
    "1-d points": lambda: fk.voxel_counts([torch.zeros(64)], [None], [0.1]),
    "non-contiguous points": lambda: fk.voxel_counts([torch.zeros((3, 64)).T], [None], [0.1]),
    "uint8 mask": lambda: fk.voxel_counts([_cpu_points()], [torch.ones(64, dtype=torch.uint8)],
                                          [0.1]),
    "mask of other rows": lambda: fk.voxel_counts([_cpu_points()],
                                                  [torch.ones(63, dtype=torch.bool)], [0.1]),
    "fewer masks": lambda: fk.voxel_counts([_cpu_points(), _cpu_points()], [None], [0.1]),
    "no scale": lambda: fk.voxel_counts([_cpu_points()], [None], []),
    "nine scales": lambda: fk.voxel_counts([_cpu_points()], [None], [0.1] * 9),
    "zero scale": lambda: fk.voxel_counts([_cpu_points()], [None], [0.1, 0.0]),
    "no clouds": lambda: fk.voxel_counts([], [], [0.1]),
    "CPU tensors": lambda: fk.voxel_counts([_cpu_points()], [torch.ones(64, dtype=torch.bool)],
                                           [0.1]),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_voxel_counts_refuses(case):
    """The wrapper checks dtype, shape, layout, scales and device before any
    launch: CPU clouds are the host route's, never the kernel's."""
    before = fk.LAUNCHES["voxel_counts"]
    with pytest.raises((TypeError, ValueError)):
        REFUSALS[case]()
    assert fk.LAUNCHES["voxel_counts"] == before


@pytest.mark.parametrize("n_clouds,rows,n_scales", [
    (2, 32768, 5), (32, 32768, 5), (128, 32768, 5), (901, 32768, 5), (901, 24576, 5),
    (7, 90112, 3), (3, 245760, 5), (2, 4_000_000, 8), (1, 1, 1)])
def test_voxel_chunks_bound_the_scratch(n_clouds, rows, n_scales):
    """Chunks cover the clouds in order, differ in size by at most one, hold
    at most MAX_VOXEL_CLOUDS and keep their tables within the scratch budget,
    unless one cloud's tables alone exceed it; each table is at most half
    full."""
    chunks = fk.voxel_chunks(n_clouds, rows, n_scales)
    assert [i for c in chunks for i in range(c.start, c.stop)] == list(range(n_clouds))
    sizes = [c.stop - c.start for c in chunks]
    assert max(sizes) - min(sizes) <= 1 and max(sizes) <= fk.MAX_VOXEL_CLOUDS
    slots = 1 << fk.voxel_slots_log2(rows)
    assert slots >= 2 * rows and slots < 4 * rows or slots == 2
    table_bytes = max(sizes) * n_scales * slots * 8
    assert table_bytes <= fk.VOXEL_SCRATCH_BYTES or max(sizes) == 1
    most = min(fk.MAX_VOXEL_CLOUDS, fk.VOXEL_SCRATCH_BYTES // (n_scales * slots * 8))
    assert len(chunks) == -(-n_clouds // max(most, 1))      # no more launches than needed


def test_plan_caps_host_route_on_cpu_clouds():
    """CPU clouds, and a LazyClouds on the CPU, take the host route: the
    span says so, no blocking read is recorded, and the caps are the
    worst native count plus the margin, rounded up to the bucket."""
    rng = np.random.default_rng(1)
    clouds = _scans(rng, (3000, 2200, 4000), 4096)
    want = _expected(clouds, SCALES).max(axis=0)
    trace.reset()
    trace.enable()
    try:
        caps = cloud.plan_scale_caps(clouds, SCALES, bucket=256, margin=16)
        lazy_caps = cloud.plan_scale_caps(cloud.LazyClouds(clouds, device="cpu"), SCALES,
                                          bucket=256, margin=16)
    finally:
        trace.disable()
    snap = trace.snapshot()
    assert caps == lazy_caps == tuple(min(-(-(int(w) + 16) // 256) * 256, 4096) for w in want)
    spans = [s for s in snap.spans if s[0] == "data.plan_caps"]
    assert [s[5] for s in spans] == [{"route": "host", "clouds": 3}] * 2
    assert not any(s[0] == "sync" for s in snap.spans)
    assert snap.counters["launches.voxel_counts"] == 0


@pytest.mark.parametrize("budget_clouds", [1, 2, 64])
def test_lazy_card_route_uploads_valid_rows(monkeypatch, budget_clouds):
    """The LazyClouds route of ``_card_counts`` gives every cloud's valid
    rows (a prefix, rows with holes, none at all) to the count, chunk by
    chunk through one reused buffer, one call a chunk, and leaves the LRU
    empty; its table equals the host route's."""
    rng = np.random.default_rng(2)
    host = _scans(rng, (1500, 2048, 700, 1), 2048)
    host.insert(2, _with_holes(host[0], rng))
    host.append(cloud.Cloud(points=torch.full((2048, 3), cloud.PAD_COORD),
                            mask=torch.zeros(2048, dtype=torch.bool)))
    calls = []
    monkeypatch.setattr(fk, "voxel_counts", _fake_voxel_counts(calls))
    per_cloud = len(SCALES) * 8 << fk.voxel_slots_log2(2048)
    monkeypatch.setattr(fk, "VOXEL_SCRATCH_BYTES", budget_clouds * per_cloud)
    lazy = cloud.LazyClouds(host, device="cpu")
    got = cloud._card_counts(lazy, SCALES)
    np.testing.assert_array_equal(got, _expected(host, SCALES))
    np.testing.assert_array_equal(got, cloud._host_counts(host, SCALES))
    assert calls == [c.stop - c.start for c in fk.voxel_chunks(len(host), 2048, len(SCALES))]
    assert len(calls) == -(-len(host) // min(budget_clouds, fk.MAX_VOXEL_CLOUDS))
    assert not lazy._cache and not lazy._order


def test_card_route_reads_one_table(monkeypatch):
    """The list route of ``_card_counts`` hands every cloud's points and
    mask to one wrapper call and reads its (clouds, scales) table in one
    ``sync`` span at site ``plan_caps``."""
    rng = np.random.default_rng(3)
    clouds = _scans(rng, (900, 1024), 1024)
    seen = []

    def count(points, masks, scales):
        seen.append((len(points), len(masks)))
        return torch.tensor([[native.count_voxels(p[m].numpy(), v) for v in scales]
                             for p, m in zip(points, masks)], dtype=torch.int64)

    monkeypatch.setattr(fk, "voxel_counts", count)
    trace.reset()
    trace.enable()
    try:
        got = cloud._card_counts(clouds, SCALES)
    finally:
        trace.disable()
    np.testing.assert_array_equal(got, _expected(clouds, SCALES))
    assert seen == [(2, 2)]
    assert [s[5] for s in trace.snapshot().spans if s[0] == "sync"] == [{"site": "plan_caps"}]
