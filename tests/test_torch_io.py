"""The port's host data plane against pcr_tpu's: PCD files (utils/pcd), the
native C++ reader (pcr_tpu_torch.native, the port's own copy of
pcd_io.cc), the dataset loaders, LazyClouds, the planners on host clouds,
the reference-fixture helpers of utils/poses_io, and Cloud.colors.

Inputs are made from a numpy seed and written with write_pcd into tmp_path,
under a reference root that both packages' REFERENCE_ROOT point to.

Tolerances: none.  Every comparison is bit for bit (array_equal / bytes),
because both sides run the same parsers on the same bytes (the native
library is the same source; the Python parser is the same code) and a
loader only pads and copies float32 rows.

The native cases check for both libraries when they run, not when the file
is imported.  pcr_tpu builds its library into one fixed temporary path and
caches a failed load for the life of the process, so when several pytest
workers import the test files of a fresh checkout at once, all but one of
them lose that build and would skip every native case.  No test runs before
every worker has finished collecting, so by then the winner's library is on
disk and a second load only reads it (``_native_libraries``).
"""

import fcntl
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from pcr_tpu import native as j_native
from pcr_tpu.utils import cloud as j_cloud
from pcr_tpu.utils import pcd as j_pcd
from pcr_tpu.utils import poses_io as j_poses
from pcr_tpu_torch import native as t_native
from pcr_tpu_torch.utils import cloud as t_cloud
from pcr_tpu_torch.utils import pcd as t_pcd
from pcr_tpu_torch.utils import poses_io as t_poses

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAP = 1024
SIZES = (700, 1000, 512, 900)



def _native_libraries() -> None:
    """Skip when g++ is missing (the port's library cannot be built); else
    make sure pcr_tpu's library is loaded in this process too, retrying a
    load that an earlier, concurrent build made fail.  The retry holds a
    lock file, so a build it starts runs in one process at a time."""
    if not t_native.available():
        pytest.skip("g++ unavailable: no native reader to compare")
    if not j_native.available():
        with open(os.path.join(tempfile.gettempdir(), "pcr_tpu_native_build.lock"), "w") as fh:
            fcntl.flock(fh, fcntl.LOCK_EX)
            j_native._lib_failed = False
            j_native.load_library()
    assert j_native.available(), "pcr_tpu's native library did not load"


@pytest.fixture
def native_libraries():
    _native_libraries()


needs_native = pytest.mark.usefixtures("native_libraries")


def _scan(rng, n):
    pts = (rng.normal(size=(n, 3)) * [8.0, 8.0, 1.5]).astype(np.float32)
    cols = rng.uniform(size=(n, 3)).astype(np.float32)
    return pts, cols


@pytest.fixture
def dataset(tmp_path, monkeypatch):
    """A 4-scan 'Facade' circuit as binary PCD files (scans 0 and 2 with
    rgb) under a temporary reference root; both packages point at it."""
    rng = np.random.default_rng(0)
    d = tmp_path / "nuvens" / "nuvens_pre_processadas" / "Facade"
    d.mkdir(parents=True)
    scans = []
    for i, n in enumerate(SIZES):
        pts, cols = _scan(rng, n)
        cols = cols if i % 2 == 0 else None
        t_pcd.write_pcd(str(d / f"s{i}.pcd"), pts, cols)
        scans.append((pts, cols))
    for mod in (t_poses, j_poses):
        monkeypatch.setattr(mod, "REFERENCE_ROOT", str(tmp_path))
        monkeypatch.setitem(mod.CIRCUIT_SIZES, "Facade", len(SIZES))
    for mod in (t_cloud, j_cloud):
        monkeypatch.setitem(mod.BUCKETS, "Facade", CAP)
    return scans


def _equal_cloud(t, j, fields=("points", "mask", "colors")):
    for k in fields:
        a, b = getattr(t, k), getattr(j, k)
        assert (a is None) == (b is None), k
        if a is not None:
            np.testing.assert_array_equal(a.cpu().numpy(), np.asarray(b), err_msg=k)


@pytest.mark.parametrize("binary", [True, False], ids=["binary", "ascii"])
@pytest.mark.parametrize("rgb", [True, False], ids=["rgb", "xyz"])
def test_pcd_files_match_pcr_tpu(tmp_path, binary, rgb):
    pts, cols = _scan(np.random.default_rng(1), 300)
    cols = cols if rgb else None
    t_pcd.write_pcd(tmp_path / "t.pcd", pts, cols, binary=binary)
    j_pcd.write_pcd(tmp_path / "j.pcd", pts, cols, binary=binary)
    assert (tmp_path / "t.pcd").read_bytes() == (tmp_path / "j.pcd").read_bytes()
    got, want = t_pcd.read_pcd(tmp_path / "t.pcd"), j_pcd.read_pcd(tmp_path / "t.pcd")
    np.testing.assert_array_equal(got.points, want.points)
    assert (got.colors is None) == (want.colors is None)
    if got.colors is not None:
        np.testing.assert_array_equal(got.colors, want.colors)
    if binary:
        np.testing.assert_array_equal(got.points, pts)


@needs_native
@pytest.mark.parametrize("binary", [True, False], ids=["binary", "ascii"])
@pytest.mark.parametrize("rgb", [True, False], ids=["rgb", "xyz"])
def test_native_reader_matches_pcr_tpu_and_the_python_parser(tmp_path, binary, rgb):
    pts, cols = _scan(np.random.default_rng(2), 500)
    path = str(tmp_path / "s.pcd")
    t_pcd.write_pcd(path, pts, cols if rgb else None, binary=binary)
    ref = t_pcd.read_pcd(path)
    got = t_native.read_pcd_padded(path, CAP, t_cloud.PAD_COORD)
    want = j_native.read_pcd_padded(path, CAP, j_cloud.PAD_COORD)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_array_equal(g, w)
    p, m, c, n = got
    assert n == 500 and m[:n].all() and not m[n:].any()
    np.testing.assert_array_equal(p[:n], ref.points)
    assert (p[n:] == t_cloud.PAD_COORD).all()
    if ref.colors is None:
        assert c is None
    else:
        np.testing.assert_array_equal(c[:n], ref.colors)
        assert (c[n:] == 0).all()


@needs_native
def test_native_batch_matches_single_and_pcr_tpu(dataset):
    paths = [t_poses.reference_cloud_path("Facade", i) for i in range(len(SIZES))]
    got = t_native.read_pcd_batch_padded(paths, CAP, t_cloud.PAD_COORD, n_threads=3)
    want = j_native.read_pcd_batch_padded(paths, CAP, j_cloud.PAD_COORD, n_threads=3)
    for g, w in zip(got[:2] + got[3:], want[:2] + want[3:]):
        np.testing.assert_array_equal(g, w)
    # colors: pcr_tpu leaves the rows of the scans without rgb (1 and 3)
    # uninitialised in a mixed batch; the port zeroes them
    np.testing.assert_array_equal(got[2][::2], want[2][::2])
    assert (got[2][1::2] == 0).all()
    pts, mask, cols, counts = got
    assert counts.tolist() == list(SIZES)
    for b, path in enumerate(paths):
        p, m, c, n = t_native.read_pcd_padded(path, CAP, t_cloud.PAD_COORD)
        np.testing.assert_array_equal(pts[b], p)
        np.testing.assert_array_equal(mask[b], m)
        np.testing.assert_array_equal(cols[b], c if c is not None else np.zeros_like(cols[b]))


def test_capacity_error_matches_pcr_tpu(dataset):
    """A scan above the capacity: the native reader reports it, and the
    loaders raise ValueError in both packages."""
    path = t_poses.reference_cloud_path("Facade", 1)              # 1000 points
    if t_native.available():
        with pytest.raises(RuntimeError, match=r"\(-5\)"):
            t_native.read_pcd_padded(path, 512, t_cloud.PAD_COORD)
    for load in (lambda: t_cloud.load_cloud(path, capacity=512, device="cpu"),
                 lambda: j_cloud.load_cloud(path, capacity=512),
                 lambda: t_cloud.load_dataset("Facade", [1], capacity=512, device="cpu"),
                 lambda: j_cloud.load_dataset("Facade", [1], capacity=512)):
        with pytest.raises(ValueError):
            load()


@needs_native
@pytest.mark.parametrize("voxel", [0.05, 0.5, 2.0])
def test_count_voxels_matches_numpy_and_pcr_tpu(voxel):
    pts, _ = _scan(np.random.default_rng(3), 4000)
    ijk = np.floor((pts - pts.min(axis=0)) / np.float32(voxel)).astype(np.int64)
    key = (ijk[:, 0] << 42) + (ijk[:, 1] << 21) + ijk[:, 2]
    want = int(np.unique(key).size)
    assert t_native.count_voxels(pts, voxel) == want == j_native.count_voxels(pts, voxel)


@pytest.mark.parametrize("capacity", [CAP, None], ids=["padded", "round_up"])
def test_load_cloud_matches_pcr_tpu(dataset, capacity):
    for i in (0, 1):
        path = t_poses.reference_cloud_path("Facade", i)
        got = t_cloud.load_cloud(path, capacity=capacity, device="cpu")
        want = j_cloud.load_cloud(path, capacity=capacity)
        _equal_cloud(got, want)
        assert got.points.dtype == torch.float32 and got.mask.dtype == torch.bool


@pytest.fixture(params=["native", "python"])
def reader(request, monkeypatch):
    """Both loaders' paths: the native batch reader, and the Python parser
    (native.available() False in both packages, as without g++)."""
    if request.param == "native":
        _native_libraries()
    if request.param == "python":
        monkeypatch.setattr(t_native, "available", lambda: False)
        monkeypatch.setattr(j_native, "available", lambda: False)
    return request.param


def test_load_dataset_matches_pcr_tpu(dataset, reader):
    idx = [2, 0, 3]
    eager = t_cloud.load_dataset("Facade", idx, device="cpu")
    host = t_cloud.load_dataset_host("Facade", idx, device="cpu")
    for got, want in ((eager, j_cloud.load_dataset("Facade", idx)),
                      (host, j_cloud.load_dataset_host("Facade", idx))):
        assert len(got) == len(want) == 3
        for g, w, i in zip(got, want, idx):
            if i % 2 == 0:                     # the scans with rgb
                _equal_cloud(g, w)
            else:
                # the scans without: pcr_tpu's native batch leaves their
                # colors uninitialised; the port zeroes them
                _equal_cloud(g, w, ("points", "mask"))
                assert g.colors is None or not g.colors.any()
    for h, i in zip(host, idx):
        assert h.points.device.type == "cpu" and not h.points.is_pinned()  # target is the CPU
        assert int(h.mask.sum()) == SIZES[i]


def test_missing_scan_lists_available_indices(dataset):
    os.remove(t_poses.reference_cloud_path("Facade", 1))
    assert t_cloud.available_indices("Facade") == j_cloud.available_indices("Facade") == [0, 2, 3]
    for load in (lambda: t_cloud.load_dataset("Facade", device="cpu"),
                 lambda: t_cloud.load_dataset_host("Facade", [1], device="cpu"),
                 lambda: t_cloud.load_dataset_lazy("Facade", [0, 1], device="cpu")):
        with pytest.raises(FileNotFoundError, match=r"available indices: \[0, 2, 3\]"):
            load()
    with pytest.raises(FileNotFoundError) as j_err:
        j_cloud.load_dataset("Facade")
    with pytest.raises(FileNotFoundError) as t_err:
        t_cloud.load_dataset("Facade", device="cpu")
    assert str(t_err.value) == str(j_err.value)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_loaders_default_to_the_card(dataset):
    """Without a card the loaders raise unless the caller asks for the CPU."""
    path = t_poses.reference_cloud_path("Facade", 0)
    for load in (lambda: t_cloud.load_cloud(path, CAP),
                 lambda: t_cloud.load_dataset("Facade", [0]),
                 lambda: t_cloud.load_dataset_host("Facade", [0]),
                 lambda: t_cloud.load_dataset_lazy("Facade", [0]),
                 lambda: t_cloud.LazyClouds([])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            load()


def test_lazy_clouds_streaming(dataset):
    """Twin of tests/test_io.py::test_lazy_clouds_streaming: iteration yields
    host clouds, indexing device clouds (here the CPU) with LRU eviction at
    keep=2, and every uploaded cloud equals the eager loader's, tensor for
    tensor (the prefix upload re-pads exactly as the loaders pad)."""
    lz = t_cloud.load_dataset_lazy("Facade", indices=[0, 1, 2], keep=2, device="cpu")
    eager = t_cloud.load_dataset("Facade", indices=[0, 1, 2], device="cpu")
    assert len(lz) == 3
    for h, e in zip(lz, eager):
        assert isinstance(h.points, torch.Tensor) and h.points.device.type == "cpu"
        _equal_cloud(h, e)
    d0 = lz[0]
    _ = lz[1]
    _ = lz[2]                       # evicts 0 (keep=2)
    assert 0 not in lz._cache and {1, 2} <= set(lz._cache)
    assert lz[0] is not d0          # re-upload
    assert 1 not in lz._cache       # ... which evicted the least recent
    for i in (0, 2):
        _equal_cloud(lz[i], eager[i])
        assert lz.host(i) is list(lz)[i]
    assert t_cloud.LazyClouds([], keep=0, device="cpu")._keep == 2


def test_lazy_clouds_non_prefix_mask_falls_back():
    """Twin of tests/test_io.py::test_lazy_clouds_non_prefix_mask_falls_back:
    interior mask holes take the full upload; a prefix mask takes the
    prefix upload and re-pads to the same tensors."""
    pts = np.arange(30, dtype=np.float32).reshape(10, 3)
    mask = np.ones(10, bool)
    mask[[2, 5]] = False
    holey = t_cloud.Cloud(points=torch.from_numpy(pts), mask=torch.from_numpy(mask))
    dev = t_cloud.LazyClouds([holey], keep=2, device="cpu")[0]
    np.testing.assert_array_equal(dev.points.numpy(), pts)
    np.testing.assert_array_equal(dev.mask.numpy(), mask)
    cap, nv = 4096, 100
    big = np.full((cap, 3), t_cloud.PAD_COORD, np.float32)
    big[:nv] = np.arange(3 * nv, dtype=np.float32).reshape(nv, 3)
    cols = np.zeros((cap, 3), np.float32)
    cols[:nv] = 0.5
    pref = t_cloud.Cloud(points=torch.from_numpy(big), mask=torch.arange(cap) < nv,
                         colors=torch.from_numpy(cols))
    dev2 = t_cloud.LazyClouds([pref], keep=2, device="cpu")[0]
    np.testing.assert_array_equal(dev2.mask.numpy(), np.arange(cap) < nv)
    np.testing.assert_array_equal(dev2.points.numpy(), big)
    np.testing.assert_array_equal(dev2.colors.numpy(), cols)
    # pcr_tpu's prefix upload of the same host cloud
    j_dev = j_cloud._upload_prefix(j_cloud.Cloud(points=big, mask=np.arange(cap) < nv,
                                                 colors=cols))
    _equal_cloud(dev2, j_dev)


def test_planners_on_host_clouds_match_pcr_tpu(dataset, reader):
    """bucket_capacity and plan_scale_caps read host clouds (LazyClouds
    iteration) as pcr_tpu's do, and give its numbers."""
    idx = list(range(len(SIZES)))
    lz = t_cloud.load_dataset_lazy("Facade", idx, keep=2, device="cpu")
    j_host = j_cloud.load_dataset_host("Facade", idx)
    for gran in (256, 4096):
        assert ([t_cloud.bucket_capacity(h, gran) for h in lz]
                == [j_cloud.bucket_capacity(h, gran) for h in j_host])
    scales = [2.0, 1.0, 0.5, 0.1]
    caps = t_cloud.plan_scale_caps(lz, scales, bucket=128, margin=16)
    assert caps == j_cloud.plan_scale_caps(j_host, scales, bucket=128, margin=16)
    assert not lz._cache                       # the planners uploaded nothing
    assert caps == t_cloud.plan_scale_caps(t_cloud.load_dataset("Facade", idx, device="cpu"),
                                           scales, bucket=128, margin=16)


def test_reference_helpers_match_pcr_tpu(tmp_path, monkeypatch):
    rng = np.random.default_rng(4)
    n = 5
    rel = np.tile(np.eye(4), (n, 1, 1))
    rel[:, :3, 3] = rng.normal(size=(n, 3))
    for mod in (t_poses, j_poses):
        monkeypatch.setattr(mod, "REFERENCE_ROOT", str(tmp_path))
        monkeypatch.setitem(mod.CIRCUIT_SIZES, "Facade", n)
    for stage in ("FGR", "FGR_GICP"):
        t_poses.save_relative_circuit(t_poses.reference_fixture_dir(stage, "Facade"),
                                      rel * (2 if stage == "FGR" else 1))
    t_poses.save_absolute_poses(t_poses.reference_fixture_dir("absolute_FGR_GICP", "Facade"), rel)
    for stage in ("FGR", "FGR_GICP", "absolute_FGR_GICP"):
        assert (t_poses.reference_fixture_dir(stage, "Facade")
                == j_poses.reference_fixture_dir(stage, "Facade"))
        assert t_poses.reference_fixture_dir(stage, "Facade").startswith(str(tmp_path))
    for stage in ("FGR", "FGR_GICP"):
        np.testing.assert_array_equal(t_poses.load_reference_relative(stage, "Facade"),
                                      j_poses.load_reference_relative(stage, "Facade"))
    np.testing.assert_array_equal(t_poses.load_reference_absolute("Facade"),
                                  j_poses.load_reference_absolute("Facade"))
    np.testing.assert_allclose(t_poses.load_reference_absolute("Facade"), rel, atol=1e-9)
    assert t_poses.reference_cloud_path("NCLT", 7) == j_poses.reference_cloud_path("NCLT", 7)
    assert t_poses.reference_cloud_path("NCLT", 7).endswith(
        os.path.join("nuvens", "nuvens_pre_processadas", "NCLT", "s7.pcd"))


def test_cloud_colors_match_pcr_tpu():
    """Cloud.colors through from_numpy, compact, pad_to, stack_clouds and
    Cloud[b]; with_ and masked_points."""
    rng = np.random.default_rng(5)
    pts, cols = _scan(rng, 300)
    t = t_cloud.from_numpy(pts, 512, colors=cols, device="cpu")
    j = j_cloud.from_numpy(pts, 512, colors=cols)
    _equal_cloud(t, j)
    _equal_cloud(t_cloud.compact(t, 256), j_cloud.compact(j, 256))
    _equal_cloud(t_cloud.pad_to(t, 768), j_cloud.pad_to(j, 768))
    ts = t_cloud.stack_clouds([t, t_cloud.pad_to(t_cloud.compact(t, 256), 512)])
    js = j_cloud.stack_clouds([j, j_cloud.pad_to(j_cloud.compact(j, 256), 512)])
    _equal_cloud(ts, js)
    _equal_cloud(ts[1], j_cloud.pad_to(j_cloud.compact(j, 256), 512))
    np.testing.assert_array_equal(t.masked_points().numpy(), np.asarray(j.masked_points()))
    w = t.with_(colors=None)
    assert w.colors is None and w.points is t.points and t.colors is not None
    assert t_cloud.from_numpy(pts, 512, device="cpu").colors is None


def test_native_builds_beside_the_kernels(monkeypatch):
    """The library lives under build/pcr_tpu_torch/native/<hash>/, not next
    to its source; PCR_DISABLE_NATIVE=1 turns it off."""
    path = t_native.library_path()
    assert path.parent.parent == t_native.BUILD_ROOT
    assert str(path).startswith(os.path.join(ROOT, "build", "pcr_tpu_torch", "native"))
    assert not list(t_native.SRC.parent.glob("*.so"))
    monkeypatch.setattr(t_native, "_lib", None)
    monkeypatch.setattr(t_native, "_lib_failed", False)
    monkeypatch.setenv("PCR_DISABLE_NATIVE", "1")
    assert not t_native.available()


def test_entry_points_import_neither_jax_nor_pcr_tpu():
    code = ("import sys, pcr_tpu_torch.__main__, pcr_tpu_torch.viz, pcr_tpu_torch.native, "
            "pcr_tpu_torch.pipeline; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'pcr_tpu')); "
            "assert not bad, bad")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
