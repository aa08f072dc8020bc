"""Kernels K1-K13 on the card against their plain PyTorch
versions on the same CUDA tensors.  Marked ``cuda``: each test skips without a GPU.  This
file imports neither jax nor pcr_tpu, so it also runs where JAX is absent:

    python -m pytest tests/test_torch_kernels_cuda.py -q --noconftest
"""

import numpy as np
import pytest
import torch

import chip_smoke
from pcr_tpu_torch.models import fgr, gicp, multiscale
from pcr_tpu_torch.models.global_refine import pose_graph
from pcr_tpu_torch.ops import band_nn, knn, preprocess
from pcr_tpu_torch.ops.kernels import (common, feature_kernels, gicp_kernels, graph_kernels,
                                       loop_kernels, nn_kernels)
from pcr_tpu_torch.utils import cloud, se3, trace
from pcr_tpu_torch.utils.cloud import pad_rows


@pytest.fixture
def cuda_rng():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return np.random.default_rng(0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["uniform", "lattice"])
@pytest.mark.parametrize("band,q_tile", [(1024, 1024), (2048, 1024), (256, 128), (4096, 1024),
                                         (512, 64)])
def test_nn1_band_kernel_matches_plain(cuda_rng, band, q_tile, kind):
    """Bit-equal distances (the same rounded formula) and equal rows (both
    keep the first minimum; ``lattice`` puts refs and queries on 0.5 m and
    0.25 m lattices with duplicated refs, so exact ties are everywhere); the
    wrapper counts its launch."""
    dev = torch.device("cuda")
    if kind == "lattice":
        r_np = cuda_rng.integers(-40, 40, size=(8192, 3)).astype(np.float32) * 0.5
        r_np[4096:4296] = r_np[:200]
        q_np = cuda_rng.integers(-80, 80, size=(8192, 3)).astype(np.float32) * 0.25
    else:
        r_np = cuda_rng.uniform(-20, 20, size=(8192, 3)).astype(np.float32)
        q_np = cuda_rng.uniform(-20, 20, size=(8192, 3)).astype(np.float32)
    r, q = torch.as_tensor(r_np, device=dev), torch.as_tensor(q_np, device=dev)
    rs = r[torch.argsort(r[:, 0], stable=True)]
    rs = torch.cat([rs, torch.full((2 * band, 3), 1e6, device=dev)]).contiguous()
    qs = q[torch.argsort(q[:, 0], stable=True)].contiguous()
    max_start = (rs.shape[0] - 2 * band) // band
    starts = (torch.arange(8192 // q_tile, device=dev) * q_tile // band).clamp(max=max_start)
    starts = (starts * band).to(torch.int32)
    before = nn_kernels.LAUNCHES["nn1_band"]
    d_k, i_k = nn_kernels.nn1_band(starts, qs, rs, q_tile=q_tile, band=band)
    torch.cuda.synchronize()
    assert nn_kernels.LAUNCHES["nn1_band"] == before + 1
    d_p, i_p = nn_kernels.nn1_band_reference(starts, qs, rs, q_tile=q_tile, band=band)
    assert torch.equal(d_k, d_p) and torch.equal(i_k, i_p)


def _preprocess_cloud(rng, kind: str):
    """(points (8000, 3), spacing hint): a wavy 20 m patch; ``sparse``
    spreads 6000 of the points over 160 m with a 0.02 m hint, so that most
    rows lack 31 slab neighbours within 100 * hint (found false) while the
    dense 2000 have them; ``duplicated`` repeats 2000 rows exactly (d2 ties,
    d2 = 0 between distinct rows)."""
    pts = rng.uniform(-10, 10, size=(8000, 3)).astype(np.float32)
    pts[:, 2] = 0.3 * np.sin(pts[:, 0])
    if kind == "sparse":
        pts[2000:] *= 8.0
        return pts, 0.02
    if kind == "duplicated":
        pts[4000:6000] = pts[:2000]
    return pts, 0.1


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["surface", "sparse", "duplicated"])
@pytest.mark.parametrize("q_tile", [1024, 256])
@pytest.mark.parametrize("band", [256, 512, 1024])
def test_preprocess_kernels_match_plain(cuda_rng, band, q_tile, kind):
    """K2 and K3: the d2 formula and the bisection thresholds are the same,
    so found, tau and the neighbour counts are equal; sums differ only in
    order (f32, 1e-5 relative).  Each wrapper counts one launch a call."""
    dev = torch.device("cuda")
    pts, hint = _preprocess_cloud(cuda_rng, kind)
    c = cloud.from_numpy(pts, 8192, device=dev)
    _, ms, p_q, p_r, starts = preprocess.sort_and_tile(c.points, c.mask, q_tile, band)
    before = dict(feature_kernels.LAUNCHES)
    mean_k, found_k, tau_k = feature_kernels.outlier_stats(starts, p_q, p_r, hint,
                                                           q_tile=q_tile, band=band)
    mean_p, found_p, tau_p = feature_kernels.outlier_stats_reference(
        starts, p_q, p_r, hint, q_tile=q_tile, band=band)
    assert torch.equal(found_k, found_p) and torch.equal(tau_k, tau_p)
    torch.testing.assert_close(mean_k, mean_p, rtol=1e-5, atol=1e-7)
    n_found = int(found_p[:8000].sum())
    assert 0 < n_found < 4000 if kind == "sparse" else n_found > 7000
    keep = ms & found_p[:8192]
    keep_r = torch.cat([keep, torch.zeros(p_r.shape[0] - 8192, dtype=torch.bool, device=dev)])
    center = feature_kernels.slab_centroids(starts, p_r, band)
    args = (starts, p_q, p_r, keep_r, tau_p, center)
    S_k = feature_kernels.survivor_moments(*args, q_tile=q_tile, band=band)
    S_p = feature_kernels.survivor_moments_reference(*args, q_tile=q_tile, band=band)
    assert torch.equal(S_k[:, 9], S_p[:, 9])
    torch.testing.assert_close(S_k, S_p, rtol=1e-5, atol=1e-5)
    torch.cuda.synchronize()
    for name in ("outlier_stats", "survivor_moments"):
        assert feature_kernels.LAUNCHES[name] == before[name] + 1


@pytest.mark.cuda
def test_cuda_path_never_falls_back(cuda_rng):
    """On CUDA tensors the preprocess launches K2 and K3 (never their plain
    versions); malformed arguments raise instead of running elsewhere."""
    dev = torch.device("cuda")
    pts = cuda_rng.uniform(-5, 5, size=(3000, 3)).astype(np.float32)
    c = cloud.from_numpy(pts, 4096, device=dev)
    before = dict(feature_kernels.LAUNCHES)
    out = preprocess.preprocess_scale_fused(c, 0.2)
    torch.cuda.synchronize()
    assert out.points.is_cuda
    for name in ("outlier_stats", "survivor_moments"):
        assert feature_kernels.LAUNCHES[name] == before[name] + 1
    starts = torch.zeros(1, dtype=torch.int64, device=dev)
    with pytest.raises(TypeError):
        nn_kernels.nn1_band(starts, torch.zeros(256, 3, device=dev),
                            torch.zeros(512, 3, device=dev), q_tile=256, band=256)


def _feature_cloud(rng, n: int, kind: str):
    """(n - 100, 3) points of a bumpy surface at ~0.08 m spacing (0.1 m
    voxels).  ``sparse`` spreads three quarters of the points 12 times wider,
    so that they have fewer than 20 slab neighbours within 2 voxels and
    fewer than 201 within 10 (some none at all), and draws the other quarter
    together so that many of its rows have them; ``duplicated`` repeats a
    quarter of the rows exactly (d2 ties, d2 = 0 between distinct rows,
    which K5 and K6 leave out); ``crowded`` draws half of the points 20
    times closer, so that their slabs hold more rows within the bisections'
    top bounds (2 and 10 voxels) than a team of K4 or K5 can list, beside
    rows that it can."""
    side = float(np.sqrt(n) * 0.08)
    pts = rng.uniform(-side / 2, side / 2, size=(n - 100, 3)).astype(np.float32)
    quarter = (n - 100) // 4
    if kind == "sparse":
        pts[:quarter] *= 0.4
        pts[quarter:] *= 12.0
    if kind == "crowded":
        pts[:2 * quarter] *= 0.05
    pts[:, 2] = 0.4 * np.sin(pts[:, 0]) * np.cos(0.7 * pts[:, 1])
    if kind == "duplicated":
        pts[2 * quarter:3 * quarter] = pts[:quarter]
    return pts


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["surface", "sparse", "duplicated", "crowded"])
@pytest.mark.parametrize("n,band,q_tile", [(4096, 512, 512), (8192, 1024, 512),
                                            (2048, 256, 256), (24576, 2048, 512),
                                            (16384, 4096, 512)])
def test_feature_kernels_match_plain(cuda_rng, n, band, q_tile, kind):
    """K4-K6 on a bumpy 0.1 m-voxel surface (the fourth shape is the stage-1
    path's, the last one fgr_features_sorted's default band): K4's counts
    and K5's tau equal (same d2 formula, same bisection), K5's bins equal
    (the same rounded operations, integer counts), K4's and K6's sums equal
    up to their order (f32, 1e-5 and 2.4e-5 relative), and K6's sums bit for
    bit those of chip_smoke.fpfh_serial, in K6's own order.  Each wrapper
    counts its launch."""
    dev = torch.device("cuda")
    pts = _feature_cloud(cuda_rng, n, kind)
    c = cloud.from_numpy(pts, n, device=dev)
    _, ms, p_q, p_r, starts = preprocess.sort_and_tile(c.points, c.mask, q_tile, band)
    before = dict(feature_kernels.LAUNCHES)
    center = feature_kernels.slab_centroids(starts, p_r, band)
    k4 = (starts, p_q, p_r, center, 0.1)
    S_k = feature_kernels.moments(*k4, q_tile=q_tile, band=band)
    S_p = feature_kernels.moments_reference(*k4, q_tile=q_tile, band=band)
    assert torch.equal(S_k[:, 9], S_p[:, 9])
    torch.testing.assert_close(S_k, S_p, rtol=1e-5, atol=1e-5)
    full = int((S_p[:n - 100, 9] >= 20).sum())
    assert 0 < full < (n - 100) // 2 if kind == "sparse" else full > 0
    normals, _ = preprocess.normals_from_moments(S_p[:n], ms)
    k5 = (starts, p_q, pad_rows(normals, p_q.shape[0], 0.0).contiguous(), p_r,
          pad_rows(normals, p_r.shape[0], 0.0).contiguous(), 0.1)
    h_k, tau_k = feature_kernels.spfh(*k5, q_tile=q_tile, band=band)
    h_p, tau_p = feature_kernels.spfh_reference(*k5, q_tile=q_tile, band=band)
    assert torch.equal(tau_k, tau_p)
    assert torch.equal(h_k, h_p)
    k6 = (starts, p_q, p_r, tau_p, pad_rows(h_p[:n], p_r.shape[0], 0.0).contiguous())
    a_k = feature_kernels.fpfh(*k6, q_tile=q_tile, band=band)
    a_p = feature_kernels.fpfh_reference(*k6, q_tile=q_tile, band=band)
    assert bool(((a_k - a_p).abs() <= 2.4e-5 * a_p.abs() + 1e-7).all())
    assert torch.equal(a_k, chip_smoke.fpfh_serial(*k6, q_tile, band))
    torch.cuda.synchronize()
    for name in ("moments", "spfh", "fpfh"):
        assert feature_kernels.LAUNCHES[name] == before[name] + 1


@pytest.mark.cuda
def test_spfh_refuses_wrong_dtype(cuda_rng):
    """A CUDA tensor of the wrong type, or a slab too long for K4's and K5's
    candidate lists, raises instead of running elsewhere."""
    dev = torch.device("cuda")
    starts = torch.zeros(1, dtype=torch.int32, device=dev)
    q = torch.zeros(256, 3, dtype=torch.float64, device=dev)
    r = torch.zeros(512, 3, device=dev)
    with pytest.raises(TypeError):
        feature_kernels.spfh(starts, q, q, r, r, 0.1, q_tile=256, band=256)
    # a slab longer than the kernels' 16-bit candidate lists can name
    big = torch.zeros(1 << 17, 3, device=dev)
    q32 = torch.zeros(256, 3, device=dev)
    with pytest.raises(ValueError, match="can list"):
        feature_kernels.spfh(starts, q32, q32, big, big, 0.1, q_tile=256, band=1 << 16)
    with pytest.raises(ValueError, match="can list"):
        feature_kernels.moments(starts, q32, big, torch.zeros(1, 3, device=dev), 0.1,
                                q_tile=256, band=1 << 16)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["moments", "spfh", "fpfh"])
def test_feature_kernels_refuse_bands_beyond_shared_memory(cuda_rng, kernel):
    """A band whose slab and lists need more shared memory than a block of
    the card can have is refused by name, band and bytes before any launch
    (band 8192: a 256 KB slab against the H100's 227 KB)."""
    dev = torch.device("cuda")
    band, q_tile = 8192, 512
    starts = torch.zeros(1, dtype=torch.int32, device=dev)
    q = torch.zeros(q_tile, 3, device=dev)
    r = torch.zeros(2 * band, 3, device=dev)
    before = dict(feature_kernels.LAUNCHES)
    args = {"moments": lambda: feature_kernels.moments(
                starts, q, r, torch.zeros(1, 3, device=dev), 0.1, q_tile=q_tile, band=band),
            "spfh": lambda: feature_kernels.spfh(starts, q, q, r, r, 0.1, q_tile=q_tile,
                                                 band=band),
            "fpfh": lambda: feature_kernels.fpfh(
                starts, q, r, torch.zeros(q_tile, device=dev),
                torch.zeros(2 * band, feature_kernels.FEATURE_DIM, device=dev),
                q_tile=q_tile, band=band)}
    with pytest.raises(ValueError, match=rf"band {band}: kernel {kernel} needs \d+ bytes"):
        args[kernel]()
    assert feature_kernels.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("nq,nr", [(21504, 21504), (1000, 3001), (4097, 70001)])
def test_nn1_kernel_matches_plain(cuda_rng, nq, nr):
    """K7: bit-equal distances (the same rounded formula) and equal rows
    (both keep the first minimum: a block of refs is duplicated further on,
    so exact ties occur); sentinel rows never win; the wrapper counts its
    launch once, whatever number of ref splits it used."""
    dev = torch.device("cuda")
    r = cuda_rng.uniform(-30, 30, size=(nr, 3)).astype(np.float32)
    r[nr // 2:nr // 2 + 200] = r[:200]
    r[-50:] = 1e6
    q = cuda_rng.uniform(-31, 31, size=(nq, 3)).astype(np.float32)
    q[:100] = r[:100]
    r_t, q_t = torch.as_tensor(r, device=dev), torch.as_tensor(q, device=dev)
    before = nn_kernels.LAUNCHES["nn1"]
    d_k, i_k = nn_kernels.nn1(q_t, r_t)
    torch.cuda.synchronize()
    assert nn_kernels.LAUNCHES["nn1"] == before + 1
    d_p, i_p = nn_kernels.nn1_reference(q_t, r_t)
    assert torch.equal(d_k, d_p) and torch.equal(i_k, i_p)
    assert bool((i_k[:100] == torch.arange(100, device=dev, dtype=torch.int32)).all())
    assert bool((i_k < nr - 50).all())


@pytest.mark.cuda
@pytest.mark.parametrize("nq,nr", [(37, 5), (21, 16), (100, 517), (1000, 3001), (4099, 21504),
                                   (21504, 21504)])
def test_nn1_kernel_first_minimum_on_ties(cuda_rng, nq, nr):
    """K7 on inputs full of exact ties (chip_smoke.k7_tie_inputs: duplicated
    refs, lattice ties, equal nearest refs straddling a group boundary, the
    boundary of the ref ranges the wrapper splits into and the last row):
    d2 bit-equal and rows equal to the plain version, every boundary tie
    resolved to its first row; nr below a group, nq and nr off every
    multiple."""
    dev = torch.device("cuda")
    bounds = chip_smoke.k7_tie_bounds(nr, nn_kernels.nn1_splits(nq, nr, nn_kernels.nn1_slots(0)))
    q, r = (torch.as_tensor(x, device=dev)
            for x in chip_smoke.k7_tie_inputs(nq, nr, bounds, seed=nq + nr))
    d_k, i_k = nn_kernels.nn1(q, r)
    torch.cuda.synchronize()
    d_p, i_p = nn_kernels.nn1_reference(q, r)
    assert torch.equal(d_k, d_p) and torch.equal(i_k, i_p)
    ties = chip_smoke.tie_rows(nr, bounds)
    assert i_k[nq - len(ties):].tolist() == [b - 1 for b in ties]


@pytest.mark.cuda
def test_nn1_kernel_refuses_float64_and_serves_knn(cuda_rng):
    """A float64 or non-contiguous CUDA input raises instead of running
    elsewhere; ``knn.nn1`` on CUDA tensors launches K7."""
    dev = torch.device("cuda")
    with pytest.raises(TypeError):
        nn_kernels.nn1(torch.zeros(64, 3, dtype=torch.float64, device=dev),
                       torch.zeros(64, 3, device=dev))
    with pytest.raises(ValueError):
        nn_kernels.nn1(torch.zeros(3, 64, device=dev).T, torch.zeros(64, 3, device=dev))
    pts = torch.as_tensor(cuda_rng.uniform(-5, 5, size=(500, 3)).astype(np.float32), device=dev)
    mask = torch.ones(500, dtype=torch.bool, device=dev)
    mask[::7] = False
    before = nn_kernels.LAUNCHES["nn1"]
    d, i = knn.nn1(pts, pts, mask)
    torch.cuda.synchronize()
    assert nn_kernels.LAUNCHES["nn1"] == before + 1
    assert bool(mask[i].all()) and bool((d[mask] == 0).all())


def _gnc_case(rng, n: int, batch: int, kept: float, absolute: bool):
    """GNC inputs on the card: a cloud in normalised units (relative scale)
    or metres (absolute), its target under a known motion with small noise,
    a quarter of the kept correspondences outliers; the last pair of a batch
    of 3 or more keeps only 2 correspondences.  Returns (p, q, w, mu0,
    delta, enough)."""
    dev = torch.device("cuda")
    extent, noise, max_corr = (20.0, 0.01, 0.2) if absolute else (1.0, 5e-4, 0.01)
    p = rng.uniform(-extent, extent, size=(batch, n, 3)).astype(np.float32)
    a = rng.uniform(0.05, 0.3, batch)
    R = np.stack([[[np.cos(x), -np.sin(x), 0], [np.sin(x), np.cos(x), 0], [0, 0, 1]] for x in a])
    t = rng.uniform(-0.1 * extent, 0.1 * extent, (batch, 1, 3))
    q = (np.einsum("bij,bnj->bni", R, p) + t + rng.normal(0, noise, p.shape)).astype(np.float32)
    out = rng.random((batch, n)) < 0.25
    q[out] = rng.uniform(-extent, extent, (int(out.sum()), 3))
    w = (rng.random((batch, n)) < kept).astype(np.float32)
    if batch >= 3:
        w[-1] = 0.0
        w[-1, :2] = 1.0
    enough = w.sum(-1) >= 3
    mu0 = max_corr ** 2 * 1e4 if absolute else 1.0
    delta = np.full(batch, max_corr, np.float32)
    to = lambda x: torch.as_tensor(x, device=dev)   # noqa: E731
    return to(p), to(q), to(w), mu0, to(delta), to(enough)


GNC_CASES = {   # n rows, pairs, kept share, absolute scale, decrease mu
    "nclt_one_pair": (24576, 1, 0.15, False, True),
    "nclt_chunk": (24576, 2, 0.15, False, True),
    "every_row_kept": (24576, 2, 1.0, False, True),     # beyond shared memory: rows from L2
    "facade_chunk": (90112, 2, 0.1, True, True),
    "fixed_mu_with_a_two_row_pair": (1000, 3, 0.5, False, False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(GNC_CASES))
def test_gnc_kernel_matches_plain(cuda_rng, case):
    """K8 against its plain version: both converge to the same fixed point
    from the same start, sums in other orders, so the normalised poses
    agree within 1e-4 (the bound of the plain version against pcr_tpu); the
    kernel run twice is bit for bit the same; a pair with 2 correspondences
    stays the identity exactly; the wrapper counts its launch."""
    n, batch, kept, absolute, decrease_mu = GNC_CASES[case]
    args = (*_gnc_case(cuda_rng, n, batch, kept, absolute), 300, 1.4, decrease_mu)
    before = loop_kernels.LAUNCHES["gnc"]
    T_k = loop_kernels.gnc(*args)
    T_k2 = loop_kernels.gnc(*args)
    torch.cuda.synchronize()
    assert loop_kernels.LAUNCHES["gnc"] == before + 2
    assert torch.equal(T_k, T_k2)
    T_p = loop_kernels.gnc_reference(*args)
    assert torch.isfinite(T_k).all()
    torch.testing.assert_close(T_k, T_p, rtol=0, atol=1e-4)
    if batch >= 3:
        assert torch.equal(T_k[-1], torch.eye(4, device=T_k.device))
    one = loop_kernels.gnc(*(x[0] if torch.is_tensor(x) else x for x in args))
    torch.testing.assert_close(one, T_k[0], rtol=0, atol=1e-6)


def _tridiagonal(rng, m: int):
    A = rng.normal(size=(m, 6, 6)).astype(np.float32)
    D = (np.einsum("mij,mkj->mik", A, A) + 12 * np.eye(6)).astype(np.float32)
    U = (0.3 * rng.normal(size=(m - 1, 6, 6))).astype(np.float32)
    rhs = rng.normal(size=(m, 6)).astype(np.float32)
    return tuple(torch.as_tensor(x, device="cuda") for x in (D, U, rhs))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 2, 7, 900])
def test_block_thomas_kernel_matches_plain(cuda_rng, m):
    """K9 against its plain version on a well-conditioned system (diagonal
    blocks A A^T + 12 I): both eliminate with partial pivoting in float32,
    so x agrees within 1e-5 of its largest entry; the kernel run twice is
    bit for bit the same; the wrapper counts its launch."""
    D, U, rhs = _tridiagonal(cuda_rng, m)
    before = loop_kernels.LAUNCHES["block_thomas"]
    x_k = loop_kernels.block_thomas(D, U, rhs)
    x_k2 = loop_kernels.block_thomas(D, U, rhs)
    torch.cuda.synchronize()
    assert loop_kernels.LAUNCHES["block_thomas"] == before + 2
    assert torch.equal(x_k, x_k2)
    x_p = loop_kernels.block_thomas_reference(D, U, rhs)
    torch.testing.assert_close(x_k, x_p, rtol=0, atol=1e-5 * float(x_p.abs().max()))


@pytest.mark.cuda
def test_loop_kernels_never_fall_back(cuda_rng, monkeypatch):
    """With both plain versions made to raise, FGR's GNC and the pose
    graph's block-Thomas solve still run on CUDA tensors, through K8 and
    K9 (K9 twice an LM iteration); float64 inputs raise."""
    def refuse(*args, **kw):
        raise AssertionError("a plain loop ran on CUDA tensors")

    monkeypatch.setattr(loop_kernels, "gnc_reference", refuse)
    monkeypatch.setattr(loop_kernels, "block_thomas_reference", refuse)
    dev = torch.device("cuda")
    pts = cuda_rng.uniform(-5, 5, size=(2000, 3)).astype(np.float32)
    src = cloud.from_numpy(pts, 2048, device=dev)
    tgt = cloud.from_numpy(pts + np.float32([0.1, 0.0, 0.0]), 2048, device=dev)
    idx = torch.arange(2048, device=dev)
    before = dict(loop_kernels.LAUNCHES)
    T = fgr.fgr_from_correspondences(src, tgt, idx, idx, src.mask, fgr.FgrOptions())
    torch.cuda.synchronize()
    assert loop_kernels.LAUNCHES["gnc"] == before["gnc"] + 1
    assert abs(float(T[0, 3]) - 0.1) < 1e-3
    n = 8
    rel = np.tile(np.eye(4), (n, 1, 1))
    rel[:, 0, 3] = 0.5
    rel[-1, 0, 3] = -3.4                                  # the loop closes 10 cm short
    graph = pose_graph.build_circuit_graph(
        np.stack([np.eye(4) + np.pad([[0, 0, 0, 0.5 * k]], ((0, 3), (0, 0)))
                  for k in range(n)]), rel, np.tile(np.eye(6, dtype=np.float32), (n, 1, 1)),
        device=dev)
    before = loop_kernels.LAUNCHES["block_thomas"]
    res = pose_graph.optimize_pose_graph_once(graph, mu=1.0, max_iterations=5,
                                              solver="tridiag")
    assert loop_kernels.LAUNCHES["block_thomas"] == before + 2 * res.iterations_used
    assert torch.isfinite(res.nodes).all()
    D, U, rhs = _tridiagonal(cuda_rng, 4)
    with pytest.raises(TypeError):
        loop_kernels.block_thomas(D.double(), U, rhs)
    with pytest.raises(TypeError):
        loop_kernels.gnc(*(x.double() if torch.is_tensor(x) and x.is_floating_point() else x
                           for x in (*_gnc_case(cuda_rng, 64, 1, 0.5, False), 300, 1.4, True)))


def _fpfh_like(rng, n: int, masked: float):
    """n FPFH-like rows on the card: three 11-bin histograms of 100 each
    (nonnegative, features up to ~100 as stage 1's), a share masked."""
    dev = torch.device("cuda")
    f = np.concatenate([rng.dirichlet(np.full(11, 0.4), size=n) * 100 for _ in range(3)], axis=1)
    mask = rng.random(n) >= masked
    return (torch.as_tensor(f.astype(np.float32), device=dev), torch.as_tensor(mask, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("na,nb", [(37, 5), (300, 517), (2049, 130), (4099, 2000),
                                   (24576, 24576)])
def test_nn1_mutual_kernel_on_exact_ties(cuda_rng, na, nb):
    """K11 on chip_smoke.k11_tie_inputs (integer features: every d2 exact,
    ties everywhere, duplicated rows across the kernel's and the plain
    version's tile boundaries, masked runs, zero rows, unreachable
    columns): ij and ji equal to the plain version's."""
    chip_smoke.check_k11_ties(na, nb, torch.device("cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("na,nb", [(24576, 24576), (1000, 3001)])
def test_nn1_mutual_kernel_within_rounding(cuda_rng, na, nb):
    """K11 on FPFH-like features: one launch a call, two runs bit for bit,
    and every pick that differs from the plain version's within the
    expanded form's rounding (chip_smoke.mutual_rounding)."""
    a, am = _fpfh_like(cuda_rng, na, 0.1)
    b, bm = _fpfh_like(cuda_rng, nb, 0.1)
    before = nn_kernels.LAUNCHES["nn1_mutual"]
    ij, ji = nn_kernels.nn1_mutual(a, am, b, bm)
    ij2, ji2 = nn_kernels.nn1_mutual(a, am, b, bm)
    torch.cuda.synchronize()
    assert nn_kernels.LAUNCHES["nn1_mutual"] == before + 2
    assert torch.equal(ij, ij2) and torch.equal(ji, ji2)
    ij_p, ji_p = nn_kernels.nn1_mutual_reference(a, am, b, bm)
    rows, worst_r = chip_smoke.mutual_rounding(a, am, b, bm, ij, ij_p)
    cols, worst_c = chip_smoke.mutual_rounding(b, bm, a, am, ji, ji_p)
    assert worst_r <= 1.0 and worst_c <= 1.0, (rows, worst_r, cols, worst_c)
    assert rows < na // 100 and cols < nb // 100


def _edge_args(graph, l):
    return (graph.nodes, graph.edge_src, graph.edge_dst, graph.edge_T, graph.edge_info,
            l * graph.edge_mask.to(torch.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["nclt_901", "k2", "k4"])
def test_edge_blocks_kernel_matches_plain(cuda_rng, case):
    """K12 (chip_smoke.check_k12): the blocks within their bound of the plain
    version's, twice bit for bit; the bands (the NCLT circuit) or the dense
    system (k-graphs) of the kernel's blocks bit-equal to the CPU's
    index_add_ / index_put_ of the same blocks."""
    dev = torch.device("cuda")
    if case == "nclt_901":
        rel = np.load(chip_smoke.ROOT / "outputs" / "NCLT_poses.npz")["relative_FGR_GICP"]
        graph = chip_smoke.nclt_graph(rel, dev, np.diag([2e6, 2e6, 2e6, 2e4, 2e4, 2e4])
                                      .astype(np.float32))
    else:
        graph = chip_smoke.k_graph(16, int(case[1]), dev)
    l = torch.linspace(0.3, 1.0, graph.edge_src.shape[0], device=dev)
    chip_smoke.check_k12(case, _edge_args(graph, l), library=False)


@pytest.mark.cuda
def test_mutual_and_edge_kernels_never_fall_back(cuda_rng, monkeypatch):
    """With every plain version of K11 and K12 made to raise, FGR's
    matching and both pose-graph solvers still run on CUDA tensors, K11
    once a match, K12's two launches once an LM iteration; float64 inputs
    raise."""
    def refuse(*args, **kw):
        raise AssertionError("a plain version ran on CUDA tensors")

    for module, name in ((nn_kernels, "nn1_mutual_reference"),
                         (graph_kernels, "edge_blocks_reference"),
                         (graph_kernels, "assemble_band_reference"),
                         (graph_kernels, "assemble_dense_reference")):
        monkeypatch.setattr(module, name, refuse)
    dev = torch.device("cuda")
    a, am = _fpfh_like(cuda_rng, 500, 0.1)
    before = nn_kernels.LAUNCHES["nn1_mutual"]
    ci, cj, cm = fgr.match_features(a, am, a, am)
    torch.cuda.synchronize()
    assert nn_kernels.LAUNCHES["nn1_mutual"] == before + 1
    assert bool((cj[cm] == ci[cm]).all()) and int(cm.sum()) == int(am.sum())
    rel = np.load(chip_smoke.ROOT / "outputs" / "NCLT_poses.npz")["relative_FGR_GICP"][:12]
    for graph, solver in ((chip_smoke.nclt_graph(rel, dev, np.eye(6, dtype=np.float32)),
                           "tridiag"), (chip_smoke.k_graph(9, 2, dev), "dense")):
        before = dict(graph_kernels.LAUNCHES)
        res = pose_graph.optimize_pose_graph_once(graph, mu=1.0, max_iterations=4, solver=solver)
        torch.cuda.synchronize()
        for name in ("edge_blocks", "edge_assembly"):
            assert graph_kernels.LAUNCHES[name] == before[name] + res.iterations_used
        assert torch.isfinite(res.nodes).all()
    with pytest.raises(TypeError):
        nn_kernels.nn1_mutual(a.double(), am, a.double(), am)
    graph = chip_smoke.k_graph(5, 1, dev)
    args = _edge_args(graph, torch.ones(5, device=dev))
    with pytest.raises(TypeError):
        graph_kernels.edge_blocks(*(x.double() if x.is_floating_point() else x for x in args))


def _k10_move_case(rng, kind: str, q_tile: int, n: int):
    """gicp_move's arguments on the card: a wavy surface of n source rows
    moved against a target of 1.4 n rows; ``crowded`` searches 3 m on it
    (the in-radius band overflows, so some tiles take the centred slab),
    ``sparse_tail`` masks 80% of the source (tiles with no real row)."""
    dev = torch.device("cuda")

    def surface(m, extent):
        xy = rng.uniform(-extent, extent, size=(m, 2))
        z = 0.4 * np.sin(1.3 * xy[:, :1]) + 0.3 * np.cos(0.9 * xy[:, 1:2])
        return np.concatenate([xy, z], axis=1).astype(np.float32)

    cap = -(-n // q_tile) * q_tile
    src = cloud.from_numpy(surface(n, 5.0 * (n / 2500) ** 0.5), cap, device=dev)
    if kind == "sparse_tail":
        src.mask[:n] = torch.as_tensor(rng.random(n) >= 0.8, device=dev)
    m = int(1.4 * n)
    tgt = cloud.from_numpy(surface(m, 6.0 * (n / 2500) ** 0.5), -(-m // 1024) * 1024,
                           device=dev)
    T = se3.se3_exp(torch.tensor([0.0, 0.0, 0.02, 0.05, -0.03, 0.0], device=dev))
    band = gicp.iteration_band(tgt.capacity)
    index = band_nn.build_band_index(se3.transform_points(T, src.points), src.mask,
                                     tgt.points, tgt.mask, band=band)
    pts = src.points[index.q_order].contiguous()
    mask = src.mask[index.q_order].contiguous()
    return (T, pts, mask, index, 3.0 if kind == "crowded" else 0.5), dict(q_tile=q_tile,
                                                                          band=band)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["surface", "crowded", "sparse_tail"])
@pytest.mark.parametrize("q_tile,n", [(1024, 21504), (256, 2560), (64, 2560)])
def test_gicp_move_kernel_starts_bit_equal(cuda_rng, kind, q_tile, n):
    """K10's gicp_move: its starts, and those of the band sweep's slab_starts
    kernel (band_nn.slab_starts on the card), bit-equal to the rule's in
    PyTorch (nn_kernels.slab_starts_reference) on its own q_sp (the centred
    slab taken for some tiles where the in-radius band overflows,
    ``crowded``), its q_sp within chip_smoke.MAX_K10_Q of the plain
    version's; one launch a call."""
    args, kw = _k10_move_case(cuda_rng, kind, q_tile, n)
    _, _, _, index, max_dist = args
    before = dict(gicp_kernels.LAUNCHES, **nn_kernels.LAUNCHES)
    q_k, s_k = gicp_kernels.gicp_move(*args, **kw)
    s_only = band_nn.slab_starts(index, q_k, max_dist, q_tile, kw["band"])
    torch.cuda.synchronize()
    assert gicp_kernels.LAUNCHES["gicp_move"] == before["gicp_move"] + 1
    assert nn_kernels.LAUNCHES["slab_starts"] == before["slab_starts"] + 1
    s_rule = nn_kernels.slab_starts_reference(q_k, index.r_sorted, index.ra_sorted, index.axis,
                                              max_dist, **kw)
    assert torch.equal(s_k, s_rule) and torch.equal(s_only, s_rule)
    q_p, _ = gicp_kernels.gicp_move_reference(*args, **kw)
    assert float((q_k - q_p).abs().max()) <= chip_smoke.MAX_K10_Q
    mins = q_k[:, index.axis].view(-1, q_tile).amin(dim=1)
    top = max(index.r_sorted.shape[0] // kw["band"] - 2, 0)
    ours = torch.clamp(torch.searchsorted(index.ra_sorted, mins - max_dist) // kw["band"], 0,
                       top) * kw["band"]
    if kind == "crowded":
        assert bool((s_k != ours).any())


@pytest.fixture(scope="module")
def gicp_pairs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return {kind: chip_smoke.gicp_pair(kind, torch.device("cuda"))
            for kind in chip_smoke.GICP_PAIRS}


@pytest.mark.cuda
@pytest.mark.parametrize("loss", ["l2", "l1", "gm"])
@pytest.mark.parametrize("kind", chip_smoke.GICP_PAIRS)
@pytest.mark.parametrize("scale", [0, 4])
def test_gicp_rows_update_kernels_within_rounding(gicp_pairs, kind, loss, scale):
    """K10 on the first iteration of a pair's coarsest and finest band GICP
    (chip_smoke.check_k10): gicp_move's starts bit-equal to the rule's,
    gicp_rows' sums within summation rounding of the plain version's (the
    counts exactly), gicp_update's T within 1e-6 of the plain update, two
    runs bit for bit."""
    src, tgt, T0, _ = gicp_pairs[kind]
    dist = multiscale.max_correspondence_distances(multiscale.create_scales(5))[scale]
    chip_smoke.check_k10(f"{kind} scale {scale} {loss}",
                         chip_smoke.k10_inputs(src[scale], tgt[scale], dist, T0, loss=loss))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", chip_smoke.GICP_PAIRS)
def test_band_mgicp_kernels_against_plain_loop(gicp_pairs, kind):
    """A 5-scale band M-GICP through K10 lands within stage 2's limits (12 mm,
    120 mdeg) of the same loop on K10's plain versions, with equal
    iterations at every scale; two runs give the same bits; K10's update
    launches once an iteration (launches.gicp_update equals the counter
    gicp.iterations); an iteration launches at most 5 device operations
    (K10's three, K1, the flag's copy), counted by the profiler as the
    difference between 11 and 1 iterations of the finest scale."""
    src, tgt, T0, _ = gicp_pairs[kind]
    trace.reset()
    trace.enable()
    try:
        res = multiscale.multiscale_gicp_pyramids(src, tgt, T0, n_scales=5)
        torch.cuda.synchronize()
        snap = trace.snapshot()
    finally:
        trace.disable()
        trace.reset()
    res2 = multiscale.multiscale_gicp_pyramids(src, tgt, T0, n_scales=5)
    with chip_smoke.plain_loops():
        res_p = multiscale.multiscale_gicp_pyramids(src, tgt, T0, n_scales=5)
    its, its_p = res.scale_iterations.tolist(), res_p.scale_iterations.tolist()
    assert torch.equal(res.transformation, res2.transformation)
    assert res2.scale_iterations.tolist() == its
    assert snap.counters["launches.gicp_update"] == snap.counters["gicp.iterations"] == sum(its)
    assert snap.counters["launches.gicp_rows"] == snap.counters["launches.gicp_move"] == sum(its)
    e_m, e_deg = chip_smoke.pose_error(res.transformation.double().cpu().numpy(),
                                       res_p.transformation.double().cpu().numpy())
    assert e_m * 1e3 <= 12.0 and e_deg * 1e3 <= 120.0, (e_m, e_deg)
    assert its == its_p
    dist = multiscale.max_correspondence_distances(multiscale.create_scales(5))[4]
    per_iteration = chip_smoke.iteration_device_ops(src[4], tgt[4], dist, T0)
    assert per_iteration <= 5, per_iteration


@pytest.mark.cuda
def test_gicp_kernels_never_fall_back(cuda_rng, monkeypatch):
    """With K10's and the slab starts' plain versions made to raise, the
    band GICP still runs on CUDA tensors, one gicp_move, gicp_rows and
    gicp_update an iteration, its final metrics' slab starts through the
    band sweep's kernel; an unknown loss raises."""
    def refuse(*args, **kw):
        raise AssertionError("a plain version ran on CUDA tensors")

    for name in ("gicp_move_reference", "gicp_rows_reference", "gicp_update_reference"):
        monkeypatch.setattr(gicp_kernels, name, refuse)
    monkeypatch.setattr(nn_kernels, "slab_starts_reference", refuse)
    (T, pts, mask, index, _), _ = _k10_move_case(cuda_rng, "surface", 256, 2560)
    dev = torch.device("cuda")
    src = cloud.from_numpy(pts.cpu().numpy(), 2560, device=dev)
    tgt = cloud.from_numpy(pts.cpu().numpy() + np.float32([0.05, 0.0, 0.0]), 2560, device=dev)
    for c in (src, tgt):
        c.normals = torch.tensor([0.0, 0.0, 1.0], device=dev).expand(2560, 3).contiguous()
    before = dict(gicp_kernels.LAUNCHES, **nn_kernels.LAUNCHES)
    res = gicp.registration_gicp(src, tgt, 0.5, np.eye(4, dtype=np.float32), q_tile=256)
    torch.cuda.synchronize()
    its = int(res.iterations)
    for name in ("gicp_move", "gicp_rows", "gicp_update"):
        assert gicp_kernels.LAUNCHES[name] == before[name] + its
    assert nn_kernels.LAUNCHES["slab_starts"] == before["slab_starts"] + 1
    with pytest.raises(ValueError, match="unknown loss"):
        gicp.registration_gicp(src, tgt, 0.5, np.eye(4, dtype=np.float32), loss="huber")


def _knn_case(rng, kind: str, n: int):
    """(points (n, 3) f32, mask) on the card for K13: ``surface`` is a wavy
    60 m patch with a dense 4 m core and 10% of its rows masked here and
    there; ``bucket`` keeps the first 44,728 rows valid and parks the rest
    at PAD_COORD (a Facade scan in its 90112-row bucket); ``lattice`` puts
    the points on a 0.5 m lattice with every row repeated further on
    (exact d2 ties everywhere); ``few`` keeps 150 valid rows and ``none``
    none."""
    dev = torch.device("cuda")
    if kind == "lattice":
        x = rng.integers(-10, 10, size=(n - n // 3, 3)).astype(np.float32) * 0.5
        x = np.concatenate([x, x[::-1][:n // 3]])
    else:
        x = rng.uniform(-30, 30, size=(n, 3)).astype(np.float32)
        x[: n // 4] *= 0.0667
        x[:, 2] = 0.5 * np.sin(x[:, 0] / 3) + rng.normal(0, 0.01, n).astype(np.float32)
    mask = rng.random(n) >= 0.1
    if kind == "bucket":
        mask = np.arange(n) < 44728
        x[~mask] = cloud.PAD_COORD
    elif kind == "few":
        mask = np.zeros(n, bool)
        mask[rng.choice(n, size=150, replace=False)] = True
    elif kind == "none":
        mask = np.zeros(n, bool)
    return torch.as_tensor(x, device=dev), torch.as_tensor(mask, device=dev)


def _knn_float64(q, r, mask, k: int, exclude_self: bool, rows):
    """The float64 k smallest d2 of the query rows ``rows`` over the valid
    refs (the query's own row dropped), inf past them."""
    d = ((q[rows, None, :].double() - r[None, :, :].double()) ** 2).sum(-1)
    d = torch.where(mask[None, :], d, torch.inf)
    if exclude_self:
        d[torch.arange(len(rows), device=d.device), rows] = torch.inf
    return torch.sort(d, dim=1).values[:, :k]


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 20, 30, 200])
@pytest.mark.parametrize("kind,nq,nr,exclude_self", [("surface", 5000, 7001, False),
                                                     ("surface", 4099, 4099, True),
                                                     ("lattice", 3001, 3001, True),
                                                     ("few", 2000, 2000, True),
                                                     ("none", 300, 300, True),
                                                     ("surface", 50, 120, False)])
def test_knn_select_kernel_matches_plain(cuda_rng, kind, nq, nr, exclude_self, k):
    """K13 against its plain version: d2 bit-equal and indices equal (both
    keep each row's k smallest (d2, index) keys, d2 by the same rounded
    formula, so even exact ties at the k-th slot agree), two runs bit for
    bit, one launch a call; queries another cloud than the refs (nq != nr),
    nq off every multiple of the kernel's query block, exact ties
    everywhere, fewer valid refs than k, none, and fewer refs than k."""
    r, mask = _knn_case(cuda_rng, kind, nr)
    q = r if nq == nr else _knn_case(cuda_rng, kind, nq)[0]
    before = nn_kernels.LAUNCHES["knn_select"]
    d_k, i_k = nn_kernels.knn_select(q, r, mask, k, exclude_self=exclude_self)
    d_k2, i_k2 = nn_kernels.knn_select(q, r, mask, k, exclude_self=exclude_self)
    torch.cuda.synchronize()
    assert nn_kernels.LAUNCHES["knn_select"] == before + 2
    assert torch.equal(d_k, d_k2) and torch.equal(i_k, i_k2)
    d_p, i_p = nn_kernels.knn_select_reference(q, r, mask, k, exclude_self=exclude_self)
    assert torch.equal(d_k, d_p)
    assert torch.equal(i_k, i_p)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [20, 200])
def test_knn_select_kernel_at_the_facade_bucket(cuda_rng, k):
    """K13 at the selection features' shape, 90112 rows with 44,728 valid,
    exclude_self: equal to the plain version, and its d2 rows (sampled)
    within FP32 rounding of the float64 k smallest."""
    x, mask = _knn_case(cuda_rng, "bucket", 90112)
    d_k, i_k = nn_kernels.knn_select(x, x, mask, k, exclude_self=True)
    d_p, i_p = nn_kernels.knn_select_reference(x, x, mask, k, exclude_self=True)
    assert torch.equal(d_k, d_p) and torch.equal(i_k, i_p)
    rows = torch.arange(0, 90112, 331, device=x.device)
    d64 = _knn_float64(x, x, mask, k, True, rows)
    real = torch.isfinite(d64)
    assert torch.equal(real, d_k[rows] < common.BIG)
    assert torch.allclose(d_k[rows][real].double(), d64[real], rtol=1e-6, atol=1e-9)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 30, 200])
def test_knn_select_kernel_within_fp32_rounding_of_float64(cuda_rng, k):
    """K13's d2 rows equal the float64 k smallest within FP32 rounding (the
    formula's eight operations round once each), queries another cloud."""
    r, mask = _knn_case(cuda_rng, "surface", 6000)
    q = _knn_case(cuda_rng, "surface", 3000)[0]
    d_k, _ = nn_kernels.knn_select(q, r, mask, k)
    rows = torch.arange(3000, device=q.device)
    d64 = _knn_float64(q, r, mask, k, False, rows)
    assert torch.allclose(d_k.double(), d64, rtol=1e-6, atol=1e-9)


@pytest.mark.cuda
def test_knn_select_never_falls_back(cuda_rng, monkeypatch):
    """With K13's plain version and the tiled selection made to raise,
    knn_exact and fgr_features on CUDA tensors run through K13, one launch
    a call; float64, D = 33 and k above KNN_MAX_K raise."""
    def refuse(*args, **kw):
        raise AssertionError("a plain selection ran on CUDA tensors")

    monkeypatch.setattr(nn_kernels, "knn_select_reference", refuse)
    monkeypatch.setattr(knn, "knn_tiled", refuse)
    x, mask = _knn_case(cuda_rng, "surface", 4000)
    before = nn_kernels.LAUNCHES["knn_select"]
    d, i = knn.knn_exact(x, x, mask, 30, exclude_self=True)
    torch.cuda.synchronize()
    assert nn_kernels.LAUNCHES["knn_select"] == before + 1
    assert bool((i != torch.arange(4000, device=x.device)[:, None]).all())
    c = cloud.from_numpy(x.cpu().numpy()[mask.cpu().numpy()], 4096, device=x.device)
    before = nn_kernels.LAUNCHES["knn_select"]
    _, feat = fgr.fgr_features(c, 0.5)
    torch.cuda.synchronize()
    assert nn_kernels.LAUNCHES["knn_select"] == before + 1
    assert bool(torch.isfinite(feat).all())
    with pytest.raises(TypeError):
        nn_kernels.knn_select(x.double(), x.double(), mask, 20)
    f = torch.zeros(100, 33, device=x.device)
    with pytest.raises(ValueError):
        nn_kernels.knn_select(f, f, torch.ones(100, dtype=torch.bool, device=x.device), 20)
    with pytest.raises(ValueError):
        nn_kernels.knn_select(x, x, mask, nn_kernels.KNN_MAX_K + 1)


# voxel_counts (csrc/voxel_counts.cu): the pyramid planner's occupied-voxel
# counts, held bit for bit to native.count_voxels (the host route's count).
VOXEL_SCALES = multiscale.create_scales(5) + [0.8, 0.05, 0.37]


@pytest.fixture(scope="module")
def nclt_scans():
    """32 scans of portbench's NCLT scene (~24k points each)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from portbench import scene

    return scene.make_circuit(32, 2718281828, 0, capacity=32768, target_points=24000,
                              noise_m=0.01, side_step_m=1.0)[0]


def _padded(pts: np.ndarray, capacity: int):
    mask = np.zeros(capacity, dtype=bool)
    mask[:len(pts)] = True
    out = np.full((capacity, 3), cloud.PAD_COORD, dtype=np.float32)
    out[:len(pts)] = pts
    return out, mask


def _voxel_case(rng, kind: str, nclt):
    """(points (n, 3) f32, mask (n,) bool) numpy arrays of one case."""
    if kind == "nclt":
        return _padded(nclt[0], 32768)
    if kind == "facade":     # the Facade bucket, its first scan's count
        return _padded(rng.uniform([0, 0, 0], [60, 40, 20], size=(44728, 3)).astype(np.float32),
                       90112)
    if kind == "holes":      # masked rows hold points far below the valid ones
        pts = rng.uniform(-20, 20, size=(20000, 3)).astype(np.float32)
        mask = rng.random(20000) < 0.6
        pts[~mask] = rng.uniform(-1e5, -1e4, size=(int((~mask).sum()), 3))
        return pts, mask
    if kind == "empty":
        return np.full((4096, 3), cloud.PAD_COORD, np.float32), np.zeros(4096, dtype=bool)
    if kind == "one point":
        return _padded(np.array([[1.25, -3.5, 7.0]], np.float32), 256)
    if kind == "duplicated":
        pts = rng.uniform(-10, 10, size=(5000, 3)).astype(np.float32)
        return _padded(np.repeat(pts, 4, axis=0)[rng.permutation(20000)], 20480)
    if kind == "negative":
        return _padded(rng.uniform(-600, -100, size=(10000, 3)).astype(np.float32), 10240)
    if kind == "boundaries":  # mn + k * v in float32, for every scale
        mn = np.array([-3.7, 12.1, 0.3], np.float32)
        parts = [mn[None]]
        for v in VOXEL_SCALES:
            k = rng.integers(0, 200, size=(2500, 3)).astype(np.float32)
            parts.append(mn + k * np.float32(v))
        return _padded(np.concatenate(parts).astype(np.float32), 20480)
    raise ValueError(kind)


VOXEL_CASES = ["nclt", "facade", "holes", "empty", "one point", "duplicated", "negative",
               "boundaries"]


def _native_table(points: np.ndarray, mask: np.ndarray, scales) -> np.ndarray:
    from pcr_tpu_torch import native

    return np.array([native.count_voxels(points[mask], v) for v in scales], dtype=np.int64)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", VOXEL_CASES)
def test_voxel_counts_kernel_matches_native(cuda_rng, nclt_scans, kind):
    """Every (cloud, scale) count equals native.count_voxels on the valid
    rows, twice bit for bit, one launch a call; without its mask the cloud
    counts every row."""
    dev = torch.device("cuda")
    pts, mask = _voxel_case(cuda_rng, kind, nclt_scans)
    p, m = torch.as_tensor(pts, device=dev), torch.as_tensor(mask, device=dev)
    before = feature_kernels.LAUNCHES["voxel_counts"]
    first = feature_kernels.voxel_counts([p], [m], VOXEL_SCALES)
    again = feature_kernels.voxel_counts([p], [m], VOXEL_SCALES)
    torch.cuda.synchronize()
    assert feature_kernels.LAUNCHES["voxel_counts"] == before + 2
    assert first.dtype == torch.int64 and tuple(first.shape) == (1, len(VOXEL_SCALES))
    assert torch.equal(first, again)
    np.testing.assert_array_equal(first[0].cpu().numpy(), _native_table(pts, mask, VOXEL_SCALES))
    valid = p[m].contiguous()
    unmasked = feature_kernels.voxel_counts([valid], [None], VOXEL_SCALES)
    assert torch.equal(unmasked, first)


@pytest.mark.cuda
def test_voxel_counts_kernel_chunks_mixed_clouds(cuda_rng, nclt_scans):
    """Every case and the 32 NCLT scans in one call (capacities 256 to
    90112): one launch a chunk of voxel_chunks, each row the native count."""
    dev = torch.device("cuda")
    cases = [_voxel_case(cuda_rng, k, nclt_scans) for k in VOXEL_CASES]
    cases += [_padded(s, 32768) for s in nclt_scans]
    pts = [torch.as_tensor(p, device=dev) for p, _ in cases]
    masks = [torch.as_tensor(m, device=dev) for _, m in cases]
    before = feature_kernels.LAUNCHES["voxel_counts"]
    got = feature_kernels.voxel_counts(pts, masks, VOXEL_SCALES).cpu().numpy()
    chunks = feature_kernels.voxel_chunks(len(cases), 90112, len(VOXEL_SCALES))
    assert feature_kernels.LAUNCHES["voxel_counts"] == before + len(chunks) > before + 1
    want = np.stack([_native_table(p, m, VOXEL_SCALES) for p, m in cases])
    np.testing.assert_array_equal(got, want)


def _shifted_scans(scans, n: int, seed: int = 5):
    """n scans cycling over ``scans``, each copy moved by its own offset."""
    rng = np.random.default_rng(seed)
    return [scans[i % len(scans)] + (rng.uniform(-50, 50, 3).astype(np.float32)
                                     if i >= len(scans) else np.float32(0))
            for i in range(n)]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 32, 128])
def test_plan_scale_caps_card_route_equals_host(nclt_scans, monkeypatch, n):
    """On CUDA clouds the planner counts on the card: its table and caps
    equal the host route's on the same scans, one launch a chunk, one
    blocking read (a ``sync`` span at site plan_caps) and no cloud copied to
    the host; the span says route card."""
    dev = torch.device("cuda")
    scans = _shifted_scans(nclt_scans, n)
    scales = multiscale.create_scales(5)
    on_card = [cloud.from_numpy(s, 32768, device=dev) for s in scans]
    on_host = [cloud.from_numpy(s, 32768, device="cpu") for s in scans]
    want_table = cloud._host_counts(on_host, scales)
    want = cloud.plan_scale_caps(on_host, scales)
    torch.cuda.synchronize()
    copies = []
    to_host = torch.Tensor.cpu

    def cpu(t, *args, **kw):
        copies.append((tuple(t.shape), t.dtype, t.device.type))
        return to_host(t, *args, **kw)

    monkeypatch.setattr(torch.Tensor, "cpu", cpu)
    before = feature_kernels.LAUNCHES["voxel_counts"]
    trace.reset()
    trace.enable()
    try:
        caps = cloud.plan_scale_caps(on_card, scales)
    finally:
        trace.disable()
    assert caps == want
    assert copies == [((n, len(scales)), torch.int64, "cuda")]
    assert feature_kernels.LAUNCHES["voxel_counts"] == before + len(
        feature_kernels.voxel_chunks(n, 32768, len(scales)))
    spans = trace.snapshot().spans
    assert [s[5] for s in spans if s[0] == "data.plan_caps"] == [{"route": "card", "clouds": n}]
    assert [s[5] for s in spans if s[0] == "sync"] == [{"site": "plan_caps"}]
    np.testing.assert_array_equal(cloud._card_counts(on_card, scales), want_table)


@pytest.mark.cuda
def test_plan_scale_caps_lazy_clouds_on_the_card(nclt_scans):
    """A LazyClouds on the card gives the host route's caps through the
    kernel, one launch a chunk, and no scan enters its LRU; one host cloud
    has holes in its mask."""
    dev = torch.device("cuda")
    scans = _shifted_scans(nclt_scans, 64)
    scales = multiscale.create_scales(5)
    host = [cloud.from_numpy(s, 32768, device="cpu") for s in scans]
    order = torch.as_tensor(np.random.default_rng(6).permutation(32768))
    host[3] = cloud.Cloud(points=host[3].points[order].contiguous(),
                          mask=host[3].mask[order].contiguous())
    host = [cloud.Cloud(points=h.points.pin_memory(), mask=h.mask.pin_memory()) for h in host]
    want = cloud.plan_scale_caps(host, scales)
    lazy = cloud.LazyClouds(host, device=dev)
    before = feature_kernels.LAUNCHES["voxel_counts"]
    assert cloud.plan_scale_caps(lazy, scales) == want
    assert feature_kernels.LAUNCHES["voxel_counts"] == before + len(
        feature_kernels.voxel_chunks(64, 32768, len(scales)))
    assert not lazy._cache and not lazy._order
    np.testing.assert_array_equal(cloud._card_counts(lazy, scales),
                                  cloud._host_counts(host, scales))


@pytest.mark.cuda
def test_voxel_counts_refuses_on_the_card(cuda_rng):
    """CUDA tensors of the wrong dtype, shape or a mix of devices raise."""
    dev = torch.device("cuda")
    p = torch.zeros((64, 3), device=dev)
    m = torch.ones(64, dtype=torch.bool, device=dev)
    with pytest.raises(TypeError):
        feature_kernels.voxel_counts([p.double()], [m], [0.1])
    with pytest.raises(ValueError):
        feature_kernels.voxel_counts([p[:, :2].contiguous()], [m], [0.1])
    with pytest.raises(ValueError):
        feature_kernels.voxel_counts([p], [m.cpu()], [0.1])
