"""K10's plain versions (``ops/kernels/gicp_kernels``), the band GICP's
Gauss-Newton iteration split at the seams of its three launches, held
against the iteration as one body (the loop's ``corr_step`` and ``step``
before the split, kept below), and Python mirrors of the CUDA kernels'
rules and arithmetic (``csrc/gicp.cu``) held against the plain versions."""

import bisect

import numpy as np
import pytest
import torch

import chip_smoke
from pcr_tpu_torch.models import gicp, multiscale
from pcr_tpu_torch.ops import band_nn
from pcr_tpu_torch.ops.kernels import gicp_kernels as k10
from pcr_tpu_torch.ops.kernels import nn_kernels
from pcr_tpu_torch.utils import cloud, se3

torch.set_num_threads(1)


def _surface(rng, n: int, extent: float = 5.0) -> np.ndarray:
    xy = rng.uniform(-extent, extent, size=(n, 2))
    z = 0.4 * np.sin(1.3 * xy[:, :1]) + 0.3 * np.cos(0.9 * xy[:, 1:2])
    return np.concatenate([xy, z], axis=1).astype(np.float32)


@pytest.fixture(scope="module")
def pyramid_pair():
    """Two scales of a wavy surface and of the same surface moved 0.1 m and
    0.03 rad, with 5 mm noise; the start is the identity."""
    rng = np.random.default_rng(7)
    pts = _surface(rng, 3000)
    c, s = np.cos(0.03), np.sin(0.03)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    moved = pts @ R.T + np.float32([0.1, -0.04, 0.02])
    moved += rng.normal(0, 0.005, moved.shape).astype(np.float32)
    src = cloud.from_numpy(pts, 4096, device="cpu")
    tgt = cloud.from_numpy(moved.astype(np.float32), 4096, device="cpu")
    return multiscale.build_pyramid(src, 2), multiscale.build_pyramid(tgt, 2)


def _step_before_split(move_args, move_kw, rows_args, rows_kw):
    """The band loop's iteration as one body, as it ran before the split:
    ``corr_step`` and ``step`` of ``models/gicp._gicp_band_sorted``.
    Returns (T_new, fitness, rmse, n_corr, H, g, metric sums)."""
    T, pts_m, mask_m, index, max_dist = move_args
    _, n_m, _, _, _, tgt_pack, _ = rows_args
    q_tile, band = move_kw["q_tile"], move_kw["band"]
    max_d2, a, loss, gm_k = rows_kw["max_d2"], rows_kw["a"], rows_kw["loss"], rows_kw["gm_k"]
    eye3 = torch.eye(3, dtype=torch.float32)
    minus_eye = (-eye3).expand(pts_m.shape[0], 3, 3)
    p = se3.transform_points(T, pts_m)
    d2a, i_s = band_nn.nn1_band_query_sorted(index, p, mask_m, max_dist, q_tile=q_tile,
                                             band=band)
    pack = tgt_pack[i_s]
    q, m = pack[:, :3], pack[:, 3:6]
    d = q - p
    d2 = torch.sum(d * d, dim=1)
    valid = mask_m & (d2a < band_nn.BIG) & (d2 <= max_d2)
    fitness, rmse, n_corr = gicp._metrics(valid, d2, mask_m)
    u = n_m @ T[:3, :3].T
    C = 2.0 * eye3 - a * (m[:, :, None] * m[:, None, :] + u[:, :, None] * u[:, None, :])
    M = gicp._inv3(C)
    r_norm = torch.sqrt(torch.clamp(d2, min=1e-16))
    w = gicp.robust_weight(loss, r_norm, gm_k) * valid.to(torch.float32)
    G = torch.cat([se3.skew(p), minus_eye], dim=-1)
    MG = M @ G
    wG = G * w[:, None, None]
    H = torch.einsum("nij,nik->jk", wG, MG)
    g = torch.einsum("nij,ni->j", wG, (M @ d[:, :, None])[:, :, 0])
    sums = torch.stack([torch.sum(valid.to(torch.float32)), torch.sum(mask_m.to(torch.float32)),
                        torch.sum(torch.where(valid, d2, 0.0))])
    return gicp._damped_step(H, g, n_corr, T, None), fitness, rmse, n_corr, H, g, sums


@pytest.mark.parametrize("loss", ["l2", "l1", "gm"])
@pytest.mark.parametrize("scale", [0, 1])
def test_split_matches_step_before_split(pyramid_pair, loss, scale):
    """gicp_move -> K1 -> gicp_rows -> gicp_update on the arguments of the
    loop's first iteration against the iteration as one body: the same H
    (its lower triangle, which the Cholesky reads), g and metric sums within
    summation rounding (1e-6 of the largest), the same T_new within 1e-6,
    and the state holds the metrics at the input pose."""
    ps, pt = pyramid_pair
    dist = multiscale.max_correspondence_distances(multiscale.create_scales(2))[scale]
    inputs = chip_smoke.k10_inputs(ps[scale], pt[scale], dist, np.eye(4, dtype=np.float32),
                                   loss=loss, q_tile=256)
    (margs, mkw), (rargs, rkw) = inputs["gicp_move"], inputs["gicp_rows"]
    T_old, fit, rmse, n_corr, H, g, metrics = _step_before_split(margs, mkw, rargs, rkw)
    T, _, _, index, _ = margs
    q_sp, starts = k10.gicp_move(*margs, **mkw)
    d2, rows = nn_kernels.nn1_band(starts, q_sp, index.r_sorted, q_tile=mkw["q_tile"],
                                   band=mkw["band"])
    sums = k10.gicp_rows(q_sp, *rargs[1:3], d2, rows, *rargs[5:], **rkw)
    assert sums.shape == (1, k10.ROW_FLOATS) and int(n_corr) > 100
    r, c = torch.tril_indices(6, 6)
    for got, want in ((sums[0, :21], H[r, c]), (sums[0, 21:27], g), (sums[0, 27:30], metrics)):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6 * float(want.abs().max()))
    assert float(sums[0, 27]) == float(n_corr)
    T_new, state = T.clone(), k10.initial_state("cpu")
    k10.gicp_update(sums, T_new, state, 1e-6, 1e-6)
    torch.testing.assert_close(T_new, T_old, rtol=0, atol=1e-6)
    torch.testing.assert_close(state[:3], torch.stack([fit, rmse, n_corr]), rtol=1e-6, atol=0)
    assert float(state[3]) == 0.0


def _searchsorted(ra: list, v: np.float32, right: bool) -> int:
    return bisect.bisect_right(ra, v) if right else bisect.bisect_left(ra, v)


def _starts_kernel_rule(q_sp, index, max_dist: float, q_tile: int, band: int) -> list:
    """gicp_move's slab start of every tile as csrc/gicp.cu takes it: the
    tile's min over its rows and max over its real rows (axis coordinate
    below SENTINEL / 2), three binary searches in ra_sorted, and the
    centred slab where the start rule misses level refs it would hold."""
    qa = q_sp[:, int(index.axis)].numpy().reshape(-1, q_tile)
    ra = index.ra_sorted.numpy().tolist()
    top = max(index.r_sorted.shape[0] // band - 2, 0)
    out = []
    for tile in qa:
        real = tile[tile < np.float32(band_nn.SENTINEL / 2)]
        mn = tile.min()
        mx = real.max() if real.size else np.float32(-band_nn.BIG)
        ss = _searchsorted(ra, np.float32(mn - np.float32(max_dist)), False)
        lo, hi = _searchsorted(ra, mn, False), _searchsorted(ra, mx, True)
        ours = min(max(ss // band, 0), top) * band
        centred = min(max((lo + hi) // 2 - band, 0), top * band)

        def level_rows(start, lo=lo, hi=hi):
            return max(min(hi, start + 2 * band) - max(lo, start), 0)

        centre = level_rows(ours) < hi - lo and level_rows(centred) == hi - lo and real.size
        out.append(centred if centre else ours)
    return out


@pytest.mark.parametrize("kind", ["surface", "crowded", "sparse_tail"])
@pytest.mark.parametrize("q_tile", [64, 256])
def test_move_starts_follow_the_kernel_rule(kind, q_tile):
    """The plain gicp_move's starts equal slab_starts' and the kernel's rule
    mirrored tile by tile: on a surface, where the target is crowded within
    the radius (the centred slab is taken for some tiles), and where most
    source rows are masked (tiles with no real row)."""
    rng = np.random.default_rng(3)
    src_pts = _surface(rng, 2500)
    tgt_pts = _surface(rng, 3500, extent=6.0)
    max_dist = 3.0 if kind == "crowded" else 0.5
    mask = np.ones(2500, bool)
    if kind == "sparse_tail":
        mask[rng.random(2500) < 0.8] = False
    src = cloud.from_numpy(src_pts, 2560, device="cpu")
    src.mask[:2500] = torch.as_tensor(mask)
    tgt = cloud.from_numpy(tgt_pts, 4096, device="cpu")
    T = se3.se3_exp(torch.tensor([0.0, 0.0, 0.02, 0.05, -0.03, 0.0]))
    band = gicp.iteration_band(tgt.capacity)
    index = band_nn.build_band_index(se3.transform_points(T, src.points), src.mask,
                                     tgt.points, tgt.mask, band=band)
    rows = -(-src.capacity // q_tile) * q_tile
    pts = cloud.pad_rows(src.points[index.q_order], rows, band_nn.SENTINEL)
    msk = cloud.pad_rows(src.mask[index.q_order], rows, False)
    q_sp, starts = k10.gicp_move(T, pts, msk, index, max_dist, q_tile=q_tile, band=band)
    torch.testing.assert_close(q_sp, torch.where(msk[:, None], se3.transform_points(T, pts),
                                                 band_nn.SENTINEL), rtol=0, atol=0)
    assert torch.equal(starts, band_nn.slab_starts(index, q_sp, max_dist, q_tile, band))
    assert torch.equal(starts, nn_kernels.slab_starts_reference(
        q_sp, index.r_sorted, index.ra_sorted, index.axis, max_dist, q_tile=q_tile, band=band))
    assert starts.tolist() == _starts_kernel_rule(q_sp, index, max_dist, q_tile, band)
    ra = index.ra_sorted.numpy().tolist()
    mins = q_sp[:, int(index.axis)].reshape(-1, q_tile).min(dim=1).values.numpy()
    ours = [min(_searchsorted(ra, np.float32(m - np.float32(max_dist)), False) // band,
                max(index.r_sorted.shape[0] // band - 2, 0)) * band for m in mins]
    assert (starts.tolist() != ours) == (kind == "crowded")


def _rows_kernel_arithmetic(q_sp, normals, mask, d2k, rows, tgt_pack, T, nr, max_d2, a, loss,
                            gm_k):
    """gicp_rows' per-row arithmetic as csrc/gicp.cu writes it, in float64
    over numpy rows: the 30 sums in the kernel's layout."""
    p = q_sp.double().numpy()
    j = np.clip(rows.numpy().astype(np.int64), 0, nr - 1)
    pack = tgt_pack.double().numpy()[j]
    d = pack[:, :3] - p
    d2 = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]
    valid = mask.numpy() & (d2k.numpy() <= max_d2) & (d2 <= max_d2)
    n = normals.double().numpy()[valid]
    p, d, d2, m = p[valid], d[valid], d2[valid], pack[valid, 3:6]
    R = T.double().numpy()[:3, :3]
    u = n @ R.T
    C = 2.0 * np.eye(3) - a * (m[:, :, None] * m[:, None, :] + u[:, :, None] * u[:, None, :])
    M = np.linalg.inv(C)
    rn = np.sqrt(np.maximum(d2, 1e-16))
    w = {"l2": np.ones_like(rn), "l1": 1.0 / np.maximum(rn, 1e-8),
         "gm": gm_k / (gm_k + rn * rn) ** 2}[loss]
    zero, one = np.zeros_like(rn), np.ones_like(rn)
    G = np.stack([np.stack([zero, -p[:, 2], p[:, 1], -one, zero, zero], -1),
                  np.stack([p[:, 2], zero, -p[:, 0], zero, -one, zero], -1),
                  np.stack([-p[:, 1], p[:, 0], zero, zero, zero, -one], -1)], 1)
    MG = M @ G
    wG = G * w[:, None, None]
    Md = (M @ d[:, :, None])[:, :, 0]
    tri = [(r, c) for r in range(6) for c in range(r + 1)]
    H = [np.sum(wG[:, :, r] * MG[:, :, c]) for r, c in tri]
    g = [np.sum(wG[:, :, r] * Md) for r in range(6)]
    return np.array(H + g + [valid.sum(), mask.numpy().sum(), d2.sum()])


def _update_kernel_arithmetic(s, T, state, rel_fit, rel_rmse):
    """gicp_update's update as csrc/gicp.cu (and common.cuh) writes it, in
    float64: H from the lower triangle, the damping, the unrolled Cholesky,
    se3_exp with its Taylor switches, exp(xi) T; the new state."""
    n_corr = s[27]
    fitness, rmse = n_corr / max(s[28], 1.0), np.sqrt(s[29] / max(n_corr, 1.0))
    H = np.zeros((6, 6))
    k = 0
    for r in range(6):
        for c in range(r + 1):
            H[r, c] = H[c, r] = s[k]
            k += 1
    H += 1e-6 * (np.trace(H) / 6.0 + 1.0) * np.eye(6)
    L = np.zeros((6, 6))
    for j in range(6):
        L[j, j] = np.sqrt(H[j, j] - L[j, :j] @ L[j, :j])
        for i in range(j + 1, 6):
            L[i, j] = (H[i, j] - L[i, :j] @ L[j, :j]) / L[j, j]
    y = np.zeros(6)
    for i in range(6):
        y[i] = (s[21 + i] - L[i, :i] @ y[:i]) / L[i, i]
    x = np.zeros(6)
    for i in range(5, -1, -1):
        x[i] = (y[i] - L[i + 1:, i] @ x[i + 1:]) / L[i, i]
    xi = -x if n_corr > 0 else np.zeros(6)
    w = xi[:3]
    th2 = w @ w
    th = np.sqrt(max(th2, 1e-32))
    taylor = th2 < 1e-12
    a = 1 - th2 / 6 if taylor else np.sin(th) / th
    b = 0.5 - th2 / 24 if taylor else (1 - np.cos(th)) / th2
    c = 1 / 6 - th2 / 120 if taylor else (th - np.sin(th)) / (th2 * th)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    E = np.eye(4)
    E[:3, :3] = np.eye(3) + a * K + b * K @ K
    E[:3, 3] = (np.eye(3) + b * K + c * K @ K) @ xi[3:]
    done = (abs(fitness - state[0]) < rel_fit and abs(rmse - state[1]) < rel_rmse) or n_corr == 0
    return E @ T, np.array([fitness, rmse, n_corr, float(done)])


@pytest.mark.parametrize("loss", ["l2", "l1", "gm"])
def test_rows_and_update_follow_the_kernel_arithmetic(pyramid_pair, loss):
    """The plain gicp_rows' sums against the kernel's per-row arithmetic in
    float64 (1e-4 of the largest entry of H, g and sum d2; the counts
    exactly), and the plain gicp_update's T and state against the kernel's
    update in float64 on the same sums (1e-5)."""
    ps, pt = pyramid_pair
    dist = multiscale.max_correspondence_distances(multiscale.create_scales(2))[1]
    T0 = np.eye(4, dtype=np.float32)
    T0[:3, 3] = [0.03, 0.02, -0.01]
    inputs = chip_smoke.k10_inputs(ps[1], pt[1], dist, T0, loss=loss, q_tile=256)
    rargs, rkw = inputs["gicp_rows"]
    sums = k10.gicp_rows(*rargs, **rkw)[0]
    mirror = _rows_kernel_arithmetic(*rargs, rkw["nr"], rkw["max_d2"], rkw["a"], loss,
                                     rkw["gm_k"])
    got = sums[:30].double().numpy()
    assert got[27] == mirror[27] > 100 and got[28] == mirror[28]
    for a, b in ((0, 21), (21, 27), (29, 30)):
        np.testing.assert_allclose(got[a:b], mirror[a:b], rtol=0,
                                   atol=1e-4 * np.abs(mirror[a:b]).max())
    T, state = rargs[6].clone(), torch.tensor([0.5, 0.02, 10.0, 0.0])
    T_want, st_want = _update_kernel_arithmetic(got, T.double().numpy(), state.double().numpy(),
                                                1e-6, 1e-6)
    k10.gicp_update(sums[None].clone(), T, state, 1e-6, 1e-6)
    np.testing.assert_allclose(T.double().numpy(), T_want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(state.double().numpy(), st_want, rtol=1e-5, atol=0)


def test_update_without_correspondences_and_of_summed_rows():
    """No correspondence: T stays as it was exactly and the state says done;
    the update reads rows of sums as their sum (a group's path passes it the
    all-reduced sum of its rows)."""
    T = se3.se3_exp(torch.tensor([0.01, -0.02, 0.03, 0.1, 0.2, -0.3]))
    sums = torch.zeros((3, k10.ROW_FLOATS))
    sums[:, 28] = torch.tensor([10.0, 20.0, 5.0])
    T_new, state = T.clone(), k10.initial_state("cpu")
    k10.gicp_update(sums, T_new, state, 1e-6, 1e-6)
    assert torch.equal(T_new, T) and state.tolist() == [0.0, 0.0, 0.0, 1.0]
    rng = np.random.default_rng(1)
    rows = torch.as_tensor(rng.normal(size=(5, k10.ROW_FLOATS)).astype(np.float32))
    rows[:, 27:29] = torch.as_tensor(rng.integers(1, 50, size=(5, 2)).astype(np.float32))
    rows[:, 29] = rows[:, 29].abs()
    pd = torch.as_tensor(rng.normal(size=(6, 6)).astype(np.float32))
    r, c = torch.tril_indices(6, 6)
    rows[:, :21] = (pd @ pd.T + 6 * torch.eye(6))[r, c] / 5
    T_rows, st_rows = T.clone(), torch.tensor([0.5, 0.02, 10.0, 0.0])
    T_sum, st_sum = T.clone(), st_rows.clone()
    k10.gicp_update(rows, T_rows, st_rows, 1e-6, 1e-6)
    k10.gicp_update(rows.sum(0, keepdim=True), T_sum, st_sum, 1e-6, 1e-6)
    assert torch.equal(T_rows, T_sum) and torch.equal(st_rows, st_sum)


def test_wrappers_refuse_bad_arguments(pyramid_pair):
    """An unknown loss, rows of sums of the wrong width and rows that are
    not whole query tiles raise before anything runs."""
    ps, pt = pyramid_pair
    inputs = chip_smoke.k10_inputs(ps[1], pt[1], 0.3, np.eye(4, dtype=np.float32), q_tile=256)
    (margs, mkw), (rargs, rkw) = inputs["gicp_move"], inputs["gicp_rows"]
    with pytest.raises(ValueError, match="unknown loss"):
        k10.gicp_rows(*rargs, **dict(rkw, loss="huber"))
    with pytest.raises(ValueError):
        k10.gicp_update(torch.zeros((1, 30)), margs[0].clone(), k10.initial_state("cpu"),
                        1e-6, 1e-6)
    with pytest.raises(ValueError):
        k10.gicp_update(torch.zeros((0, k10.ROW_FLOATS)), margs[0].clone(),
                        k10.initial_state("cpu"), 1e-6, 1e-6)
    with pytest.raises(ValueError):
        k10.gicp_move(margs[0], margs[1][:-1], margs[2][:-1], *margs[3:], **mkw)


@pytest.mark.parametrize("band,band_f", [(512, 1024), (1024, 2048), (512, 512)])
def test_requery_equals_a_full_index_build(band, band_f):
    """The band loop's final metrics index the same refs for the moved
    queries at another band: requery_band_index gives every field of
    build_band_index's, bit for bit (masked refs and queries included)."""
    rng = np.random.default_rng(5)
    ref = _surface(rng, 6000, extent=8.0)
    qry = _surface(rng, 5000, extent=8.0)
    r_mask = torch.as_tensor(rng.random(6144) >= 0.1)
    q_mask = torch.as_tensor(rng.random(5120) >= 0.1)
    r = cloud.pad_rows(torch.as_tensor(ref), 6144, 0.0)
    q = cloud.pad_rows(torch.as_tensor(qry), 5120, 0.0)
    T = se3.se3_exp(torch.tensor([0.01, -0.02, 0.3, 0.5, -0.2, 0.1]))
    index = band_nn.build_band_index(q, q_mask, r, r_mask, band=band)
    q_f = se3.transform_points(T, q)
    got = band_nn.requery_band_index(index, q_f, q_mask, band=band_f)
    want = band_nn.build_band_index(q_f, q_mask, r, r_mask, band=band_f)
    for name, a, b in zip(want._fields, got, want):
        assert torch.equal(a, b), name
