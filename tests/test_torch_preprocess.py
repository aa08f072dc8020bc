"""Fused preprocess (pcr_tpu_torch.ops.preprocess, kernels K2/K3's plain
versions on CPU) held against pcr_tpu.ops.preprocess on the same numpy
inputs: its XLA ``spacing_hint`` path and its Pallas kernels in interpret
mode.

Tolerances: pcr_tpu computes d2 by the expansion |q|^2 + |r|^2 - 2 q.r
(~1e-6 abs error at these coordinates), the port directly as (q - r)^2.  A
bisection step can flip only where a neighbour distance lies within that
error of a step's threshold, and then tau moves by one bisection cell
(log-space: 2 ln(2000) / 2^10 = 1.5%; linear: 4 tau / 2^10 = 0.4%).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pcr_tpu.ops import preprocess as j_pre
from pcr_tpu.ops.pallas import feature_kernels as j_fk
from pcr_tpu.utils import cloud as j_cloud
from pcr_tpu_torch.ops import preprocess as t_pre
from pcr_tpu_torch.ops.kernels import feature_kernels as t_fk
from pcr_tpu_torch.utils import cloud as t_cloud

torch.set_num_threads(1)

H = 0.2          # spacing hint (voxel size)
BAND = 512
Q_TILE = 256


def _surface(rng, n=900, cap=1024):
    """The LiDAR-like patch of tests/test_preprocess.py with 5 gross outliers."""
    pts = rng.uniform(-2, 2, size=(n, 3)).astype(np.float32)
    pts[:, 2] = 0.1 * np.sin(pts[:, 0] * 2) + 0.05 * pts[:, 1]
    pts[:5] += 40.0
    return pts, cap


def _tiled(rng):
    pts, cap = _surface(rng)
    c = t_cloud.from_numpy(pts, cap, device="cpu")
    ps, ms, p_q, p_r, starts = t_pre.sort_and_tile(c.points, c.mask, Q_TILE, BAND)
    return ms, p_q, p_r, starts


def test_outlier_stats_plain_matches_pallas_interpret(rng):
    ms, p_q, p_r, starts = _tiled(rng)
    mean_t, found_t, tau_t = t_fk.outlier_stats(starts, p_q, p_r, H, q_tile=Q_TILE, band=BAND)
    mean_j, found_j, tau_j = map(np.asarray, j_fk.outlier_stats_pallas(
        jnp.asarray(starts.numpy() // BAND), jnp.asarray(p_q.numpy().T),
        jnp.asarray(p_r.numpy().T), H, q_tile=Q_TILE, band=BAND, interpret=True))
    real = np.concatenate([ms.numpy(), np.zeros(p_q.shape[0] - ms.shape[0], bool)])
    mean_t, found_t, tau_t = mean_t.numpy(), found_t.numpy(), tau_t.numpy()
    np.testing.assert_array_equal(found_t[real], found_j[real])
    np.testing.assert_allclose(tau_t[real], tau_j[real], rtol=0.015)   # one cell
    same = real & (np.abs(tau_t - tau_j) <= 1e-6 * tau_j)   # same cell (exp ulps apart)
    assert same.sum() >= 0.99 * real.sum()
    np.testing.assert_allclose(mean_t[same], mean_j[same], rtol=1e-4)


def test_survivor_moments_plain_matches_pallas_interpret(rng):
    ms, p_q, p_r, starts = _tiled(rng)
    mean, found, tau = t_fk.outlier_stats(starts, p_q, p_r, H, q_tile=Q_TILE, band=BAND)
    n = ms.shape[0]
    keep = ms & found[:n] & (mean[:n] < 0.2)
    keep_r = torch.cat([keep, torch.zeros(p_r.shape[0] - n, dtype=torch.bool)])
    center = t_fk.slab_centroids(starts, p_r, BAND)
    S_t = t_fk.survivor_moments(starts, p_q, p_r, keep_r, tau, center,
                                q_tile=Q_TILE, band=BAND).numpy()
    S_j = np.asarray(j_fk.survivor_moments_pallas(
        jnp.asarray(starts.numpy() // BAND), jnp.asarray(p_q.numpy().T),
        jnp.asarray(p_r.numpy().T), jnp.asarray(tau.numpy()), jnp.asarray(keep.numpy()),
        q_tile=Q_TILE, band=BAND, interpret=True))
    real = np.concatenate([keep.numpy(), np.zeros(p_q.shape[0] - n, bool)])
    same = real & (S_t[:, 9] == S_j[:, 9])
    assert same.sum() >= 0.99 * real.sum()
    # f32 sums of ~20 terms in another order (and MXU vs CPU products)
    scale = 1.0 + np.abs(S_j[same]).max(axis=1, keepdims=True)
    np.testing.assert_allclose(S_t[same] / scale, S_j[same] / scale, atol=1e-5)


def _match_rows(c_t, c_j):
    """Survivor sets as coordinates; normals matched by coordinates."""
    Mt, Mj = c_t.mask.numpy(), np.asarray(c_j.mask)
    Pt, Pj = c_t.points.numpy(), np.asarray(c_j.points)
    st = {tuple(np.round(p, 5)) for p in Pt[Mt]}
    sj = {tuple(np.round(p, 5)) for p in Pj[Mj]}
    lut = {tuple(np.round(p, 5)): i for i, p in enumerate(Pj) if Mj[i]}
    Nt, Nj = c_t.normals.numpy(), np.asarray(c_j.normals)
    diffs = [min(np.linalg.norm(Nt[k] - Nj[lut[t]]), np.linalg.norm(Nt[k] + Nj[lut[t]]))
             for k in np.nonzero(Mt)[0] if (t := tuple(np.round(Pt[k], 5))) in lut]
    return st, sj, np.asarray(diffs)


@pytest.mark.parametrize("backend", ["xla", "pallas_interpret"])
def test_outlier_and_normals_matches(rng, backend):
    """The bounds of tests/test_preprocess.py's Pallas-vs-XLA check: the same
    survivor set, normals median < 1e-4 and 99th percentile < 0.05."""
    pts, cap = _surface(rng)
    cj = j_cloud.from_numpy(pts, cap)
    ct = t_cloud.from_numpy(pts, cap, device="cpu")
    out_j = j_pre.outlier_and_normals_sorted(cj.points, cj.mask, 30, 1.0, 20, band=BAND,
                                             spacing_hint=H, backend=backend)
    out_t = t_pre.outlier_and_normals_sorted(ct.points, ct.mask, 30, 1.0, 20, band=BAND,
                                             spacing_hint=H)
    st, sj, diffs = _match_rows(out_t, out_j)
    assert st == sj
    assert not any(abs(p[2]) > 10 for p in st)              # gross outliers gone
    assert np.median(diffs) < 1e-4
    assert np.percentile(diffs, 99) < 0.05
    np.testing.assert_allclose(np.linalg.norm(out_t.normals.numpy()[out_t.mask.numpy()],
                                              axis=1), 1.0, atol=1e-3)


def test_preprocess_scale_fused_matches(rng):
    """Voxel -> outlier -> normals at one pyramid scale (capacity-scaled band,
    q_tile 1024) on a bumpy 20 m x 20 m surface."""
    xy = rng.uniform(-10, 10, size=(4000, 2)).astype(np.float32)
    z = (0.5 * np.sin(0.7 * xy[:, :1]) + 0.3 * np.cos(1.3 * xy[:, 1:2])).astype(np.float32)
    pts = np.concatenate([xy, z], axis=1)
    pts[:40, 2] += rng.uniform(3, 8, size=40).astype(np.float32)
    out_j = j_pre.preprocess_scale_fused(j_cloud.from_numpy(pts, 4096), 0.25,
                                         scale_capacity=2048)
    out_t = t_pre.preprocess_scale_fused(t_cloud.from_numpy(pts, 4096, device="cpu"), 0.25,
                                         scale_capacity=2048)
    assert out_t.capacity == 2048
    st, sj, diffs = _match_rows(out_t, out_j)
    assert len(st ^ sj) <= 0.01 * len(sj)
    assert np.median(diffs) < 1e-4
    assert np.percentile(diffs, 99) < 0.05
    with pytest.raises(ValueError):
        t_pre.preprocess_scale_fused(t_cloud.from_numpy(pts, 4096, device="cpu"), 0.0)
