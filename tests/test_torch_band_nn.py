"""Band NN (pcr_tpu_torch.ops.band_nn, kernel K1's plain version on CPU) held
against pcr_tpu.ops.band_nn with backend='xla' (K1's TPU kernel has no
interpret mode) on the same numpy inputs.

Tolerances: the port computes d2 directly as (q - r)^2 while pcr_tpu ranks
by the expansion |q|^2 + |r|^2 - 2 q.r, so near-equal candidates may break
ties differently; the tests compare distances (and validity away from the
radius), never raw indices.

Slab placement: the port keeps pcr_tpu's slab unless that misses refs
level with a tile's queries while a slab centred on those holds them all
(pcr_tpu_torch/ops/band_nn.py); no tile of the parity tests below meets
that, so their slabs are pcr_tpu's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pcr_tpu.ops import band_nn as j_band
from pcr_tpu.utils import cloud as j_cloud
from pcr_tpu.utils import se3 as j_se3
from pcr_tpu_torch.ops import band_nn as t_band
from pcr_tpu_torch.utils import cloud as t_cloud
from pcr_tpu_torch.utils import se3 as t_se3

torch.set_num_threads(1)


def _pair(rng, nr=1800, nq=1500, cap=2048):
    r = rng.uniform(-5, 5, size=(nr, 3)).astype(np.float32)
    q = rng.uniform(-5, 5, size=(nq, 3)).astype(np.float32)
    return (j_cloud.from_numpy(r, cap), j_cloud.from_numpy(q, cap),
            t_cloud.from_numpy(r, cap, device="cpu"), t_cloud.from_numpy(q, cap, device="cpu"))


def _brute(q, qmask, r, rmask):
    d = np.sum((q[:, None, :] - r[None, :, :]) ** 2, axis=-1)
    d[:, ~rmask] = np.inf
    return d.min(axis=1)


def _assert_same_nn(d_t, d_j, d_true, mask, max_dist, exact=True):
    """Distances agree to f32 rounding (rtol 1e-5); validity agrees except
    within 1e-5 m^2 of the radius, where the expansion's error can flip it.
    ``exact``: every slab holds its tile's neighbourhoods, so both also equal
    brute force (otherwise both lose the same overflowing candidates)."""
    md2 = max_dist**2
    clear = mask & (np.abs(d_true - md2) > 1e-5)
    np.testing.assert_array_equal(d_t[clear] >= t_band.BIG, d_j[clear] >= j_band.BIG)
    found = clear & (d_t < t_band.BIG)
    np.testing.assert_allclose(d_t[found], d_j[found], rtol=1e-5, atol=1e-7)
    if exact:
        in_r = clear & (d_true <= md2)
        np.testing.assert_allclose(d_t[in_r], d_true[in_r], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("q_tile,band,exact", [(256, 512, True), (1024, 512, False),
                                               (128, 256, False)])
def test_nn1_band_matches(rng, q_tile, band, exact):
    rj, qj, rt, qt = _pair(rng)
    d_j, _ = j_band.nn1_band(qj.points, qj.mask, rj.points, rj.mask, 0.5,
                             q_tile=q_tile, band=band)
    d_t, i_t = t_band.nn1_band(qt.points, qt.mask, rt.points, rt.mask, 0.5,
                               q_tile=q_tile, band=band)
    mask = np.asarray(qj.mask)
    d_true = _brute(np.asarray(qj.points), mask, np.asarray(rj.points), np.asarray(rj.mask))
    _assert_same_nn(d_t.numpy(), np.asarray(d_j), d_true, mask, 0.5, exact)
    # returned indices name a real ref at the reported distance
    i_t = i_t.numpy()[mask]
    assert i_t.max() < 1800
    ref = rt.points.numpy()
    got = np.sum((qt.points.numpy()[mask] - ref[i_t]) ** 2, axis=1)
    ok = d_t.numpy()[mask] < t_band.BIG
    np.testing.assert_allclose(got[ok], d_t.numpy()[mask][ok], rtol=1e-6)


def test_band_query_with_stale_grouping(rng):
    """Index built at one pose, queries moved by a rigid motion (~0.3 m):
    slab bounds come from the current coordinates, so the result stays the
    exact nearest neighbour in both packages."""
    rj, qj, rt, qt = _pair(rng, nr=1500, nq=1400)
    xi = np.array([0.02, -0.01, 0.03, 0.2, -0.15, 0.1], np.float32)
    moved_j = j_se3.transform_points(j_se3.se3_exp(jnp.asarray(xi)), qj.points)
    moved_t = t_se3.transform_points(t_se3.se3_exp(torch.as_tensor(xi)), qt.points)
    idx_j = j_band.build_band_index(qj.points, qj.mask, rj.points, rj.mask, q_tile=256, band=512)
    idx_t = t_band.build_band_index(qt.points, qt.mask, rt.points, rt.mask, q_tile=256, band=512)
    np.testing.assert_array_equal(idx_t.q_order.numpy(), np.asarray(idx_j.q_order))
    np.testing.assert_array_equal(idx_t.r_order.numpy(), np.asarray(idx_j.r_order))
    d_j, _ = j_band.nn1_band_query(idx_j, moved_j, qj.mask, 0.5, q_tile=256, band=512)
    d_t, _ = t_band.nn1_band_query(idx_t, moved_t, qt.mask, 0.5, q_tile=256, band=512)
    mask = np.asarray(qj.mask)
    d_true = _brute(moved_t.numpy(), mask, np.asarray(rj.points), np.asarray(rj.mask))
    _assert_same_nn(d_t.numpy(), np.asarray(d_j), d_true, mask, 0.5)


@pytest.mark.parametrize("q_tile,exact", [(256, True), (1024, False)])
def test_nn1_band_query_sorted_matches(rng, q_tile, exact):
    """The sorted-space query the GICP loop calls every iteration (at
    q_tile 1024 there): same tiles, same slabs, and the port's distances
    equal pcr_tpu's rescored ones, which is what the port's K1 returns
    without a rescore pass."""
    rj, qj, rt, qt = _pair(rng)
    idx_j = j_band.build_band_index(qj.points, qj.mask, rj.points, rj.mask,
                                    q_tile=q_tile, band=512)
    idx_t = t_band.build_band_index(qt.points, qt.mask, rt.points, rt.mask,
                                    q_tile=q_tile, band=512)
    np.testing.assert_array_equal(idx_t.q_order.numpy(), np.asarray(idx_j.q_order))
    qs_j = jnp.asarray(np.asarray(qj.points)[np.asarray(idx_j.q_order)])
    ms_j = jnp.asarray(np.asarray(qj.mask)[np.asarray(idx_j.q_order)])
    d_j, _ = j_band.nn1_band_query_sorted(idx_j, qs_j, ms_j, 0.4, q_tile=q_tile, band=512,
                                          rescore=True)
    d_t, i_t = t_band.nn1_band_query_sorted(idx_t, torch.tensor(np.asarray(qs_j)),
                                            torch.tensor(np.asarray(ms_j)), 0.4,
                                            q_tile=q_tile, band=512)
    mask = np.asarray(ms_j)
    d_true = _brute(np.asarray(qs_j), mask, np.asarray(rj.points), np.asarray(rj.mask))
    _assert_same_nn(d_t.numpy(), np.asarray(d_j), d_true, mask, 0.4, exact)
    # the returned sorted row lies at the returned distance
    r_s = idx_t.r_sorted.numpy()
    i_t = i_t.numpy()
    found = mask & (d_t.numpy() < t_band.BIG)
    got = np.sum((np.asarray(qs_j)[found] - r_s[i_t[found]]) ** 2, axis=1)
    np.testing.assert_allclose(got, d_t.numpy()[found], rtol=1e-6)
    assert i_t[mask & (d_true <= 0.16)].max() < 1800


def test_nn1_band_respects_masks(rng):
    pts = rng.uniform(-2, 2, size=(300, 3)).astype(np.float32)
    c = t_cloud.from_numpy(pts, capacity=512, device="cpu")
    d, i = t_band.nn1_band(c.points, c.mask, c.points, c.mask, 0.5, q_tile=128, band=256)
    m = c.mask.numpy()
    assert i.numpy()[m].max() < 300                          # never a padded index
    np.testing.assert_allclose(d.numpy()[m], 0.0, atol=1e-6)


def _surface(rng, n):
    xy = rng.uniform(-4, 4, size=(n, 2))
    z = np.sin(1.3 * xy[:, :1]) * 0.5 + np.cos(0.9 * xy[:, 1:2]) * 0.4
    return np.concatenate([xy, z], axis=1).astype(np.float32)


@pytest.mark.parametrize("max_dist,pcr_tpu_share", [(0.3, 0.9), (2.0, 0.3)])
def test_overflowing_slab_keeps_the_tiles_own_neighbours(rng, max_dist, pcr_tpu_share):
    """A dense surface (7600 refs over 8 m of the sweep axis) at the GICP's
    geometry (tiles of 1024 queries, band 1024): the refs level with a tile
    fit in its 2048-row slab, the in-radius band does not.  pcr_tpu's slab,
    placed at tile_min - r rounded down to a band multiple, ends below the
    tile's upper queries, and misses the nearest neighbour of 12% of the
    queries at r = 0.3 m and of 74% at 2 m; the port centres such a slab on
    the level refs and finds every nearest neighbour."""
    r, q = _surface(rng, 7600), _surface(rng, 7200)
    rt, qt = (t_cloud.from_numpy(x, 8192, device="cpu") for x in (r, q))
    rj, qj = (j_cloud.from_numpy(x, 8192) for x in (r, q))
    d_t, _ = t_band.nn1_band(qt.points, qt.mask, rt.points, rt.mask, max_dist, q_tile=1024,
                             band=1024)
    d_j, _ = j_band.nn1_band(qj.points, qj.mask, rj.points, rj.mask, max_dist, q_tile=1024,
                             band=1024)
    d_true = np.concatenate([((q[i:i + 600, None] - r[None]) ** 2).sum(-1).min(axis=1)
                             for i in range(0, len(q), 600)])
    np.testing.assert_allclose(d_t.numpy()[:len(q)], d_true, rtol=1e-5, atol=1e-7)
    share_j = np.isclose(np.asarray(d_j)[:len(q)], d_true, rtol=1e-4, atol=1e-6).mean()
    assert share_j < pcr_tpu_share, share_j

