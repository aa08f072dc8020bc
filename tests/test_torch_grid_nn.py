"""ops/grid_nn (pcr_tpu_torch) held against pcr_tpu.ops.grid_nn on the same
seeded numpy inputs (padded clouds: masked rows at the PAD_COORD sentinel),
and pcr_tpu's own tests/test_grid_nn.py cases run on the port.

Tolerances:
  * build_grid: every field equal (orig_idx, starts, ends exact; the sorted
    points, origin and cell size bit for bit): both packages compute the
    same f32 cells (a subtraction, then a true division), the same low 17
    bits of the hash (pcr_tpu wraps it in int32, the port masks its int64)
    and a stable argsort of the same buckets;
  * nn1_grid: d2 within 1e-7 absolute (the same candidates in the same
    order, the same three-term f32 sum) and the indices equal, also where
    d2 is BIG (a query with no candidate takes orig_idx[0]; one whose
    nearest candidate lies beyond max_dist keeps its index);
  * against brute force (pcr_tpu's test): within max_dist the rows equal
    and d2 within 1e-6 relative; beyond it, BIG.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcr_tpu.ops import grid_nn as j_grid
from pcr_tpu.utils import cloud as j_cloud
from pcr_tpu_torch.ops import grid_nn as t_grid
from pcr_tpu_torch.ops import knn as t_knn
from pcr_tpu_torch.utils import cloud as t_cloud

torch.set_num_threads(1)


def _cloud(rng, n=1500, cap=2048, scale=5.0):
    """A padded cloud (pcr_tpu's from_numpy: masked rows at PAD_COORD) as
    (points, mask) numpy arrays; ~5% of the real rows masked off too."""
    pts = rng.uniform(-scale, scale, size=(n, 3)).astype(np.float32)
    pts[:, 2] *= 0.3
    c = j_cloud.from_numpy(pts, capacity=cap)
    mask = np.asarray(c.mask) & (rng.random(cap) > 0.05)
    return np.array(c.points), mask


def _grids(points, mask, max_dist):
    return (j_grid.build_grid(jnp.asarray(points), jnp.asarray(mask), max_dist),
            t_grid.build_grid(torch.from_numpy(points), torch.from_numpy(mask), max_dist))


@pytest.mark.parametrize("max_dist", [0.05, 0.3, 1.0])
def test_build_grid_matches_pcr_tpu(rng, max_dist):
    """Every field equal (module docstring); 0.05 m leaves most buckets
    holding one row, 1.0 m packs dozens into a bucket."""
    points, mask = _cloud(rng)
    g_j, g_t = _grids(points, mask, max_dist)
    for name in ("orig_idx", "starts", "ends", "points_sorted", "origin"):
        np.testing.assert_array_equal(getattr(g_t, name).numpy(),
                                      np.asarray(getattr(g_j, name)), err_msg=name)
    assert float(g_t.cell_size) == float(g_j.cell_size)
    assert g_t.starts.shape == (1 << 17,)


@pytest.mark.parametrize("max_dist,k_cap", [(0.3, 32), (1.0, 32), (1.0, 4)])
def test_nn1_grid_matches_pcr_tpu(rng, max_dist, k_cap):
    """d2 within 1e-7, indices equal everywhere (module docstring).  The
    queries reach 1.5 m past the cloud (no candidate, or the nearest beyond
    max_dist), and k_cap 4 truncates full buckets in both packages alike;
    the query count is not a tile multiple."""
    points, mask = _cloud(rng)
    q = rng.uniform(-6.5, 6.5, size=(1300, 3)).astype(np.float32)
    q[:, 2] *= 0.3
    g_j, g_t = _grids(points, mask, max_dist)
    d_j, i_j = j_grid.nn1_grid(g_j, jnp.asarray(q), max_dist, k_cap=k_cap, q_tile=512)
    d_t, i_t = t_grid.nn1_grid(g_t, torch.from_numpy(q), max_dist, k_cap=k_cap, q_tile=512)
    d_j, i_j = np.asarray(d_j), np.asarray(i_j)
    assert i_t.dtype == torch.int64 and d_t.shape == (1300,)
    np.testing.assert_array_equal(d_t.numpy() >= t_grid.BIG, d_j >= j_grid.BIG)
    real = d_j < j_grid.BIG
    assert 0.2 < real.mean() < 1.0
    np.testing.assert_allclose(d_t.numpy()[real], d_j[real], rtol=0, atol=1e-7)
    np.testing.assert_array_equal(i_t.numpy(), i_j)


def test_nn1_grid_without_candidates_takes_row_zero(rng):
    """A query far from every valid point gets (BIG, orig_idx[0]) in both
    packages; an all-masked cloud gives BIG everywhere."""
    points, mask = _cloud(rng, n=300, cap=512)
    q = np.array([[50.0, 50.0, 50.0], [0.0, 0.0, 0.0]], np.float32)
    g_j, g_t = _grids(points, mask, 0.3)
    d_j, i_j = j_grid.nn1_grid(g_j, jnp.asarray(q), 0.3)
    d_t, i_t = t_grid.nn1_grid(g_t, torch.from_numpy(q), 0.3)
    assert float(d_t[0]) >= t_grid.BIG and int(i_t[0]) == int(g_t.orig_idx[0])
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    _, g_none = _grids(points, np.zeros_like(mask), 0.3)
    d_none, _ = t_grid.nn1_grid(g_none, torch.from_numpy(q), 0.3)
    assert bool((d_none >= t_grid.BIG).all())


# pcr_tpu's tests/test_grid_nn.py, on the port

def test_grid_nn1_matches_exact(rng):
    pts = rng.uniform(-5, 5, size=(2000, 3)).astype(np.float32)
    q = rng.uniform(-5, 5, size=(1500, 3)).astype(np.float32)
    c = t_cloud.from_numpy(pts, 2048, device="cpu")
    max_dist = 0.5
    grid = t_grid.build_grid(c.points, c.mask, max_dist)
    d_g, i_g = t_grid.nn1_grid(grid, torch.from_numpy(q), max_dist, q_tile=512)
    d_e, i_e = t_knn.nn1_exact(torch.from_numpy(q), c.points, c.mask)
    d_g, i_g, d_e, i_e = (t.numpy() for t in (d_g, i_g, d_e, i_e))
    in_range = d_e <= max_dist ** 2
    np.testing.assert_array_equal(i_g[in_range], i_e[in_range])
    np.testing.assert_allclose(d_g[in_range], d_e[in_range], rtol=1e-6)
    assert (d_g[~in_range] >= t_grid.BIG).all()        # out-of-range queries flagged BIG


def test_grid_respects_mask(rng):
    pts = rng.uniform(-2, 2, size=(300, 3)).astype(np.float32)
    c = t_cloud.from_numpy(pts, 512, device="cpu")     # 212 padded points at the sentinel
    grid = t_grid.build_grid(c.points, c.mask, 0.5)
    d, i = t_grid.nn1_grid(grid, c.points[:300], 0.5)
    assert int(i.max()) < 300
    np.testing.assert_allclose(d.numpy(), 0.0, atol=1e-6)   # self-match


def test_grid_dense_cluster_overflow_tolerance(rng):
    """A cluster denser than k_cap still returns *a* valid neighbour within
    range for every query (the documented approximation)."""
    pts = (rng.normal(size=(500, 3)) * 0.01).astype(np.float32)   # all in one cell
    c = t_cloud.from_numpy(pts, 512, device="cpu")
    grid = t_grid.build_grid(c.points, c.mask, 1.0)
    d, _ = t_grid.nn1_grid(grid, c.points[:500], 1.0, k_cap=32)
    assert bool((d <= 1.0).all())
