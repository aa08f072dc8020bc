"""The selection feature chain of pcr_tpu_torch (ops/normals, ops/outlier,
ops/fpfh, models/fgr.fgr_features, the unfused pyramid) held against
pcr_tpu on the same seeded numpy clouds: a bumpy surface of 900 points in a
1024 capacity (sentinel padding) and the same surface with 5% noise points
lifted off it.

Tolerances:
  * normals: zero on the same rows; elsewhere |n . n'| >= 1 - 1e-5 and the
    same sign (n . n' >= 1 - 1e-5), except where the covariance's two
    smallest eigenvalues lie within 1e-2 of its largest of each other (a
    near-collinear neighbourhood of 3-4 points: there the closed-form f32
    eigenvector moves by ~1e-2 rad between XLA's fused and PyTorch's eager
    arithmetic on bit-equal covariances); covariances within 1e-6 absolute,
    1e-4 relative (f32 moments summed in another order);
  * the outlier mask equal, except points whose mean neighbour distance lies
    within 1e-5 of the threshold;
  * FPFH: at least 99% of the rows within 1e-4 of the row's largest value
    (a neighbour at a bin edge or at the radius may land elsewhere: both
    packages select the same exact kNN but bin in other rounding orders);
  * the unfused pyramid: the same points (voxel order in both) and masks,
    normals and covariances as above.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcr_tpu.models import fgr as j_fgr
from pcr_tpu.models import multiscale as j_ms
from pcr_tpu.ops import fpfh as j_fpfh
from pcr_tpu.ops import knn as j_knn
from pcr_tpu.ops import normals as j_normals
from pcr_tpu.ops import outlier as j_outlier
from pcr_tpu.utils import cloud as j_cloud
from pcr_tpu_torch.models import fgr as t_fgr
from pcr_tpu_torch.models import multiscale as t_ms
from pcr_tpu_torch.ops import fpfh as t_fpfh
from pcr_tpu_torch.ops import knn as t_knn
from pcr_tpu_torch.ops import normals as t_normals
from pcr_tpu_torch.ops import outlier as t_outlier
from pcr_tpu_torch.utils import cloud as t_cloud
from tests.test_torch_stage2 import bumpy_circuit

torch.set_num_threads(1)
VOXEL = 0.2


@pytest.fixture(scope="module")
def surface():
    """(points (1024, 3), mask) of one bumpy scan, padded at PAD_COORD."""
    scans, _ = bumpy_circuit(np.random.default_rng(4), n_clouds=1, n=900)
    c = t_cloud.from_numpy(scans[0], 1024, device="cpu")
    return c.points.numpy(), c.mask.numpy()


@pytest.fixture(scope="module")
def noisy():
    """The surface with 45 points lifted 0.3-1 m off it (outlier fodder)."""
    rng = np.random.default_rng(5)
    scans, _ = bumpy_circuit(rng, n_clouds=1, n=900)
    pts = scans[0].copy()
    lift = rng.choice(900, 45, replace=False)
    pts[lift, 2] += rng.uniform(0.3, 1.0, 45).astype(np.float32)
    c = t_cloud.from_numpy(pts, 1024, device="cpu")
    return c.points.numpy(), c.mask.numpy()


def _t(x):
    return torch.from_numpy(np.array(x))


def _assert_normals_match(n_t, n_j, cov_j, mask):
    n_t, n_j = np.asarray(n_t)[mask], np.asarray(n_j)[mask]
    live = np.abs(n_j).sum(1) > 0
    assert live.mean() > 0.95
    np.testing.assert_array_equal(np.abs(n_t).sum(1) > 0, live)
    w = np.linalg.eigvalsh(np.asarray(cov_j, np.float64)[mask])
    conditioned = live & (w[:, 1] - w[:, 0] > 1e-2 * w[:, 2])
    assert conditioned.mean() > 0.9
    assert (np.sum(n_t[conditioned] * n_j[conditioned], 1) >= 1 - 1e-5).all()


def _assert_cov_match(c_t, c_j, mask):
    np.testing.assert_allclose(np.asarray(c_t)[mask], np.asarray(c_j)[mask], rtol=1e-4,
                               atol=1e-6)


def _assert_fpfh_match(f_t, f_j):
    f_t, f_j = np.asarray(f_t), np.asarray(f_j)
    scale = np.maximum(np.abs(f_j).max(1), 1e-12)
    ok = np.abs(f_t - f_j).max(1) <= 1e-4 * scale
    assert ok.mean() >= 0.99, ok.mean()


@pytest.mark.parametrize("kind", ["knn", "hybrid"])
def test_normals_match_pcr_tpu(surface, kind):
    p, m = surface
    if kind == "knn":
        n_j, c_j = j_normals.estimate_normals_knn(jnp.asarray(p), jnp.asarray(m), 20)
        n_t, c_t = t_normals.estimate_normals_knn(_t(p), _t(m), 20)
    else:
        n_j, c_j = j_normals.estimate_normals_hybrid(jnp.asarray(p), jnp.asarray(m),
                                                     2 * VOXEL, 20)
        n_t, c_t = t_normals.estimate_normals_hybrid(_t(p), _t(m), 2 * VOXEL, 20)
    assert bool((n_t.numpy()[~m] == 0).all())
    _assert_normals_match(n_t, n_j, c_j, m)
    _assert_cov_match(c_t, c_j, m)


def test_normals_from_shared_knn_and_covariances(surface):
    """hybrid normals from a precomputed self-excluded kNN, the KNN(30)
    covariances, the whole-cloud moments and the Cloud wrappers."""
    p, m = surface
    d2, idx = j_knn.knn(jnp.asarray(p), jnp.asarray(p), jnp.asarray(m), 40,
                        exclude_self=True)
    n_j, c_j = j_normals.estimate_normals_hybrid_from_knn(jnp.asarray(p), jnp.asarray(m), d2,
                                                          idx, 2 * VOXEL, 20)
    n_t, c_t = t_normals.estimate_normals_hybrid_from_knn(
        _t(p), _t(m), _t(d2), _t(idx).long(), 2 * VOXEL, 20)
    _assert_normals_match(n_t, n_j, c_j, m)
    _assert_cov_match(c_t, c_j, m)
    _assert_cov_match(t_normals.estimate_covariances(_t(p), _t(m)),
                      j_normals.estimate_covariances(jnp.asarray(p), jnp.asarray(m)), m)
    mu_j, cov_j = j_normals.cloud_mean_and_covariance(jnp.asarray(p), jnp.asarray(m))
    mu_t, cov_t = t_normals.cloud_mean_and_covariance(_t(p), _t(m))
    np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(cov_t.numpy(), np.asarray(cov_j), rtol=1e-4, atol=1e-6)
    c = t_normals.with_normals_hybrid(t_cloud.from_arrays(p, m, device="cpu"), 2 * VOXEL)
    assert c.normals.shape == (1024, 3) and c.covariances.shape == (1024, 3, 3)


def test_outlier_mask_matches_pcr_tpu(noisy):
    p, m = noisy
    keep_j = np.asarray(j_outlier.statistical_outlier_mask(jnp.asarray(p), jnp.asarray(m),
                                                           30, 1.0))
    keep_t = t_outlier.statistical_outlier_mask(_t(p), _t(m), 30, 1.0).numpy()
    # points at the threshold may fall either side (sums in another order)
    d2, _ = t_knn.knn(_t(p), _t(p), _t(m), 30, exclude_self=True)
    mean_d = torch.sqrt(d2).mean(1).numpy()
    mu, sd = mean_d[m].mean(), mean_d[m].std(ddof=1)
    edge = np.abs(mean_d - (mu + sd)) <= 1e-5
    assert 0 < (m & ~keep_t).sum() < 0.3 * m.sum()
    np.testing.assert_array_equal(keep_t[~edge], keep_j[~edge])
    c = t_outlier.remove_statistical_outliers(t_cloud.from_arrays(p, m, device="cpu"))
    assert torch.equal(c.mask, torch.from_numpy(keep_t))
    assert bool((c.points[~c.mask] == t_cloud.PAD_COORD).all())


@pytest.mark.parametrize("shared_knn", [False, True])
def test_fpfh_matches_pcr_tpu(surface, shared_knn):
    p, m = surface
    nrm, _ = j_normals.estimate_normals_hybrid(jnp.asarray(p), jnp.asarray(m), 2 * VOXEL, 20)
    kw_j, kw_t = {}, {}
    if shared_knn:
        d2, idx = j_knn.knn(jnp.asarray(p), jnp.asarray(p), jnp.asarray(m), 200,
                            exclude_self=True)
        kw_j = dict(knn_result=(d2, idx))
        kw_t = dict(knn_result=(_t(d2), _t(idx).long()))
    f_j = j_fpfh.fpfh(jnp.asarray(p), nrm, jnp.asarray(m), 10 * VOXEL, 200, **kw_j)
    f_t = t_fpfh.fpfh(_t(p), _t(nrm), _t(m), 10 * VOXEL, 200, **kw_t)
    assert f_t.shape == (1024, 33) and bool((f_t[~torch.from_numpy(m)] == 0).all())
    np.testing.assert_allclose(f_t.numpy()[m].sum(1), 300.0 * 2, rtol=1e-3)
    _assert_fpfh_match(f_t, f_j)


def test_fgr_features_match_pcr_tpu(surface):
    """One k=200 selection shared by the hybrid(2v, 20) normals and the
    FPFH(10v, 200); the points stay in input order.  The FPFH is held to
    pcr_tpu's fed the port's own normals: the few ill-conditioned normals
    (see the module notes) would otherwise move pair features of all their
    neighbours across bin edges."""
    p, m = surface
    c_j, _ = j_fgr.fgr_features(j_cloud.Cloud(points=jnp.asarray(p), mask=jnp.asarray(m)),
                                VOXEL)
    c_t, f_t = t_fgr.fgr_features(t_cloud.from_arrays(p, m, device="cpu"), VOXEL)
    assert torch.equal(c_t.points, torch.from_numpy(p))
    _assert_normals_match(c_t.normals, c_j.normals, c_j.covariances, m)
    _assert_cov_match(c_t.covariances, c_j.covariances, m)
    f_j = j_fpfh.fpfh(jnp.asarray(p), jnp.asarray(c_t.normals.numpy()), jnp.asarray(m),
                      10 * VOXEL, 200)
    _assert_fpfh_match(f_t, f_j)


def test_unfused_pyramid_matches_pcr_tpu(noisy):
    """build_pyramid(fused=False): voxel -> compact -> outlier -> KNN(20)
    normals, against pcr_tpu's unfused chain."""
    p, m = noisy
    caps = (512, 768)
    pyr_j = j_ms.build_pyramid(j_cloud.Cloud(points=jnp.asarray(p), mask=jnp.asarray(m)),
                               n_scales=2, scale_capacities=caps, fused=False)
    pyr_t = t_ms.build_pyramid(t_cloud.from_arrays(p, m, device="cpu"), n_scales=2,
                               scale_capacities=caps, fused=False)
    for c_t, c_j in zip(pyr_t, pyr_j):
        mj = np.asarray(c_j.mask)
        assert c_t.capacity == c_j.points.shape[0]
        np.testing.assert_array_equal(c_t.mask.numpy(), mj)
        np.testing.assert_allclose(c_t.points.numpy()[mj], np.asarray(c_j.points)[mj],
                                   rtol=1e-6, atol=1e-6)
        _assert_normals_match(c_t.normals, c_j.normals, c_j.covariances, mj)
        _assert_cov_match(c_t.covariances, c_j.covariances, mj)
