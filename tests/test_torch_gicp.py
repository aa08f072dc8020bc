"""GICP (pcr_tpu_torch.models.gicp: band correspondence via K1's plain
version on CPU, brute force via K7's, and the hash grid) held against
pcr_tpu.models.gicp._registration_gicp with the same corr_method on the
SAME pyramid: pcr_tpu builds it and
``cloud.from_arrays`` hands its leaves to the port, so GICP is tested apart
from preprocessing."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcr_tpu.models import gicp as j_gicp
from pcr_tpu.models import multiscale as j_ms
from pcr_tpu.utils import cloud as j_cloud
from pcr_tpu_torch.models import evaluate as t_eval
from pcr_tpu_torch.models import gicp as t_gicp
from pcr_tpu_torch.models import multiscale as t_ms
from pcr_tpu_torch.utils import cloud as t_cloud
from pcr_tpu_torch.utils import se3 as t_se3

torch.set_num_threads(1)


def _rot_z(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])


def bumpy_pair(rng, n=1500, cap=2048, step=0.4):
    """Two overlapping scans of one bumpy surface, the second shifted by
    ``step`` and yawed 0.05 rad; returns (src, tgt, T_gt src->tgt)."""
    clouds, poses = [], []
    for i in range(2):
        xy = rng.uniform(-4, 4, size=(n, 2))
        xy[:, 0] += i * step
        z = (np.sin(1.3 * xy[:, :1]) * 0.5 + np.cos(0.9 * xy[:, 1:2]) * 0.4
             + 0.2 * np.sin(2.7 * xy[:, :1] * xy[:, 1:2] / 4))
        T = np.eye(4)
        T[:3, :3] = _rot_z(0.05 * i)
        T[:3, 3] = [i * step, 0.1 * i, 0.0]
        Ti = np.linalg.inv(T)
        world = np.concatenate([xy, z], axis=1)
        clouds.append((world @ Ti[:3, :3].T + Ti[:3, 3]).astype(np.float32))
        poses.append(T)
    return clouds[1], clouds[0], np.linalg.inv(poses[0]) @ poses[1]


def _to_port(c):
    return t_cloud.from_arrays(np.asarray(c.points), np.asarray(c.mask),
                               normals=np.asarray(c.normals),
                               covariances=np.asarray(c.covariances), device="cpu")


@pytest.fixture(scope="module")
def pyramids():
    rng = np.random.default_rng(0)
    src, tgt, T_gt = bumpy_pair(rng)
    pyr_s = j_ms.build_pyramid(j_cloud.from_numpy(src, 2048), n_scales=2)
    pyr_t = j_ms.build_pyramid(j_cloud.from_numpy(tgt, 2048), n_scales=2)
    E = np.eye(4)
    E[:3, :3] = _rot_z(0.03)
    E[:3, 3] = [0.08, -0.05, 0.03]
    return pyr_s, pyr_t, E @ T_gt, T_gt


@pytest.mark.parametrize("scale,same_slabs", [(0, True), (1, False)], ids=["0", "1"])
def test_gicp_band_matches_pcr_tpu(pyramids, scale, same_slabs):
    """Pose within 1e-4 m / 1e-4 rad, iteration counts equal or +-1: the d2
    of the port's K1 is exact while pcr_tpu's XLA band ranks by the
    expansion, so a near-tie or a point at the radius can move an
    iteration's fitness/rmse by ~1e-6 and flip the 1e-6 convergence test one
    iteration early or late.  The final fitness and rmse equal the exact
    (brute-force) evaluation at the port's pose (1e-6) and, where both
    packages place the same slabs (scale 0), pcr_tpu's within 1e-5.  At
    scale 1 the final metrics' last tile overflows its slab: pcr_tpu's slab
    misses neighbours there (387 of the 395 correspondences at its pose),
    the port's, centred on the tile, misses none."""
    pyr_s, pyr_t, T0, _ = pyramids
    dist = j_ms.max_correspondence_distances(j_ms.create_scales(2))[scale]
    res_j = j_gicp._registration_gicp(pyr_s[scale], pyr_t[scale], dist,
                                      jnp.asarray(T0, jnp.float32), max_iteration=25,
                                      corr_method="band")
    src, tgt = _to_port(pyr_s[scale]), _to_port(pyr_t[scale])
    res_t = t_gicp.registration_gicp(src, tgt, dist, T0.astype(np.float32), max_iteration=25)
    T_j = np.asarray(res_j.transformation, np.float64)
    T_t = res_t.transformation.double().numpy()
    np.testing.assert_allclose(T_t[:3, 3], T_j[:3, 3], atol=1e-4)
    np.testing.assert_allclose(T_t[:3, :3], T_j[:3, :3], atol=1e-4)
    fit, rmse, _ = t_eval.evaluate_registration(src, tgt, dist, res_t.transformation,
                                                method="exact")
    assert abs(float(res_t.fitness) - float(fit)) <= 1e-6
    assert abs(float(res_t.inlier_rmse) - float(rmse)) <= 1e-6
    fit_j, _, _ = t_eval.evaluate_registration(src, tgt, dist, torch.from_numpy(T_j).float(),
                                               method="exact")
    assert (float(res_j.fitness) >= float(fit_j) - 1e-6) == same_slabs
    if same_slabs:
        assert abs(float(res_t.fitness) - float(res_j.fitness)) <= 1e-5
        assert abs(float(res_t.inlier_rmse) - float(res_j.inlier_rmse)) <= 1e-5
    else:
        assert float(res_t.fitness) > float(res_j.fitness)
    assert abs(int(res_t.iterations) - int(res_j.iterations)) <= 1
    assert int(res_t.iterations) < 25                         # converged


def test_multiscale_pyramids_recovers_pose(pyramids):
    """Both scales chained (the pipeline's call): the result lands within
    5 mm of ground truth and reports every scale's iteration count."""
    pyr_s, pyr_t, T0, T_gt = pyramids
    res = t_ms.multiscale_gicp_pyramids(tuple(map(_to_port, pyr_s)),
                                        tuple(map(_to_port, pyr_t)),
                                        T0.astype(np.float32), n_scales=2, iterations=25)
    T = res.transformation.double().numpy()
    assert np.linalg.norm(T[:3, 3] - T_gt[:3, 3]) < 5e-3
    assert res.scale_iterations.shape == (2,)
    assert int(res.scale_iterations[-1]) == int(res.iterations)


def test_gn_building_blocks_match(rng):
    """_inv3, the 6x6 Cholesky solve and the robust weights against pcr_tpu's
    (f32; the solve's factorization order differs, 1e-4 relative)."""
    A = rng.normal(size=(16, 3, 3)).astype(np.float32)
    A = A @ np.swapaxes(A, 1, 2) + 0.5 * np.eye(3, dtype=np.float32)
    np.testing.assert_allclose(t_gicp._inv3(torch.as_tensor(A)).numpy(),
                               np.asarray(j_gicp._inv3(jnp.asarray(A))), rtol=1e-4, atol=1e-5)
    X = rng.normal(size=(6, 6)).astype(np.float32)
    H = X @ X.T + 6 * np.eye(6, dtype=np.float32)
    g = rng.normal(size=6).astype(np.float32)
    np.testing.assert_allclose(t_gicp.solve6_cholesky(torch.as_tensor(H), torch.as_tensor(g)),
                               np.asarray(j_gicp.solve6_cholesky(jnp.asarray(H), jnp.asarray(g))),
                               rtol=1e-4, atol=1e-6)
    r = rng.uniform(0, 0.5, size=64).astype(np.float32)
    for loss in ("l2", "l1", "gm"):
        np.testing.assert_allclose(t_gicp.robust_weight(loss, torch.as_tensor(r), 1.0).numpy(),
                                   np.asarray(j_gicp.robust_weight(loss, jnp.asarray(r), 1.0)),
                                   rtol=1e-6)


def test_gicp_without_correspondences_keeps_pose():
    """No target point within reach: n_corr == 0 stops the loop after one
    iteration and leaves the pose as it was."""
    pts = np.random.default_rng(3).uniform(-1, 1, size=(200, 3)).astype(np.float32)
    src = t_cloud.from_numpy(pts, 256, device="cpu")
    tgt = t_cloud.from_numpy(pts + 50.0, 256, device="cpu")
    for c in (src, tgt):
        c.normals = torch.tensor([0.0, 0.0, 1.0]).expand(256, 3).contiguous()
    T0 = t_se3.se3_exp(torch.tensor([0.01, 0.0, 0.0, 0.1, 0.0, 0.0]))
    res = t_gicp.registration_gicp(src, tgt, 0.5, T0)
    assert int(res.iterations) == 1 and float(res.fitness) == 0.0
    torch.testing.assert_close(res.transformation, T0)


def test_gicp_step_matches_pcr_tpu(pyramids):
    """One brute-force step (K7's plain version here, pcr_tpu's nn1_exact)
    on the same regularized covariances: the updated pose within 1e-5, the
    metrics at the input pose within 1e-6 (the correspondences are the same:
    no near-tie is within the brute d2 tolerance at this scale).  The
    regularization itself agrees within 1e-4: the clamp keeps only the
    smallest eigenvector, which the closed-form f32 solver places within
    ~5e-5 on near-isotropic rows."""
    pyr_s, pyr_t, T0, _ = pyramids
    s, t = pyr_s[1], pyr_t[1]
    dist = j_ms.max_correspondence_distances(j_ms.create_scales(2))[1]
    cs = j_gicp.regularize_covariances(s.covariances)
    ct = j_gicp.regularize_covariances(t.covariances)
    out_j = j_gicp.gicp_step(s.points, cs, s.mask, t.points, ct, t.mask,
                             jnp.asarray(T0, jnp.float32), jnp.float32(dist))
    ps, pt = _to_port(s), _to_port(t)
    np.testing.assert_allclose(t_gicp.regularize_covariances(ps.covariances).numpy(),
                               np.asarray(cs), atol=1e-4)
    out_t = t_gicp.gicp_step(ps.points, torch.as_tensor(np.array(cs)), ps.mask, pt.points,
                             torch.as_tensor(np.array(ct)), pt.mask,
                             torch.as_tensor(T0, dtype=torch.float32), dist)
    np.testing.assert_allclose(out_t[0].numpy(), np.asarray(out_j[0]), atol=1e-5)
    for a, b in zip(out_t[1:], out_j[1:]):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("scale", [0, 1])
def test_gicp_brute_matches_pcr_tpu(pyramids, scale):
    """registration_gicp(corr_method='brute') against pcr_tpu's brute loop:
    poses within 1e-4, iteration counts equal, fitness/rmse within 1e-5."""
    pyr_s, pyr_t, T0, T_gt = pyramids
    dist = j_ms.max_correspondence_distances(j_ms.create_scales(2))[scale]
    res_j = j_gicp._registration_gicp(pyr_s[scale], pyr_t[scale], dist,
                                      jnp.asarray(T0, jnp.float32), max_iteration=25,
                                      corr_method="brute")
    res_t = t_gicp.registration_gicp(_to_port(pyr_s[scale]), _to_port(pyr_t[scale]), dist,
                                     T0.astype(np.float32), corr_method="brute",
                                     max_iteration=25)
    np.testing.assert_allclose(res_t.transformation.double().numpy(),
                               np.asarray(res_j.transformation, np.float64), atol=1e-4)
    assert int(res_t.iterations) == int(res_j.iterations) < 25
    assert abs(float(res_t.fitness) - float(res_j.fitness)) <= 1e-5
    assert abs(float(res_t.inlier_rmse) - float(res_j.inlier_rmse)) <= 1e-5
    assert float(res_t.num_correspondences) == float(res_j.num_correspondences)


def test_covariances_from_normals_and_dispatch(rng):
    """The plane-disk covariance of a unit normal equals pcr_tpu's; brute
    and grid GICP take it when a cloud has no covariances, and grid lands
    where pcr_tpu's grid does on the same clouds (1e-6, iterations equal);
    unknown methods raise."""
    n = rng.normal(size=(32, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    np.testing.assert_allclose(t_gicp.covariances_from_normals(torch.as_tensor(n)).numpy(),
                               np.asarray(j_gicp.covariances_from_normals(jnp.asarray(n))),
                               atol=1e-7)
    pts = rng.uniform(-1, 1, size=(200, 3)).astype(np.float32)
    src = t_cloud.from_numpy(pts, 256, device="cpu")
    src.normals = torch.tensor([0.0, 0.0, 1.0]).expand(256, 3).contiguous()
    res = t_gicp.registration_gicp(src, src, 0.5, np.eye(4, dtype=np.float32),
                                   corr_method="brute")
    assert float(res.fitness) == 1.0 and int(res.iterations) <= 2
    T0 = np.eye(4, dtype=np.float32)
    T0[:3, 3] = [0.02, -0.01, 0.03]
    res_g = t_gicp.registration_gicp(src, src, 0.5, T0, corr_method="grid")
    c_j = j_cloud.from_numpy(pts, 256)
    c_j = c_j.with_(covariances=j_gicp.covariances_from_normals(jnp.asarray(src.normals.numpy())))
    res_j = j_gicp._registration_gicp(c_j, c_j, 0.5, jnp.asarray(T0), corr_method="grid")
    np.testing.assert_allclose(res_g.transformation.numpy(), np.asarray(res_j.transformation),
                               atol=1e-6)
    assert int(res_g.iterations) == int(res_j.iterations)
    assert float(res_g.fitness) == float(res_j.fitness) == 1.0
    with pytest.raises(ValueError):
        t_gicp.registration_gicp(src, src, 0.5, np.eye(4), corr_method="kdtree")


@pytest.mark.parametrize("scale", [0, 1])
def test_gicp_grid_matches_pcr_tpu(pyramids, scale):
    """registration_gicp(corr_method='grid') against pcr_tpu's grid loop on
    the same pyramid: poses within 1e-5, iteration counts equal, fitness and
    rmse within 1e-5, the same correspondence count.  Both hash grids return
    the same neighbours with the same exact d2 (tests/test_torch_grid_nn.py),
    so only the float32 sums of the normal equations differ in order; the
    grid's result is brute force's (both exact within max_dist)."""
    pyr_s, pyr_t, T0, _ = pyramids
    dist = j_ms.max_correspondence_distances(j_ms.create_scales(2))[scale]
    res_j = j_gicp._registration_gicp(pyr_s[scale], pyr_t[scale], dist,
                                      jnp.asarray(T0, jnp.float32), max_iteration=25,
                                      corr_method="grid")
    src, tgt = _to_port(pyr_s[scale]), _to_port(pyr_t[scale])
    res_t = t_gicp.registration_gicp(src, tgt, dist, T0.astype(np.float32),
                                     corr_method="grid", max_iteration=25)
    np.testing.assert_allclose(res_t.transformation.double().numpy(),
                               np.asarray(res_j.transformation, np.float64), atol=1e-5)
    assert int(res_t.iterations) == int(res_j.iterations) < 25
    assert abs(float(res_t.fitness) - float(res_j.fitness)) <= 1e-5
    assert abs(float(res_t.inlier_rmse) - float(res_j.inlier_rmse)) <= 1e-5
    assert float(res_t.num_correspondences) == float(res_j.num_correspondences)
    res_b = t_gicp.registration_gicp(src, tgt, dist, T0.astype(np.float32),
                                     corr_method="brute", max_iteration=25)
    np.testing.assert_allclose(res_t.transformation.numpy(), res_b.transformation.numpy(),
                               atol=1e-6)


def _eval_clouds(rng):
    """tests/test_gicp.py::test_evaluate_band_matches_exact's pair."""
    pts = rng.uniform(-10, 10, size=(3000, 3)).astype(np.float32)
    pts[:, 2] *= 0.1
    shift = pts + rng.normal(size=(3000, 3)).astype(np.float32) * 0.05
    return pts, shift


@pytest.mark.parametrize("method", ["band", "exact"])
def test_evaluate_and_information_matrix_match(rng, method):
    """Both methods against pcr_tpu's same method and against the port's
    exact method, with tests/test_gicp.py:107-123's tolerances: n_corr
    equal, fitness within 1e-6 and rmse within 1e-5 relative, information
    matrices within 1e-5 relative (+1e-3)."""
    from pcr_tpu.models import evaluate as j_eval

    pts, shift = _eval_clouds(rng)
    a_j, b_j = j_cloud.from_numpy(pts, capacity=4096), j_cloud.from_numpy(shift, capacity=4096)
    a_t = t_cloud.from_numpy(pts, 4096, device="cpu")
    b_t = t_cloud.from_numpy(shift, 4096, device="cpu")
    T = np.eye(4, dtype=np.float32)
    got = t_eval.evaluate_registration(a_t, b_t, 0.2, T, method=method)
    for ref in (j_eval.evaluate_registration(a_j, b_j, 0.2, T, method=method),
                t_eval.evaluate_registration(a_t, b_t, 0.2, T, method="exact")):
        assert float(got[2]) == float(ref[2])
        np.testing.assert_allclose(float(got[0]), float(ref[0]), rtol=1e-6)
        np.testing.assert_allclose(float(got[1]), float(ref[1]), rtol=1e-5)
    I_t = t_eval.information_matrix(a_t, b_t, 0.2, T, method=method).numpy()
    for ref in (j_eval.information_matrix(a_j, b_j, 0.2, T, method=method),
                t_eval.information_matrix(a_t, b_t, 0.2, T, method="exact")):
        np.testing.assert_allclose(I_t, np.asarray(ref), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(I_t[3:, 3:], float(got[2]) * np.eye(3), atol=1e-3)


def test_evaluate_batches_match_loop(rng):
    pts, shift = _eval_clouds(rng)
    a = t_cloud.from_numpy(pts[:1000], 1024, device="cpu")
    b = t_cloud.from_numpy(shift[:1000], 1024, device="cpu")
    Ts = torch.stack([torch.eye(4), t_se3.se3_exp(torch.tensor([0.0, 0, 0.01, 0.02, 0, 0]))])
    sources, targets = t_cloud.stack_clouds([a, b]), t_cloud.stack_clouds([b, a])
    I_b = t_eval.information_matrix_batch(sources, targets, 0.3, Ts, method="exact")
    fit_b, _, n_b = t_eval.evaluate_registration_batch(sources, targets, 0.3, Ts, method="exact")
    assert I_b.shape == (2, 6, 6)
    for k, (s, t) in enumerate([(a, b), (b, a)]):
        torch.testing.assert_close(I_b[k], t_eval.information_matrix(s, t, 0.3, Ts[k],
                                                                     method="exact"))
        assert float(n_b[k]) == float(t_eval.evaluate_registration(s, t, 0.3, Ts[k],
                                                                   method="exact")[2])
    assert bool((fit_b > 0.5).all())
