"""The extras of pcr_tpu_torch.models: the manual-registration maths
(``manual``) and the eigenvalue features and random sampling
(``features``), held against pcr_tpu on the same seeded numpy inputs, with
twins of tests/test_extras.py.

Tolerances:
  * ``estimate_point_to_point``, numpy input: the same float64 numpy
    operations in both packages: 1e-12;
  * its tensor input, against pcr_tpu's jnp path: both float32, SVDs and
    sums from other libraries: 1e-5;
  * eigen features: within 1e-5 absolute or 1e-4 relative, a float32 3x3
    SVD on two LAPACKs and moments summed in another order;
  * sampling fractions: 1e-7, float32 arithmetic on five numbers;
  * ``random_downsample``: the kept mask identical given the same
    uniforms; with the port's own draws, the kept share within 4 sigma of
    the binomial's mean.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcr_tpu.models import features as j_feat
from pcr_tpu.models import manual as j_manual
from pcr_tpu.utils import cloud as j_cloud
from pcr_tpu_torch.models import features as t_feat
from pcr_tpu_torch.models import manual as t_manual
from pcr_tpu_torch.utils import cloud as t_cloud


def _rotation(rng) -> np.ndarray:
    """A random rotation (QR of a Gaussian matrix, determinant +1)."""
    Q, R = np.linalg.qr(rng.normal(size=(3, 3)))
    Q = Q @ np.diag(np.sign(np.diag(R)))
    return Q if np.linalg.det(Q) > 0 else -Q


def _matched(rng, n=50):
    pts = rng.normal(size=(n, 3))
    R = _rotation(rng)
    t = np.array([1.0, -2.0, 0.5])
    return pts, pts @ R.T + t + 0.01 * rng.normal(size=(n, 3)), R, t


# --------------------------------------------------------------------------
# manual
# --------------------------------------------------------------------------

@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
def test_point_to_point_numpy_matches_pcr_tpu(rng, weighted):
    p, q, _, _ = _matched(rng)
    w = rng.uniform(0.5, 2.0, size=len(p)) if weighted else None
    got = t_manual.estimate_point_to_point(p, q, w)
    want = np.asarray(j_manual.estimate_point_to_point(p, q, w))
    assert isinstance(got, np.ndarray) and got.dtype == np.float64
    np.testing.assert_allclose(got, want, atol=1e-12)


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
def test_point_to_point_tensor_matches_jnp(rng, weighted):
    p, q, _, _ = _matched(rng)
    p32, q32 = p.astype(np.float32), q.astype(np.float32)
    w = rng.uniform(0.5, 2.0, size=len(p)).astype(np.float32) if weighted else None
    got = t_manual.estimate_point_to_point(torch.from_numpy(p32), torch.from_numpy(q32),
                                           None if w is None else torch.from_numpy(w))
    want = np.asarray(j_manual.estimate_point_to_point(
        jnp.asarray(p32), jnp.asarray(q32), None if w is None else jnp.asarray(w)))
    assert torch.is_tensor(got) and got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_umeyama_recovers_rigid_transform(rng):
    pts = rng.normal(size=(50, 3))
    R = _rotation(rng)
    t = np.array([1.0, -2.0, 0.5])
    T = t_manual.estimate_point_to_point(pts, pts @ R.T + t)
    np.testing.assert_allclose(T[:3, :3], R, atol=1e-8)
    np.testing.assert_allclose(T[:3, 3], t, atol=1e-8)
    np.testing.assert_allclose(T[3], [0, 0, 0, 1])


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_umeyama_reflection_guard(rng, kind):
    """Planar points leave the smallest singular direction free, and an
    unguarded SVD returns a reflection for them."""
    pts = np.concatenate([rng.normal(size=(30, 2)), np.zeros((30, 1))], axis=1)
    R = _rotation(rng)
    q = pts @ R.T
    if kind == "numpy":
        T = t_manual.estimate_point_to_point(pts, q)
    else:
        T = t_manual.estimate_point_to_point(torch.from_numpy(pts.astype(np.float32)),
                                             torch.from_numpy(q.astype(np.float32))).double()
        T = T.numpy()
    assert np.linalg.det(T[:3, :3]) > 0.99
    np.testing.assert_allclose(pts @ T[:3, :3].T + T[:3, 3], q, atol=1e-5)


def test_manual_registration_with_picks(rng):
    pts = rng.normal(size=(100, 3))
    R = _rotation(rng)
    t = np.array([0.2, 0.1, -0.3])
    q = pts @ R.T + t
    picks = [3, 17, 42, 77]
    T = t_manual.manual_registration(pts, q, picks, picks)
    np.testing.assert_allclose(T[:3, :3], R, atol=1e-8)
    np.testing.assert_allclose(
        T, np.asarray(j_manual.manual_registration(pts, q, picks, picks)), atol=1e-12)


@pytest.mark.parametrize("picks", [([1, 2], [1, 2]), ([1, 2, 3], [1, 2])],
                         ids=["two_picks", "unmatched"])
def test_manual_registration_refuses_too_few_picks(rng, picks):
    pts = rng.normal(size=(10, 3))
    for manual in (t_manual, j_manual):
        with pytest.raises(ValueError, match=">= 3"):
            manual.manual_registration(pts, pts, *picks)


def test_random_rotation_matrix_is_pcr_tpus_rotation():
    for seed in range(5):
        M = t_manual.random_rotation_matrix(rng=np.random.default_rng(seed))
        np.testing.assert_allclose(M @ M.T, np.eye(3), atol=1e-12)
        np.testing.assert_allclose(np.linalg.det(M), 1.0, atol=1e-12)
        want = j_manual.random_rotation_matrix(rng=np.random.default_rng(seed))
        np.testing.assert_array_equal(M, want)
    half = t_manual.random_rotation_matrix(0.5, rng=np.random.default_rng(0))
    np.testing.assert_array_equal(
        half, j_manual.random_rotation_matrix(0.5, rng=np.random.default_rng(0)))


@pytest.mark.parametrize("kind", ["tensor", "numpy"])
def test_flatten_to_xy(rng, kind):
    pts = rng.normal(size=(2, 10, 3)).astype(np.float32)
    x = torch.from_numpy(pts.copy()) if kind == "tensor" else pts.copy()
    flat = t_manual.flatten_to_xy(x)
    assert type(flat) is type(x) and flat is not x
    flat = np.asarray(flat)
    assert (flat[..., 2] == 0).all()
    np.testing.assert_array_equal(flat[..., :2], pts[..., :2])
    np.testing.assert_array_equal(np.asarray(x), pts)                # the input is untouched
    np.testing.assert_array_equal(flat, np.asarray(j_manual.flatten_to_xy(jnp.asarray(pts))))


# --------------------------------------------------------------------------
# features
# --------------------------------------------------------------------------

def _shape(rng, kind: str) -> np.ndarray:
    if kind == "plane":
        xy = rng.uniform(-1, 1, size=(500, 2))
        return np.concatenate([xy, 0.001 * rng.normal(size=(500, 1))], axis=1)
    if kind == "line":
        t = rng.uniform(-1, 1, size=(500, 1))
        return np.concatenate([t, 0.001 * rng.normal(size=(500, 2))], axis=1)
    xy = rng.uniform(-4, 4, size=(450, 2))                         # a bumpy surface
    return np.concatenate([xy, np.sin(1.3 * xy[:, :1]) * 0.5 + 3.0], axis=1)


def _eigen(pts: np.ndarray, capacity: int = 512):
    pts = pts.astype(np.float32)
    t = t_cloud.from_numpy(pts, capacity, device="cpu")
    j = j_cloud.from_numpy(pts, capacity=capacity)
    return (t_feat.extract_eigen_features(t.points, t.mask).numpy(),
            np.asarray(j_feat.extract_eigen_features(j.points, j.mask)))


@pytest.mark.parametrize("kind", ["plane", "line", "surface"])
def test_eigen_features_match_pcr_tpu(rng, kind):
    got, want = _eigen(_shape(rng, kind))
    assert got.shape == (7,) and got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)


def test_eigen_features_plane_vs_line(rng):
    f_plane, _ = _eigen(_shape(rng, "plane"))
    f_line, _ = _eigen(_shape(rng, "line"))
    assert f_plane[1] > 0.5 and f_plane[2] < 0.05      # planarity high, sphericity low
    assert f_line[0] > 0.9                             # linearity high
    # the reference's unparenthesised anisotropy s0 - s2/s0 on unit-norm s:
    # ~0.71 for a plane (s0 ~ s1), where (s0 - s2)/s0 = 1 - sphericity ~ 1
    assert abs(f_plane[4] - (1.0 - f_plane[2])) > 0.2


def test_multiscale_sampling_fractions():
    f = t_feat.multiscale_sampling_fractions(5, 0.1, device="cpu")
    assert f.shape == (5,) and f.dtype == torch.float32
    f = f.numpy()
    assert (np.diff(f) < 0).all()                       # decreasing with scale
    np.testing.assert_allclose(np.linalg.norm(f), 1.0, rtol=1e-6)
    for n, v in ((5, 0.1), (3, 0.25), (1, 0.05)):
        np.testing.assert_allclose(
            t_feat.multiscale_sampling_fractions(n, v, device="cpu").numpy(),
            np.asarray(j_feat.multiscale_sampling_fractions(n, v)), atol=1e-7)
    assert (t_feat.SAMPLING_A, t_feat.SAMPLING_B) == (j_feat.SAMPLING_A, j_feat.SAMPLING_B)


@pytest.mark.parametrize("fraction", [0.3, 0.75])
def test_random_downsample_given_u_keeps_pcr_tpus_points(rng, fraction):
    pts = rng.normal(size=(1000, 3)).astype(np.float32)
    t = t_cloud.from_numpy(pts, 1024, device="cpu")
    j = j_cloud.from_numpy(pts, capacity=1024)
    want = j_feat.random_downsample(j, fraction, seed=1)
    u = np.array(jax.random.uniform(jax.random.PRNGKey(1), (1024,)))
    got = t_feat.random_downsample(t, fraction, u=torch.from_numpy(u))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_array_equal(got.points.numpy(), np.asarray(want.points))
    assert got.capacity == 1024 and 0 < int(got.count()) < 1000


def test_random_downsample_keeps_a_binomial_share(rng):
    pts = rng.normal(size=(1000, 3)).astype(np.float32)
    c = t_cloud.from_numpy(pts, 1024, device="cpu")
    sigma = np.sqrt(1000 * 0.3 * 0.7)
    for seed in range(3):
        d = t_feat.random_downsample(c, 0.3, seed=seed)
        kept = int(d.count())
        assert abs(kept - 300) < 4 * sigma, (seed, kept)
        assert not d.mask[1000:].any()                          # padding stays out
        assert (d.points[~d.mask] == t_cloud.PAD_COORD).all()
        again = t_feat.random_downsample(c, 0.3, seed=seed)       # seeded: reproducible
        assert torch.equal(again.mask, d.mask)
    gen = torch.Generator().manual_seed(7)
    a = t_feat.random_downsample(c, 0.3, generator=gen)
    b = t_feat.random_downsample(c, 0.3, generator=gen)          # the stream moves on
    assert not torch.equal(a.mask, b.mask)
