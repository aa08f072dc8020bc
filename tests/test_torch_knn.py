"""ops/knn (pcr_tpu_torch) held against pcr_tpu.ops.knn on the same seeded
numpy inputs: points (D = 3, coordinates within +-20 m, with masked refs and
PAD_COORD sentinel rows) and FPFH-like features (D = 33, values 0..200).

Tolerances:
  * k-NN d2 within 1e-6 relative (+1e-9 absolute): both packages select by
    the expanded |q|^2 + |r|^2 - 2 q.r and re-score the winners exactly, so
    they differ only in the summation order of the exact sums (<= 33 terms);
  * indices equal wherever a d2 differs from its row neighbours by more than
    that tolerance (a tie may be listed in either order);
  * nn1 (K7's plain version on the CPU) takes the minimum of the exact d2,
    while pcr_tpu's nn1_exact selects by the expanded form, whose
    cancellation error at this scale is bounded by
    8 * 2^-24 * (|q|^2 + max |r|^2); the two d2 agree within that bound, and
    the rows agree wherever the two nearest exact d2 are further apart.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcr_tpu.ops import knn as j_knn
from pcr_tpu_torch.ops import knn as t_knn
from pcr_tpu_torch.ops.kernels import nn_kernels
from pcr_tpu_torch.utils.cloud import PAD_COORD

torch.set_num_threads(1)
RTOL = 1e-6


def _data(rng, dim, n=700, pad=60):
    """(points (n + pad, dim), mask): ~10% of the real rows masked off, then
    ``pad`` sentinel rows at PAD_COORD (masked), as a padded Cloud has."""
    if dim == 3:
        x = rng.uniform(-20, 20, size=(n, 3)).astype(np.float32)
        x[:, 2] *= 0.2
    else:
        x = (rng.gamma(0.5, 20.0, size=(n, dim)).clip(0, 200)).astype(np.float32)
    x = np.concatenate([x, np.full((pad, dim), PAD_COORD, np.float32)])
    mask = np.concatenate([rng.random(n) > 0.1, np.zeros(pad, bool)])
    return x, mask


def _t(x):
    return torch.from_numpy(np.array(x))


def _assert_knn_match(d_t, i_t, d_j, i_j, rows):
    """d2 within RTOL where real, >= BIG at the same entries, and indices
    equal where the d2 is separated from its neighbours in the row."""
    d_t, i_t = d_t.numpy()[rows], i_t.numpy()[rows]
    d_j, i_j = np.asarray(d_j)[rows], np.asarray(i_j)[rows]
    big_t, big_j = d_t >= t_knn.BIG, d_j >= t_knn.BIG
    np.testing.assert_array_equal(big_t, big_j)
    real = ~big_t
    np.testing.assert_allclose(d_t[real], d_j[real], rtol=RTOL, atol=1e-9)
    tol = RTOL * np.abs(d_j) + 1e-9
    padded = np.pad(d_j, ((0, 0), (1, 1)), constant_values=np.inf)
    padded[:, 0] = -np.inf               # the first column has no left neighbour
    apart = ((padded[:, 1:-1] - padded[:, :-2] > 2 * tol)
             & (padded[:, 2:] - padded[:, 1:-1] > 2 * tol) & real)
    assert apart[real].mean() > 0.9
    np.testing.assert_array_equal(i_t[apart], i_j[apart])


@pytest.mark.parametrize("dim", [3, 33])
@pytest.mark.parametrize("exclude_self", [False, True])
@pytest.mark.parametrize("method", ["auto", "exact", "approx"])
def test_knn_matches_pcr_tpu(rng, dim, exclude_self, method):
    x, mask = _data(rng, dim)
    k = 16
    jm = "approx" if method == "approx" else "exact"
    d_j, i_j = j_knn.knn(jnp.asarray(x), jnp.asarray(x), jnp.asarray(mask), k,
                         exclude_self=exclude_self, method=jm)
    d_t, i_t = t_knn.knn(_t(x), _t(x), _t(mask), k, exclude_self=exclude_self, method=method)
    assert d_t.shape == (x.shape[0], k) and i_t.dtype == torch.int64
    assert bool((d_t[:, 1:] >= d_t[:, :-1]).all())               # ascending
    _assert_knn_match(d_t, i_t, d_j, i_j, mask)


@pytest.mark.parametrize("exclude_self", [False, True])
def test_knn_exact_fewer_valid_refs_than_k(rng, exclude_self):
    """With 12 valid refs and k = 20 the missing entries are >= BIG in both
    packages; the query tile and the ref count are not tile multiples."""
    x, _ = _data(rng, 3, n=300, pad=0)
    mask = np.zeros(300, bool)
    mask[rng.choice(300, 12, replace=False)] = True
    q = x[:130]
    d_j, i_j = j_knn.knn_exact(jnp.asarray(q), jnp.asarray(x), jnp.asarray(mask), 20,
                               exclude_self=exclude_self, q_tile=64)
    d_t, i_t = t_knn.knn_exact(_t(q), _t(x), _t(mask), 20, exclude_self=exclude_self,
                               q_tile=64)
    n_real = (d_t < t_knn.BIG).sum(1).numpy()
    assert set(n_real.tolist()) <= {11, 12}
    _assert_knn_match(d_t, i_t, d_j, i_j, slice(None))


@pytest.mark.parametrize("exclude_self", [False, True])
@pytest.mark.parametrize("k", [1, 20, 200])
@pytest.mark.parametrize("case", ["self", "other_cloud", "few_valid"])
def test_knn_select_plain_matches_pcr_tpu(rng, case, k, exclude_self):
    """K13's plain version (the rule the kernel holds to, bit for bit, on the
    card) against pcr_tpu's knn_exact on the same points: a padded cloud
    against itself; queries that are another cloud (nq != nr, not a tile
    multiple); and 12 valid refs at k >= 20, where the slots past them are
    >= BIG in both."""
    x, mask = _data(rng, 3)
    q = x
    if case == "other_cloud":
        q = rng.uniform(-21, 21, size=(333, 3)).astype(np.float32)
        q[:, 2] *= 0.2
    elif case == "few_valid":
        mask = np.zeros(len(x), bool)
        mask[rng.choice(700, 12, replace=False)] = True
    d_j, i_j = j_knn.knn_exact(jnp.asarray(q), jnp.asarray(x), jnp.asarray(mask), k,
                               exclude_self=exclude_self)
    d_t, i_t = nn_kernels.knn_select_reference(_t(q), _t(x), _t(mask), k,
                                               exclude_self=exclude_self)
    rows = mask if case == "self" else slice(None)
    _assert_knn_match(d_t, i_t, d_j, i_j, rows)


def test_knn_approx_without_rescore(rng):
    """rescore=False returns the selection's expanded d2 (clamped at 0):
    within its cancellation bound of pcr_tpu's, and of the exact d2."""
    x, mask = _data(rng, 3)
    d_j, _ = j_knn.knn_approx(jnp.asarray(x), jnp.asarray(x), jnp.asarray(mask), 10,
                              exclude_self=True, rescore=False)
    d_t, i_t = t_knn.knn_approx(_t(x), _t(x), _t(mask), 10, exclude_self=True, rescore=False)
    d_j, d_t = np.asarray(d_j)[mask], d_t.numpy()[mask]
    norms = np.sum(x[mask].astype(np.float64) ** 2, 1)
    bound = 8 * 2.0 ** -24 * (norms[:, None] + norms.max())
    assert (d_t >= 0).all()
    assert (np.abs(d_t - d_j) <= 2 * bound).all()
    xt = _t(x)
    exact = t_knn.exact_sqdist(xt[:, None, :], xt[i_t]).numpy()[mask]
    assert (np.abs(d_t - exact) <= bound).all()


def test_hybrid_matches_pcr_tpu(rng):
    x, mask = _data(rng, 3)
    d_j, i_j, v_j = j_knn.hybrid(jnp.asarray(x), jnp.asarray(x), jnp.asarray(mask), 20, 1.5,
                                 method="exact")
    d_t, i_t, v_t = t_knn.hybrid(_t(x), _t(x), _t(mask), 20, 1.5)
    _assert_knn_match(d_t, i_t, d_j, i_j, mask)
    near_edge = np.abs(np.asarray(d_j) - np.float32(1.5) ** 2) <= 1e-5
    np.testing.assert_array_equal(v_t.numpy()[~near_edge], np.asarray(v_j)[~near_edge])


def _nn1_bound(q, r):
    """Cancellation bound of the expanded d2 per query."""
    qn = np.sum(q.astype(np.float64) ** 2, 1)
    return 8 * 2.0 ** -24 * (qn + np.sum(r.astype(np.float64) ** 2, 1).max())


@pytest.mark.parametrize("method", ["auto", "pallas", "exact"])
@pytest.mark.parametrize("nq,nr", [(1000, 3001), (257, 700)])
def test_nn1_matches_pcr_tpu(rng, method, nq, nr):
    """nn1 against pcr_tpu's nn1_exact (its CPU path), on real refs with
    masked rows and sentinels; queries at other positions than the refs."""
    r, mask = _data(rng, 3, n=nr - 40, pad=40)
    q = rng.uniform(-21, 21, size=(nq, 3)).astype(np.float32)
    q[:, 2] *= 0.2
    d_j, i_j = map(np.asarray, j_knn.nn1_exact(jnp.asarray(q), jnp.asarray(r),
                                               jnp.asarray(mask)))
    d_t, i_t = t_knn.nn1(_t(q), _t(r), _t(mask), method=method)
    assert i_t.dtype == torch.int64
    d_t, i_t = d_t.numpy(), i_t.numpy()
    real_r = r[mask].astype(np.float64)
    d_all = np.sum((q[:, None, :].astype(np.float64) - real_r[None]) ** 2, -1)
    two = np.sort(d_all, 1)[:, :2]
    bound = _nn1_bound(q, real_r)
    assert (np.abs(d_t - d_j) <= bound).all()
    assert mask[i_t].all() and mask[i_j].all()
    apart = two[:, 1] - two[:, 0] > 2 * bound
    assert apart.mean() > 0.9
    np.testing.assert_array_equal(i_t[apart], i_j[apart])
    if method != "exact":   # K7: the exact minimum, to f32 rounding
        np.testing.assert_allclose(d_t, two[:, 0], rtol=1e-6, atol=1e-9)


def test_nn1_no_valid_ref_is_big():
    q = np.zeros((5, 3), np.float32)
    r = np.ones((9, 3), np.float32)
    for method in ("auto", "exact"):
        d, _ = t_knn.nn1(_t(q), _t(r), _t(np.zeros(9, bool)), method=method)
        assert bool((d >= t_knn.BIG).all())


def test_nn1_plain_kernel_first_minimum_on_ties(rng):
    """K7's plain version: exact ((dx*dx + dy*dy) + dz*dz) distances and the
    first of equal minima (refs duplicated), over query groups."""
    r = rng.uniform(-5, 5, size=(50, 3)).astype(np.float32)
    r = np.concatenate([r, r, r])                        # every row three times
    q = rng.uniform(-5, 5, size=(33, 3)).astype(np.float32)
    d, i = nn_kernels.nn1_reference(_t(q), _t(r))
    assert d.dtype == torch.float32 and i.dtype == torch.int32
    diff = q[:, None, :] - r[None]
    d_np = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]) + diff[..., 2] * diff[..., 2]
    np.testing.assert_array_equal(d.numpy(), d_np.min(1))
    np.testing.assert_array_equal(i.numpy(), d_np.argmin(1))
    assert (i.numpy() < 50).all()
    with pytest.raises(ValueError):
        nn_kernels.nn1(_t(q), torch.zeros((0, 3)))


def test_knn_dispatch_refusals(rng):
    """'band' runs knn_exact (equal on a cloud of 50, r_chunk ignored) and,
    as in pcr_tpu, needs query is ref; unknown methods raise."""
    x, mask = _data(rng, 3, n=50, pad=0)
    xt = _t(x)
    d, i = t_knn.knn(xt, xt, _t(mask), 4, method="band", r_chunk=64)
    d_e, i_e = t_knn.knn_exact(xt, xt, _t(mask), 4)
    np.testing.assert_array_equal(d.numpy()[mask], d_e.numpy()[mask])
    np.testing.assert_array_equal(i.numpy()[mask], i_e.numpy()[mask])
    with pytest.raises(ValueError):
        t_knn.knn(xt, _t(x), _t(mask), 4, method="band")
    with pytest.raises(ValueError):
        t_knn.knn(xt, xt, _t(mask), 4, method="kdtree")
    with pytest.raises(ValueError):
        t_knn.nn1(xt, xt, _t(mask), method="grid")


def _band_pair(x, mask, k, exclude_self, q_tile, band):
    """(port, pcr_tpu, knn_exact) results of the band self-kNN on x."""
    xj = jnp.asarray(x)
    d_j, i_j = j_knn.knn(xj, xj, jnp.asarray(mask), k, exclude_self=exclude_self,
                         method="band", q_tile=q_tile, band=band)
    xt = _t(x)
    d_t, i_t = t_knn.knn(xt, xt, _t(mask), k, exclude_self=exclude_self, method="band",
                         q_tile=q_tile, band=band, recall=0.5)
    d_e, i_e = t_knn.knn_exact(xt, xt, _t(mask), k, exclude_self=exclude_self)
    return (d_t.numpy(), i_t.numpy()), (np.asarray(d_j), np.asarray(i_j)), \
        (d_e.numpy(), i_e.numpy())


def _recall(i_a, i_b):
    return (i_a[:, :, None] == i_b[:, None, :]).any(axis=2).mean()


@pytest.mark.parametrize("exclude_self", [False, True])
def test_knn_band_matches_pcr_tpu(rng, exclude_self):
    """knn(method='band') against pcr_tpu's on a cloud whose every slab is
    the whole cloud (700 rows, band 512), where pcr_tpu's band search is
    exact: distances within 1e-6 relative (both select by the expanded d2
    and re-score exactly), index recall at least 0.999 (a tie may be listed
    either way), self excluded."""
    x, mask = _data(rng, 3, n=700, pad=60)
    (d_t, i_t), (d_j, i_j), _ = _band_pair(x, mask, 16, exclude_self, 128, 512)
    d_t, i_t, d_j, i_j = d_t[mask], i_t[mask], d_j[mask], i_j[mask]
    assert bool((d_t[:, 1:] >= d_t[:, :-1]).all())
    np.testing.assert_allclose(d_t, d_j, rtol=1e-6, atol=1e-9)
    assert _recall(i_t, i_j) >= 0.999
    rows = np.nonzero(mask)[0][:, None]
    assert (i_t == rows).any(axis=1).all() != exclude_self


@pytest.mark.parametrize("exclude_self", [False, True])
def test_knn_band_is_exact_where_pcr_tpu_misses(rng, exclude_self):
    """3000 rows in slabs of 2 * 256 (q_tile 128): pcr_tpu's slab, rounded
    down to a band block, leaves every tile in the upper half of a block no
    rows above it and misses neighbours (ROADMAP F7); the port's band kNN is
    knn_exact's, bit for bit, and agrees with pcr_tpu's wherever pcr_tpu's
    distances are knn_exact's (within 1e-6 relative, index recall at least
    0.999, as above)."""
    x, mask = _data(rng, 3, n=3000, pad=0)
    k = 24
    (d_t, i_t), (d_j, i_j), (d_e, i_e) = _band_pair(x, mask, k, exclude_self, 128, 256)
    d_t, i_t, d_j, i_j, d_e, i_e = (a[mask] for a in (d_t, i_t, d_j, i_j, d_e, i_e))
    np.testing.assert_array_equal(d_t, d_e)
    np.testing.assert_array_equal(i_t, i_e)
    pcr_exact = (np.abs(d_j - d_e) <= 1e-6 * d_e).all(axis=1)
    assert 0.1 < (~pcr_exact).mean() < 0.9                   # pcr_tpu misses neighbours
    np.testing.assert_allclose(d_t[pcr_exact], d_j[pcr_exact], rtol=1e-6, atol=1e-9)
    assert _recall(i_t[pcr_exact], i_j[pcr_exact]) >= 0.999
