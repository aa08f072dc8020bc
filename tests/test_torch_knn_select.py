"""K13's plain version (``ops/kernels/nn_kernels.knn_select_reference``)
against a float64 NumPy brute force, and ``ops/knn.knn_exact``'s CPU route
(the plain version at D = 3).

The plain version keys every pair by (d2, index), d2 the f32 rounded
((dx*dx + dy*dy) + dz*dz), BIG for a masked ref and, with exclude_self, for
the query's own row, and keeps each row's k smallest keys.  Against the
float64 brute force: d2 within RTOL (each of the formula's eight f32
operations rounds once, so its relative error stays below ~5 * 2^-24 < RTOL)
and indices equal wherever the float64 distances are further apart than
that; on a lattice, where every d2 is exact in both precisions, indices and
d2 equal outright, exact ties going to the smaller index.

The CUDA kernel itself is held to this plain version on the card
(tests/test_torch_kernels_cuda.py), and the plain version to pcr_tpu's
knn_exact in tests/test_torch_knn.py.
"""

import numpy as np
import pytest
import torch

from pcr_tpu_torch.ops import knn
from pcr_tpu_torch.ops.kernels import common, nn_kernels
from pcr_tpu_torch.utils.cloud import PAD_COORD

torch.set_num_threads(1)
RTOL = 1e-6


def _cloud(rng, n: int, pad: int = 40, masked: float = 0.1):
    """(points (n + pad, 3) f32, mask): a flattened 40 m slab with ``masked``
    of the real rows masked off, then ``pad`` PAD_COORD rows (masked)."""
    x = rng.uniform(-20, 20, size=(n, 3)).astype(np.float32)
    x[:, 2] *= 0.2
    x = np.concatenate([x, np.full((pad, 3), PAD_COORD, np.float32)])
    mask = np.concatenate([rng.random(n) >= masked, np.zeros(pad, bool)])
    return x, mask


def _brute(q, r, mask, k: int, exclude_self: bool):
    """float64 (d2 (nq, k), index (nq, k)): each row's k smallest d2 over the
    valid refs (the query's own row dropped), ties and the invalid refs
    (inf) ordered by index; inf where a slot holds no valid ref."""
    d = ((q[:, None, :].astype(np.float64) - r[None, :, :].astype(np.float64)) ** 2).sum(-1)
    bad = np.broadcast_to(~mask[None, :], d.shape).copy()
    if exclude_self:
        bad |= np.arange(len(q))[:, None] == np.arange(len(r))[None, :]
    d[bad] = np.inf
    order = np.argsort(d, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(d, order, axis=1), order


def _plain(q, r, mask, k: int, exclude_self: bool):
    d, i = nn_kernels.knn_select_reference(torch.from_numpy(q), torch.from_numpy(r),
                                           torch.from_numpy(mask), k,
                                           exclude_self=exclude_self)
    return d.numpy(), i.numpy()


def _assert_matches_brute(d, i, d64, i64):
    """d2 within RTOL of the float64 one (BIG where it has no valid ref);
    indices equal wherever the float64 d2 is apart from its row neighbours."""
    real = np.isfinite(d64)
    np.testing.assert_array_equal(d >= common.BIG, ~real)
    np.testing.assert_allclose(d[real], d64[real], rtol=RTOL, atol=1e-9)
    padded = np.pad(d64, ((0, 0), (1, 1)), constant_values=np.inf)
    tol = 2 * RTOL * np.where(real, d64, 0.0) + 1e-9
    with np.errstate(invalid="ignore"):              # inf - inf past the valid refs
        apart = ((padded[:, 1:-1] - padded[:, :-2] > tol)
                 & (padded[:, 2:] - padded[:, 1:-1] > tol))
    apart |= ~real                       # the invalid slots: ascending masked indices
    np.testing.assert_array_equal(i[apart], i64[apart])


def _assert_rows_ascending(d, i):
    """Every row strictly ascending by the (d2, index) key."""
    nxt_d, nxt_i = d[:, 1:], i[:, 1:]
    assert bool(((d[:, :-1] < nxt_d) | ((d[:, :-1] == nxt_d) & (i[:, :-1] < nxt_i))).all())


@pytest.mark.parametrize("exclude_self", [False, True])
@pytest.mark.parametrize("k", [1, 20, 200])
def test_plain_matches_float64_self(k, exclude_self):
    """Self k-NN of a padded cloud (query is ref), as fgr_features calls it."""
    x, mask = _cloud(np.random.default_rng(k), 600)
    d, i = _plain(x, x, mask, k, exclude_self)
    d64, i64 = _brute(x, x, mask, k, exclude_self)
    _assert_matches_brute(d, i, d64, i64)
    _assert_rows_ascending(d, i)
    if exclude_self:
        assert not bool((i == np.arange(len(x))[:, None])[d < common.BIG].any())


@pytest.mark.parametrize("exclude_self", [False, True])
@pytest.mark.parametrize("k", [1, 20, 200])
def test_plain_matches_float64_other_cloud(k, exclude_self):
    """Queries that are another cloud than the refs, nq != nr."""
    rng = np.random.default_rng(100 + k)
    r, mask = _cloud(rng, 500)
    q = rng.uniform(-22, 22, size=(333, 3)).astype(np.float32)
    d, i = _plain(q, r, mask, k, exclude_self)
    _assert_matches_brute(d, i, *_brute(q, r, mask, k, exclude_self))
    _assert_rows_ascending(d, i)


@pytest.mark.parametrize("exclude_self", [False, True])
def test_plain_fewer_valid_refs_than_k(exclude_self):
    """30 valid refs at k = 200: the valid ones first, then BIG with the
    smallest masked indices (and the query's own row) ascending."""
    rng = np.random.default_rng(7)
    x, mask = _cloud(rng, 250, pad=10, masked=0.0)
    mask[:] = False
    valid = rng.choice(250, size=30, replace=False)
    mask[valid] = True
    d, i = _plain(x, x, mask, 200, exclude_self)
    d64, i64 = _brute(x, x, mask, 200, exclude_self)
    _assert_matches_brute(d, i, d64, i64)
    for row in (int(valid[0]), int(np.flatnonzero(~mask)[0])):
        n_real = 29 if exclude_self and mask[row] else 30
        assert bool((d[row, :n_real] < common.BIG).all())
        rest = np.flatnonzero(~mask | (exclude_self & (np.arange(len(x)) == row)))
        np.testing.assert_array_equal(i[row, n_real:], rest[:200 - n_real])
        assert bool((d[row, n_real:] == common.BIG).all())


def test_plain_all_refs_masked():
    """No valid ref: every slot BIG, the indices 0 .. k-1."""
    x, _ = _cloud(np.random.default_rng(3), 100)
    d, i = _plain(x, x, np.zeros(len(x), bool), 20, True)
    assert bool((d == common.BIG).all())
    np.testing.assert_array_equal(i, np.broadcast_to(np.arange(20), i.shape))


def test_plain_k_above_nr():
    """k above the refs: the slots past nr take (BIG, 0)."""
    rng = np.random.default_rng(4)
    r = rng.uniform(-1, 1, size=(12, 3)).astype(np.float32)
    q = rng.uniform(-1, 1, size=(5, 3)).astype(np.float32)
    d, i = _plain(q, r, np.ones(12, bool), 20, False)
    _assert_matches_brute(d[:, :12], i[:, :12], *_brute(q, r, np.ones(12, bool), 12, False))
    assert bool((d[:, 12:] == common.BIG).all()) and bool((i[:, 12:] == 0).all())


@pytest.mark.parametrize("exclude_self", [False, True])
@pytest.mark.parametrize("k", [1, 20, 200])
def test_plain_exact_ties_go_to_the_smaller_index(k, exclude_self):
    """On a 0.5 m lattice with every row repeated further on (d2 exact in
    f32 and f64, equal d2 everywhere), d2 and indices equal the float64
    brute force's (d2, index) order outright."""
    rng = np.random.default_rng(11 + k)
    x = rng.integers(-6, 6, size=(300, 3)).astype(np.float32) * 0.5
    x = np.concatenate([x, x[::-1][:150]])
    mask = rng.random(len(x)) > 0.05
    d, i = _plain(x, x, mask, k, exclude_self)
    d64, i64 = _brute(x, x, mask, k, exclude_self)
    real = np.isfinite(d64)
    np.testing.assert_array_equal(d[real], d64[real].astype(np.float32))
    np.testing.assert_array_equal(i, i64)
    _assert_rows_ascending(d, i)


def test_knn_select_routes_cpu_tensors_to_the_plain_version():
    """The wrapper on CPU tensors returns the plain version's rows, and
    refuses what the kernel refuses: an empty ref, float64, D = 33 and k
    above KNN_MAX_K."""
    x, mask = _cloud(np.random.default_rng(5), 200)
    t, m = torch.from_numpy(x), torch.from_numpy(mask)
    d, i = nn_kernels.knn_select(t, t, m, 20, exclude_self=True)
    d_p, i_p = nn_kernels.knn_select_reference(t, t, m, 20, exclude_self=True)
    assert torch.equal(d, d_p) and torch.equal(i, i_p)
    with pytest.raises(ValueError):
        nn_kernels.knn_select(t, t[:0], m[:0], 20)
    with pytest.raises(TypeError):
        nn_kernels.knn_select(t.double(), t.double(), m, 20)
    f = torch.zeros(len(x), 33)
    with pytest.raises(ValueError):
        nn_kernels.knn_select(f, f, m, 20)
    with pytest.raises(ValueError):
        nn_kernels.knn_select(t, t, m, nn_kernels.KNN_MAX_K + 1)


def test_knn_exact_on_cpu_runs_the_plain_version(monkeypatch):
    """On CPU tensors knn_exact of 3-D points runs K13's plain version,
    through the wrapper, and never the tiled selection; 33-dim rows (FPFH)
    run knn_tiled."""
    def refuse(*args, **kw):
        raise AssertionError("knn_tiled ran on 3-D points")

    x, mask = _cloud(np.random.default_rng(6), 300)
    t, m = torch.from_numpy(x), torch.from_numpy(mask)
    f = torch.from_numpy(np.random.default_rng(7).uniform(0, 200, (len(x), 33))
                         .astype(np.float32))
    d_f, i_f = knn.knn_exact(f, f, m, 30, exclude_self=True, q_tile=128)
    d_ft, i_ft = knn.knn_tiled(f, f, m, 30, exclude_self=True, q_tile=128)
    assert torch.equal(d_f, d_ft) and torch.equal(i_f, i_ft)
    monkeypatch.setattr(knn, "knn_tiled", refuse)
    d, i = knn.knn_exact(t, t, m, 30, exclude_self=True, q_tile=128)
    d_p, i_p = nn_kernels.knn_select_reference(t, t, m, 30, exclude_self=True)
    assert torch.equal(d, d_p) and torch.equal(i, i_p)
    d64, i64 = _brute(x, x, mask, 30, True)
    _assert_matches_brute(d.numpy(), i.numpy(), d64, i64)
