"""K8 (FGR's GNC) and K9 (the pose graph's block-Thomas solve): the plain
versions of ``pcr_tpu_torch/ops/kernels/loop_kernels.py`` held against
pcr_tpu on the same numpy inputs, and the wrappers' CPU routing and
argument checks (the kernels themselves run in test_torch_kernels_cuda.py).

Tolerances, and why:
  * ``gnc_reference`` (behind the port's normalisation, ``fgr.gnc_inputs``
    and ``fgr.gnc_pose``) against ``pcr_tpu.models.fgr.
    fgr_from_correspondences``: 300 float32 Gauss-Newton steps, an LU solve
    in pcr_tpu and a Cholesky solve here, reductions in other orders:
    poses within 1e-4 (test_torch_fgr.py's bound); a pair with 2
    correspondences takes no step, so its normalised pose stays the
    identity exactly;
  * ``block_thomas_reference`` against pcr_tpu's ``_block_thomas_solve`` and
    a dense float64 solve: 1e-5 of the solution's largest entry
    (test_torch_pose_graph.py's bound): both are float32 eliminations of a
    well-conditioned system (diagonal blocks A A^T + 12 I);
  * the wrappers on CPU tensors run the plain versions: bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcr_tpu.models import fgr as j_fgr
from pcr_tpu.models.global_refine import pose_graph as j_pg
from pcr_tpu.utils import cloud as j_cloud
from pcr_tpu_torch.models import fgr as t_fgr
from pcr_tpu_torch.ops.kernels import loop_kernels as lk
from pcr_tpu_torch.utils import cloud as t_cloud

torch.set_num_threads(1)

CAPACITY = 256          # rows of each synthetic cloud (the last 16 padding)
MAX_CORR = 0.2          # maximum_correspondence_distance (2 x a 0.1 m voxel)


def _rot(axis, angle):
    a = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * K @ K


def _pair(seed: int, n_corr: int | None = None):
    """A source cloud of a 12 m scene, its target under a known motion with
    1 cm noise, correspondences i -> i (60% kept, a quarter of those
    outliers: their target row is another one's) as numpy arrays."""
    rng = np.random.default_rng(seed)
    n_valid = CAPACITY - 16
    src = np.zeros((CAPACITY, 3), np.float32)
    src[:n_valid] = rng.uniform([-6, -6, -1], [6, 6, 2], (n_valid, 3))
    R = _rot(rng.normal(size=3), rng.uniform(0.05, 0.3))
    t = rng.uniform(-1.0, 1.0, 3)
    tgt = np.zeros_like(src)
    tgt[:n_valid] = src[:n_valid] @ R.T + t + rng.normal(0, 0.01, (n_valid, 3))
    mask = np.arange(CAPACITY) < n_valid
    ci = np.arange(CAPACITY, dtype=np.int32)
    cj = ci.copy()
    out = rng.random(CAPACITY) < 0.25
    cj[out] = rng.integers(0, n_valid, int(out.sum()))
    cm = (rng.random(CAPACITY) < 0.6) & mask
    if n_corr is not None:
        cm[:] = False
        cm[:n_corr] = True
    return dict(src=src, tgt=tgt, mask=mask, ci=ci, cj=cj, cm=cm)


def _options(absolute: bool, decrease_mu: bool):
    return j_fgr.FgrOptions(use_absolute_scale=absolute, decrease_mu=decrease_mu,
                            maximum_correspondence_distance=MAX_CORR, iteration_number=300)


def _jax_pose(pr, opts):
    src = j_cloud.Cloud(points=jnp.asarray(pr["src"]), mask=jnp.asarray(pr["mask"]))
    tgt = j_cloud.Cloud(points=jnp.asarray(pr["tgt"]), mask=jnp.asarray(pr["mask"]))
    return np.asarray(j_fgr.fgr_from_correspondences(
        src, tgt, jnp.asarray(pr["ci"]), jnp.asarray(pr["cj"]), jnp.asarray(pr["cm"]), opts))


def _port_inputs(pairs, opts, batched: bool):
    """``fgr.gnc_inputs`` on CPU tensors: stacked over the pairs, or of the
    single pair unbatched."""
    def field(key):
        x = [torch.from_numpy(pr[key]) for pr in pairs]
        return torch.stack(x) if batched else x[0]

    src = t_cloud.Cloud(points=field("src"), mask=field("mask"))
    tgt = t_cloud.Cloud(points=field("tgt"), mask=field("mask"))
    return t_fgr.gnc_inputs(src, tgt, field("ci"), field("cj"), field("cm"),
                            t_fgr.FgrOptions(*opts))


def _gnc_reference(inp, opts):
    return lk.gnc_reference(inp.p, inp.q, inp.w, inp.mu0, inp.delta, inp.enough,
                            opts.iteration_number, opts.division_factor, opts.decrease_mu)


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("decrease_mu", [True, False], ids=["decrease_mu", "fixed_mu"])
@pytest.mark.parametrize("absolute", [False, True], ids=["relative", "absolute"])
def test_gnc_reference_matches_pcr_tpu(absolute, decrease_mu, batch):
    opts = _options(absolute, decrease_mu)
    pairs = [_pair(10 * batch + b) for b in range(batch)]
    inp = _port_inputs(pairs, opts, batched=batch > 1)
    T_hat = _gnc_reference(inp, opts)
    assert T_hat.shape == ((batch,) if batch > 1 else ()) + (4, 4)
    poses = t_fgr.gnc_pose(T_hat, inp).reshape(batch, 4, 4).numpy()
    for b, pr in enumerate(pairs):
        np.testing.assert_allclose(poses[b], _jax_pose(pr, opts), atol=1e-4)


@pytest.mark.parametrize("absolute", [False, True], ids=["relative", "absolute"])
def test_gnc_reference_keeps_the_identity_below_three_correspondences(absolute):
    opts = _options(absolute, True)
    pairs = [_pair(5), _pair(6, n_corr=2)]
    inp = _port_inputs(pairs, opts, batched=True)
    assert inp.enough.tolist() == [True, False]
    T_hat = _gnc_reference(inp, opts)
    assert torch.equal(T_hat[1], torch.eye(4))
    assert not torch.equal(T_hat[0], torch.eye(4))
    poses = t_fgr.gnc_pose(T_hat, inp).numpy()
    for b, pr in enumerate(pairs):
        np.testing.assert_allclose(poses[b], _jax_pose(pr, opts), atol=1e-4)


def _tridiagonal(m: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, 6, 6)).astype(np.float32)
    D = (np.einsum("mij,mkj->mik", A, A) + 12 * np.eye(6)).astype(np.float32)
    U = (0.3 * rng.normal(size=(m - 1, 6, 6))).astype(np.float32)
    rhs = rng.normal(size=(m, 6)).astype(np.float32)
    return D, U, rhs


@pytest.mark.parametrize("m", [1, 2, 7, 40])
def test_block_thomas_reference_matches_pcr_tpu_and_a_dense_solve(m):
    D, U, rhs = _tridiagonal(m)
    got = lk.block_thomas_reference(*map(torch.from_numpy, (D, U, rhs))).numpy()
    want = np.asarray(j_pg._block_thomas_solve(jnp.asarray(D), jnp.asarray(U),
                                                jnp.asarray(rhs)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    dense = np.zeros((6 * m, 6 * m))
    for j in range(m):
        dense[6 * j:6 * j + 6, 6 * j:6 * j + 6] = D[j]
        if j < m - 1:
            dense[6 * j:6 * j + 6, 6 * j + 6:6 * j + 12] = U[j]
            dense[6 * j + 6:6 * j + 12, 6 * j:6 * j + 6] = U[j].T
    exact = np.linalg.solve(dense, rhs.reshape(-1).astype(np.float64)).reshape(m, 6)
    np.testing.assert_allclose(got, exact, atol=1e-5 * np.abs(exact).max())


def _gnc_args(batched: bool):
    opts = _options(False, True)
    inp = _port_inputs([_pair(1), _pair(2)] if batched else [_pair(1)], opts, batched)
    return (inp.p, inp.q, inp.w, inp.mu0, inp.delta, inp.enough, 300, 1.4, True)


@pytest.mark.parametrize("batched", [False, True], ids=["one_pair", "batch_2"])
def test_gnc_wrapper_on_cpu_is_the_plain_version(batched):
    args = _gnc_args(batched)
    before = dict(lk.LAUNCHES)
    assert torch.equal(lk.gnc(*args), lk.gnc_reference(*args))
    assert lk.LAUNCHES == before                       # no kernel on CPU tensors


@pytest.mark.parametrize("m", [1, 7])
def test_block_thomas_wrapper_on_cpu_is_the_plain_version(m):
    args = tuple(map(torch.from_numpy, _tridiagonal(m)))
    before = dict(lk.LAUNCHES)
    assert torch.equal(lk.block_thomas(*args), lk.block_thomas_reference(*args))
    assert lk.LAUNCHES == before


def _swap(args, i, value):
    return args[:i] + (value,) + args[i + 1:]


GNC_REFUSALS = {
    "p_float64": (lambda a: _swap(a, 0, a[0].double()), TypeError),
    "q_wrong_shape": (lambda a: _swap(a, 1, a[1][:, :-1].contiguous()), ValueError),
    "p_not_contiguous": (lambda a: _swap(a, 0, a[0].transpose(0, 1).contiguous()
                                         .transpose(0, 1)), ValueError),
    "w_float64": (lambda a: _swap(a, 2, a[2].double()), TypeError),
    "delta_wrong_shape": (lambda a: _swap(a, 4, a[4][:1].contiguous()), ValueError),
    "enough_not_bool": (lambda a: _swap(a, 5, a[5].float()), TypeError),
    "two_batch_dims": (lambda a: tuple(x[None] if torch.is_tensor(x) else x for x in a),
                       ValueError),
    "negative_iterations": (lambda a: _swap(a, 6, -1), ValueError),
}


@pytest.mark.parametrize("case", sorted(GNC_REFUSALS))
def test_gnc_wrapper_refuses(case):
    make, error = GNC_REFUSALS[case]
    args = make(_gnc_args(batched=True))
    with pytest.raises(error):
        lk.gnc(*args)


THOMAS_REFUSALS = {
    "D_float64": (lambda D, U, r: (D.double(), U, r), TypeError),
    "U_wrong_count": (lambda D, U, r: (D, torch.cat([U, U[:1]]), r), ValueError),
    "rhs_not_contiguous": (lambda D, U, r: (D, U, r.T.contiguous().T), ValueError),
    "rhs_float64": (lambda D, U, r: (D, U, r.double()), TypeError),
    "D_not_6x6": (lambda D, U, r: (D[:, :, :5].contiguous(), U, r), ValueError),
    "m_zero": (lambda D, U, r: (D[:0], U[:0], r[:0]), ValueError),
}


@pytest.mark.parametrize("case", sorted(THOMAS_REFUSALS))
def test_block_thomas_wrapper_refuses(case):
    make, error = THOMAS_REFUSALS[case]
    args = make(*map(torch.from_numpy, _tridiagonal(7)))
    with pytest.raises(error):
        lk.block_thomas(*args)
