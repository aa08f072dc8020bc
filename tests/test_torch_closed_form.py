"""Stage 3a: pcr_tpu_torch.models.global_refine.closed_form (SLERP, LUM,
SLERP+LUM) and the trajectory scores of models/evaluate, held against
pcr_tpu on the same numpy inputs.

Tolerances:
  * numpy inputs run the same float64 operations in the same order in both
    packages: 1e-9 on the 901 refined NCLT relative
    poses of outputs/NCLT_poses.npz, 1e-12 on short circuits;
  * against the file's own absolute_LUM / absolute_SLERP /
    absolute_SLERP_LUM: 1e-6 (pcr_tpu itself is at 1.8e-7, the file's
    inputs were rounded to 10 decimals when they were written);
  * torch float32 tensors against pcr_tpu's jnp float32 paths on a 20-link
    circuit: 1e-5 (float32 round-off of metre-scale chains);
  * circuit_edge_consistency of the file's trajectories against
    outputs/metrics/NCLT/stage3_consistency.json: 1e-6 (the json was
    written from the unrounded poses).
The synthetic twins of tests/test_global_refine.py keep that file's own
tolerances."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcr_tpu.models import evaluate as j_eval
from pcr_tpu.models.global_refine import closed_form as j_cf
from pcr_tpu.utils import se3 as j_se3
from pcr_tpu_torch.models import evaluate as t_eval
from pcr_tpu_torch.models.global_refine import closed_form as t_cf
from pcr_tpu_torch.utils import quaternion as t_quat
from pcr_tpu_torch.utils import se3 as t_se3
from tests.conftest import random_rotation
from tests.test_global_refine import make_circuit, np_lum_oracle

torch.set_num_threads(1)

METHODS = ["refine_lum", "refine_slerp", "refine_slerp_lum"]
FILE_KEY = {"refine_lum": "absolute_LUM", "refine_slerp": "absolute_SLERP",
            "refine_slerp_lum": "absolute_SLERP_LUM"}


@pytest.fixture(scope="module")
def nclt():
    return dict(np.load("outputs/NCLT_poses.npz"))


@pytest.mark.parametrize("method", METHODS)
def test_closed_forms_on_the_nclt_circuit(nclt, method):
    rel = nclt["relative_FGR_GICP"]
    got = getattr(t_cf, method)(rel)
    assert isinstance(got, np.ndarray) and got.dtype == np.float64 and got.shape == (901, 4, 4)
    np.testing.assert_allclose(got, np.asarray(getattr(j_cf, method)(rel)), atol=1e-9)
    np.testing.assert_allclose(got, nclt[FILE_KEY[method]], atol=1e-6)


@pytest.mark.parametrize("method", METHODS)
def test_closed_forms_torch_f32_match_jnp(rng, method):
    T_rel = make_circuit(rng, 20, noise_rot=0.01, noise_t=0.05).astype(np.float32)
    got = getattr(t_cf, method)(torch.as_tensor(T_rel))
    assert got.dtype == torch.float32
    want = np.asarray(getattr(j_cf, method)(jnp.asarray(T_rel)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_weighted_lum_and_sigma0_match(rng):
    """Non-uniform weights through both packages (numpy and torch float32),
    and return_sigma0's variance factor against pcr_tpu's
    lum_posterior_variance on the same solve.  (pcr_tpu's refine_lum takes
    return_sigma0 but returns the poses alone.)"""
    T_rel = make_circuit(rng, 15, noise_rot=0.01, noise_t=0.05)
    w = rng.uniform(0.5, 2.0, size=15)
    got, sigma0 = t_cf.refine_lum(T_rel, weights=w, return_sigma0=True)
    np.testing.assert_allclose(got, np.asarray(j_cf.refine_lum(T_rel, weights=w)), atol=1e-12)
    R_abs = j_se3.chain_rotations_ref(j_se3.rot(T_rel))
    X = j_cf._lum_solve(T_rel, R_abs, w)
    np.testing.assert_allclose(sigma0, j_cf.lum_posterior_variance(T_rel, X, R_abs, w),
                               rtol=1e-12)
    assert sigma0 > 0
    T32, w32 = T_rel.astype(np.float32), w.astype(np.float32)
    got32, s32 = t_cf.refine_lum(torch.as_tensor(T32), weights=torch.as_tensor(w32),
                                 return_sigma0=True)
    np.testing.assert_allclose(got32.numpy(), np.asarray(
        j_cf.refine_lum(jnp.asarray(T32), weights=jnp.asarray(w32))), atol=1e-5)
    np.testing.assert_allclose(s32, sigma0, rtol=1e-3)


# --- twins of tests/test_global_refine.py:71-155 ----------------------------

def test_lum_matches_dense_oracle(rng):
    T_rel = make_circuit(rng, 12, noise_t=0.05)
    np.testing.assert_allclose(t_cf.refine_lum(T_rel), np_lum_oracle(T_rel), atol=1e-8)


def test_lum_perfect_circuit_reproduces_chain(rng):
    T_rel = make_circuit(rng, 10)
    np.testing.assert_allclose(t_cf.refine_lum(T_rel), t_se3.relative_to_absolute(T_rel),
                               atol=1e-6)


def test_slerp_perfect_circuit_identity_rotations(rng):
    T_rel = make_circuit(rng, 8)
    out = t_cf.refine_slerp(T_rel)
    chained = t_se3.relative_to_absolute(T_rel)
    np.testing.assert_allclose(out[:, :3, :3], chained[:, :3, :3], atol=1e-4)
    assert np.abs(out[0] - np.eye(4)).max() < 1e-6


def test_slerp_distributes_closure_error(rng):
    T_rel = make_circuit(rng, 20, noise_rot=0.01)
    raw_closure = t_se3.loop_closure_error(T_rel)
    out = t_cf.refine_slerp(T_rel)
    R_err_raw = np.linalg.norm(raw_closure[:3, :3] - np.eye(3))
    R_err_adj = np.linalg.norm(T_rel[-1][:3, :3] @ out[-1][:3, :3] - np.eye(3))
    assert R_err_adj < R_err_raw * 0.6, (R_err_adj, R_err_raw)


def test_slerp_lum_perfect_circuit(rng):
    T_rel = make_circuit(rng, 10)
    np.testing.assert_allclose(t_cf.refine_slerp_lum(T_rel), t_se3.relative_to_absolute(T_rel),
                               atol=1e-4)


def test_weighted_lum_matches_unweighted_for_uniform(rng):
    T_rel = make_circuit(rng, 9, noise_t=0.02)
    np.testing.assert_allclose(t_cf.refine_lum(T_rel), t_cf.refine_lum(T_rel, weights=np.ones(9)),
                               atol=1e-8)


def test_slerp_chain_f64_host_path(rng):
    """901-link quaternion chains run in float64 on host input: the adjusted
    rotations stay orthonormal to 1e-12, and node 1 tracks the raw product
    up to ~closure_angle/n."""
    n = 901
    T = np.tile(np.eye(4), (n, 1, 1))
    for i in range(n):
        w = rng.normal(size=3) * 0.02
        a = np.linalg.norm(w)
        K = np.cross(np.eye(3), w / a)                # float64 Rodrigues
        T[i, :3, :3] = np.eye(3) + np.sin(a) * K + (1 - np.cos(a)) * K @ K
        T[i, :3, 3] = rng.normal(size=3) * 0.01
    out = t_cf.refine_slerp(T)
    assert out.dtype == np.float64
    RtR = np.einsum("nij,nik->njk", out[:, :3, :3], out[:, :3, :3])
    assert np.abs(RtR - np.eye(3)).max() < 1e-12
    q_adj = t_cf.slerp_adjust_quaternions(t_cf._rel_quaternions(T))
    np.testing.assert_allclose(q_adj, np.asarray(j_cf.slerp_adjust_quaternions(
        j_cf._rel_quaternions(T))), atol=1e-12)
    np.testing.assert_allclose(t_quat.as_rotation_matrix(q_adj[1]), T[0, :3, :3], atol=5e-3)


# --- twins of tests/test_global_refine.py:456-540 ---------------------------

def test_refine_slerp_matches_reference_transcription(rng):
    """A literal loop-for-loop transcription of the reference's
    ``Ajustamento_Quaternios_SLERP`` and ``reconstruir_Ts_para_origem_SLERP``
    (port quaternions): 1e-8, and the same closure-edge residual."""
    n = 16
    T_rel = make_circuit(rng, n, noise_rot=0.02, noise_t=0.05)

    def oracle(T):
        m = len(T)
        qs = [t_quat.from_rotation_matrix(np.asarray(T[i][:3, :3], np.float64))
              for i in range(m)]
        fwd, rev_inv = [], []
        acc = np.array([1.0, 0, 0, 0])
        acc_rev = np.array([1.0, 0, 0, 0])
        for i in range(1, m):
            acc = t_quat.qmul(qs[i - 1], acc)
            acc_rev = t_quat.qmul(acc_rev, qs[-i])
            fwd.append(acc.copy())
            rev_inv.append(t_quat.qinv(acc_rev))
        slerped = [np.array([1.0, 0, 0, 0])]
        for i in range(1, m):
            slerped.append(t_quat.slerp(fwd[i - 1], rev_inv[-i], np.float64(i / m)))
        poses, t = [], np.zeros(3)
        for i in range(m):
            R = t_quat.as_rotation_matrix(slerped[i])
            P = np.eye(4)
            P[:3, :3] = R
            P[:3, 3] = t
            poses.append(P)
            t = R @ np.asarray(T[i][:3, 3], np.float64) + t
        return np.stack(poses)

    ours = t_cf.refine_slerp(T_rel)
    ref = oracle(T_rel)
    np.testing.assert_allclose(ours, ref, atol=1e-8)
    np.testing.assert_allclose(t_eval.circuit_edge_consistency(ours, T_rel)["dt_closure_edge_m"],
                               t_eval.circuit_edge_consistency(ref, T_rel)["dt_closure_edge_m"],
                               rtol=1e-9)


def test_circuit_edge_consistency_rejects_unknown_convention(rng):
    rel = make_circuit(rng, 5)
    A = t_se3.relative_to_absolute(rel)
    with pytest.raises(ValueError, match="convention"):
        t_eval.circuit_edge_consistency(A, rel, convention="std")


def test_aligned_ate_gauge_invariance(rng):
    """Aligned ATE ignores a global rigid transform of the trajectory, is 0
    for a trajectory equal to its target up to it, keeps a bend, and equals
    pcr_tpu's to 1e-12."""
    n = 40
    target = np.stack([np.eye(4)] * n)
    target[:, :3, 3] = rng.normal(size=(n, 3)) * 5.0
    G = np.eye(4)
    G[:3, :3] = random_rotation(rng)
    G[:3, 3] = rng.normal(size=3) * 100.0
    moved = np.einsum("ij,njk->nik", G, target)
    _, dt_raw = t_se3.pose_errors(moved, target)
    assert float(dt_raw.mean()) > 10.0
    a = t_eval.aligned_ate(moved, target)
    assert a["rmse_m"] < 1e-6 and a["max_m"] < 1e-6
    bent = target.copy()
    bent[: n // 2, :3, 3] += np.asarray([3.0, 0.0, 0.0])
    got = t_eval.aligned_ate(bent, target)
    assert got["rmse_m"] > 0.5
    want = j_eval.aligned_ate(bent, target)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-12)


# --- circuit_edge_consistency on the file's trajectories ----------------------

CONSISTENCY = {
    "raw_chain": (lambda z: t_se3.relative_to_absolute(z["relative_FGR_GICP"]), "reference"),
    "raw_chain_standard": (lambda z: t_se3.relative_to_absolute_standard(z["relative_FGR_GICP"]),
                           "standard"),
    "LUM": (lambda z: z["absolute_LUM"], "reference"),
    "SLERP": (lambda z: z["absolute_SLERP"], "reference"),
    "SLERP_LUM": (lambda z: z["absolute_SLERP_LUM"], "reference"),
    "pose_graph": (lambda z: z["absolute_pose_graph"], "standard"),
}


@pytest.mark.parametrize("entry", list(CONSISTENCY))
def test_consistency_reproduces_the_nclt_stage3_record(nclt, entry):
    """Each entry of outputs/metrics/NCLT/stage3_consistency.json from the
    trajectories in outputs/NCLT_poses.npz, scored in the entry's
    convention: 1e-6; and the port's per-edge arrays equal pcr_tpu's."""
    with open("outputs/metrics/NCLT/stage3_consistency.json") as fh:
        record = json.load(fh)[entry]
    trajectory, convention = CONSISTENCY[entry]
    A, rel = trajectory(nclt), nclt["relative_FGR_GICP"]
    got = t_eval.circuit_edge_consistency(A, rel, convention=convention)
    for key, value in record.items():
        if isinstance(value, float):
            np.testing.assert_allclose(got[key], value, atol=1e-6, err_msg=key)
    want = j_eval.circuit_edge_consistency(A, rel, convention=convention)
    for key in ("dR", "dt"):
        np.testing.assert_allclose(got[key], want[key], atol=1e-12)
