"""pcr_tpu_torch.utils.quaternion and the se3 pose-chain functions held
against pcr_tpu on the same numpy inputs.

Tolerances: the numpy paths are float64 in both packages and run the same
operations in the same order, so they agree to 1e-12 (1e-9 for the 901-link
chains, whose products reach hundreds of metres).  The torch float32 paths
are held to pcr_tpu's jnp float32 paths at float32 round-off: 1e-5 on unit
quaternions and rotations (a few ulp of 1 through a dozen operations), and
on chains 1e-5 relative to the largest translation (the doubling scan and
``jax.lax.associative_scan`` group the same products differently)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcr_tpu.utils import quaternion as j_quat
from pcr_tpu.utils import se3 as j_se3
from pcr_tpu_torch.utils import quaternion as t_quat
from pcr_tpu_torch.utils import se3 as t_se3
from tests.conftest import random_rotation

torch.set_num_threads(1)


def _rotations(rng, n):
    R = np.stack([random_rotation(rng) for _ in range(n)])
    # the Shepperd branches: near identity, near pi about each axis
    R[0] = np.eye(3)
    for k, axis in enumerate(np.eye(3)):
        K = np.cross(np.eye(3), axis)                     # skew(axis), float64
        a = np.pi * 0.999
        R[1 + k] = np.eye(3) + np.sin(a) * K + (1 - np.cos(a)) * K @ K
    return R


def _quats(rng, n):
    q = rng.normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _poses(rng, n, t_scale=1.0):
    T = np.tile(np.eye(4), (n, 1, 1))
    T[:, :3, :3] = np.stack([random_rotation(rng) for _ in range(n)])
    T[:, :3, 3] = rng.normal(scale=t_scale, size=(n, 3))
    return T


def test_quaternion_f64_paths_match(rng):
    """Every function's numpy path equals pcr_tpu's to 1e-12."""
    R = _rotations(rng, 40)
    q1, q2 = _quats(rng, 40), _quats(rng, 40)
    q2[:5] = q1[:5] * (1 + 1e-9)                       # the nearly-parallel lerp branch
    v = rng.normal(size=(40, 3))
    t = rng.uniform(size=40)
    pairs = [
        (t_quat.qmul(q1, q2), j_quat.qmul(q1, q2)),
        (t_quat.qconj(q1), j_quat.qconj(q1)),
        (t_quat.qinv(3 * q1), j_quat.qinv(3 * q1)),
        (t_quat.qnormalize(3 * q1), j_quat.qnormalize(3 * q1)),
        (t_quat.from_rotation_matrix(R), j_quat.from_rotation_matrix(R)),
        (t_quat.as_rotation_matrix(q1), j_quat.as_rotation_matrix(q1)),
        (t_quat.slerp(q1, q2, t), j_quat.slerp(q1, q2, t)),
        (t_quat.rotate(q1, v), j_quat.rotate(q1, v)),
    ]
    for got, want in pairs:
        assert isinstance(got, np.ndarray) and got.dtype == np.float64
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-12)
    np.testing.assert_allclose(t_quat.as_rotation_matrix(t_quat.from_rotation_matrix(R)), R,
                               atol=1e-12)


def test_quaternion_torch_f32_matches_jnp(rng):
    """The torch paths (float32 tensors) against pcr_tpu's jnp float32 paths."""
    R = _rotations(rng, 40).astype(np.float32)
    q1, q2 = _quats(rng, 40).astype(np.float32), _quats(rng, 40).astype(np.float32)
    v = rng.normal(size=(40, 3)).astype(np.float32)
    t = rng.uniform(size=40).astype(np.float32)
    T = torch.as_tensor
    J = jnp.asarray
    pairs = [
        (t_quat.qmul(T(q1), T(q2)), j_quat.qmul(J(q1), J(q2))),
        (t_quat.qinv(T(q1)), j_quat.qinv(J(q1))),
        (t_quat.from_rotation_matrix(T(R)), j_quat.from_rotation_matrix(J(R))),
        (t_quat.as_rotation_matrix(T(q1)), j_quat.as_rotation_matrix(J(q1))),
        (t_quat.slerp(T(q1), T(q2), T(t)), j_quat.slerp(J(q1), J(q2), J(t))),
        (t_quat.slerp(T(q1), T(q2), 0.25), j_quat.slerp(J(q1), J(q2), 0.25)),
        (t_quat.rotate(T(q1), T(v)), j_quat.rotate(J(q1), J(v))),
    ]
    for got, want in pairs:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    ident = t_quat.qidentity()
    assert ident.dtype == torch.float32 and ident.tolist() == [1.0, 0.0, 0.0, 0.0]


def test_so3_log_uses_the_quaternion_module(rng):
    """se3.so3_log goes through quaternion.from_rotation_matrix (one
    Shepperd implementation) and inverts so3_exp at every branch."""
    assert not hasattr(t_se3, "_quat_from_rotation_matrix")
    R = _rotations(rng, 30).astype(np.float32)
    w = t_se3.so3_log(torch.as_tensor(R))
    np.testing.assert_allclose(w.numpy(), np.asarray(j_se3.so3_log(jnp.asarray(R))), atol=1e-4)
    np.testing.assert_allclose(t_se3.so3_exp(w).numpy(), R, atol=1e-5)


CHAINS = ["relative_to_absolute", "relative_to_absolute_standard", "loop_closure_error",
          "absolute_to_relative", "absolute_to_relative_circuit"]


@pytest.mark.parametrize("name", CHAINS)
def test_pose_chains_f64_on_the_nclt_circuit(name):
    """The 901 refined NCLT relative poses (and the file's LUM trajectory
    for the absolute -> relative recoveries) through both packages' float64
    host paths: 1e-9."""
    z = np.load("outputs/NCLT_poses.npz")
    arg = z["absolute_LUM"] if name.startswith("absolute") else z["relative_FGR_GICP"]
    got = getattr(t_se3, name)(arg)
    assert isinstance(got, np.ndarray) and got.dtype == np.float64
    np.testing.assert_allclose(got, np.asarray(getattr(j_se3, name)(arg)), atol=1e-9)


def test_chain_rotations_ref_is_the_reversed_chain(rng):
    """out[0] = I, out[i] = R_{i-1} @ ... @ R_0 (the reference's reversed
    order), and it equals pcr_tpu's; _rev_matmul_scan likewise."""
    Rs = np.stack([random_rotation(rng) for _ in range(12)])
    got = t_se3.chain_rotations_ref(Rs)
    np.testing.assert_allclose(got, np.asarray(j_se3.chain_rotations_ref(Rs)), atol=1e-12)
    acc = np.eye(3)
    for i in range(12):
        np.testing.assert_allclose(got[i], acc, atol=1e-12)
        acc = Rs[i] @ acc
    np.testing.assert_allclose(t_se3._rev_matmul_scan(Rs),
                               np.asarray(j_se3._rev_matmul_scan(Rs)), atol=1e-12)


@pytest.mark.parametrize("name", CHAINS + ["chain_rotations_ref"])
def test_pose_chains_torch_f32_match_jnp(rng, name):
    """The tensor paths (doubling scans) against pcr_tpu's jnp paths
    (associative scans) on a 37-link float32 circuit."""
    T = _poses(rng, 37).astype(np.float32)
    arg = T[:, :3, :3] if name == "chain_rotations_ref" else T
    got = getattr(t_se3, name)(torch.as_tensor(arg)).numpy()
    want = np.asarray(getattr(j_se3, name)(jnp.asarray(arg)))
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=1e-5 * scale)


def test_identity_and_interpolate(rng):
    """interpolate on numpy: 1e-6, because pcr_tpu's takes t through
    jnp.asarray (float32 with x64 off), so its translations are float32;
    the port's host path stays float64."""
    assert torch.equal(t_se3.identity(), torch.eye(4))
    A, B = _poses(rng, 6), _poses(rng, 6)
    t = rng.uniform(size=6)
    got = t_se3.interpolate(A, B, t)
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, np.asarray(j_se3.interpolate(A, B, t)), atol=1e-6)
    got = t_se3.interpolate(torch.as_tensor(A, dtype=torch.float32),
                            torch.as_tensor(B, dtype=torch.float32), 0.3).numpy()
    want = np.asarray(j_se3.interpolate(jnp.asarray(A, jnp.float32),
                                        jnp.asarray(B, jnp.float32), 0.3))
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(t_se3.interpolate(A, B, np.zeros(6)), A, atol=1e-12)


def test_inclusive_scan_orders(rng):
    """The doubling scan equals the sequential fold for a non-commutative
    combine (matrix products in both orders), at every length up to 17."""
    for n in range(1, 18):
        M = torch.as_tensor(np.stack([random_rotation(rng) for _ in range(n)]))
        fwd = t_se3._inclusive_scan(M, lambda a, b: a @ b)
        rev = t_se3._inclusive_scan(M, lambda a, b: b @ a)
        acc_f = acc_r = torch.eye(3, dtype=M.dtype)
        for i in range(n):
            acc_f, acc_r = acc_f @ M[i], M[i] @ acc_r
            torch.testing.assert_close(fwd[i], acc_f, atol=1e-12, rtol=0)
            torch.testing.assert_close(rev[i], acc_r, atol=1e-12, rtol=0)
