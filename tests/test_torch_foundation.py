"""Port foundation (pcr_tpu_torch.utils / ops.eigen3 / ops.voxel) held against
pcr_tpu on the same numpy inputs."""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcr_tpu.ops import eigen3 as j_eigen3
from pcr_tpu.ops import voxel as j_voxel
from pcr_tpu.utils import cloud as j_cloud
from pcr_tpu.utils import se3 as j_se3
from pcr_tpu_torch.ops import eigen3 as t_eigen3
from pcr_tpu_torch.ops import voxel as t_voxel
from pcr_tpu_torch.ops.kernels import nn_kernels
from pcr_tpu_torch.utils import cloud as t_cloud
from pcr_tpu_torch.utils import se3 as t_se3

torch.set_num_threads(1)


def _random_poses(rng, n):
    R = np.stack([np.linalg.qr(rng.normal(size=(3, 3)))[0] for _ in range(n)])
    R[np.linalg.det(R) < 0, :, 0] *= -1
    T = np.tile(np.eye(4), (n, 1, 1))
    T[:, :3, :3] = R
    T[:, :3, 3] = rng.normal(scale=3.0, size=(n, 3))
    return T


def test_compose_ref_and_invert_f64(rng):
    """Host (numpy) pose algebra runs in f64 in both packages: the results
    agree to f64 rounding (1e-12)."""
    A, B = _random_poses(rng, 5), _random_poses(rng, 5)
    np.testing.assert_allclose(t_se3.compose_ref(A, B), j_se3.compose_ref(A, B), atol=1e-12)
    np.testing.assert_allclose(t_se3.invert(A), j_se3.invert(A), atol=1e-12)
    # the torch path is the same algebra on tensors
    got = t_se3.compose_ref(torch.as_tensor(A), torch.as_tensor(B)).numpy()
    np.testing.assert_allclose(got, j_se3.compose_ref(A, B), atol=1e-12)


def test_relative_to_absolute_f64(rng):
    """The reference's reversed-rotation chain, identity prepended and the
    closure pose dropped; a 60-link f64 chain agrees to 1e-9 m."""
    rel = _random_poses(rng, 60)
    rel[:, :3, 3] *= 0.3
    want = j_se3.relative_to_absolute(rel)
    got = t_se3.relative_to_absolute(rel)
    assert got.shape == (60, 4, 4) and got.dtype == np.float64
    np.testing.assert_allclose(got, want, atol=1e-9)
    got_t = t_se3.relative_to_absolute(torch.as_tensor(rel)).numpy()
    np.testing.assert_allclose(got_t, want, atol=1e-9)


@pytest.mark.parametrize("scale", [1e-7, 0.3, 3.0])
def test_se3_exp_log_match(rng, scale):
    """exp/log in f32 against pcr_tpu's: 1e-5 absolute (f32 trig, incl. the
    small-angle Taylor branch and angles near pi)."""
    xi = rng.normal(size=(8, 6)).astype(np.float32)
    xi[:, :3] *= scale / np.linalg.norm(xi[:, :3], axis=1, keepdims=True)
    T_t = t_se3.se3_exp(torch.as_tensor(xi))
    T_j = np.asarray(j_se3.se3_exp(jnp.asarray(xi)))
    np.testing.assert_allclose(T_t.numpy(), T_j, atol=1e-5)
    np.testing.assert_allclose(t_se3.se3_log(T_t).numpy(),
                               np.asarray(j_se3.se3_log(jnp.asarray(T_j))), atol=1e-4)
    np.testing.assert_allclose(t_se3.se3_log(T_t).numpy(), xi, atol=1e-4)


def test_pose_errors_match(rng):
    A, B = _random_poses(rng, 4), _random_poses(rng, 4)
    for got, want in zip(t_se3.pose_errors(A, B), j_se3.pose_errors(A, B)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6)


def test_eigh3_matches(rng):
    """Closed-form eigensystem of symmetric 3x3 (incl. plane-like and
    degenerate ones): eigenvalues within 1e-5 of the scale, eigenvectors equal
    up to sign within 1e-3 (same f32 formulas)."""
    X = rng.normal(size=(64, 3, 3)).astype(np.float32)
    A = X @ np.swapaxes(X, 1, 2)
    A[:8] = np.diag([1.0, 1.0, 1e-4]).astype(np.float32)     # flat disk
    A[8:12] = np.eye(3, dtype=np.float32)                     # isotropic
    w_t, V_t = t_eigen3.eigh3(torch.as_tensor(A))
    w_j, V_j = map(np.asarray, j_eigen3.eigh3(jnp.asarray(A)))
    scale = np.abs(A).max(axis=(1, 2))[:, None]
    np.testing.assert_allclose(w_t.numpy() / scale, w_j / scale, atol=1e-5)
    dots = np.abs(np.sum(V_t.numpy() * V_j, axis=1))          # column-wise |cos|
    assert (dots[12:] > 1 - 1e-3).all()
    n_t = t_eigen3.smallest_eigenvector(torch.as_tensor(A)).numpy()
    np.testing.assert_allclose(np.linalg.norm(n_t, axis=1), 1.0, atol=1e-5)


def test_voxel_downsample_matches(rng):
    """Same occupied voxels and the same means: the set of means agrees to
    1e-6 (both sum each voxel's points in sorted order in f32)."""
    pts = rng.uniform(-5, 5, size=(1800, 3)).astype(np.float32)
    c = j_cloud.from_numpy(pts, capacity=2048)
    m_j, k_j = map(np.asarray, j_voxel.voxel_downsample(c.points, c.mask, 0.5))
    m_t, k_t = t_voxel.voxel_downsample(torch.tensor(np.asarray(c.points)),
                                        torch.tensor(np.asarray(c.mask)), 0.5)
    m_t, k_t = m_t.numpy(), k_t.numpy()
    np.testing.assert_array_equal(k_t, k_j)                  # same prefix mask
    np.testing.assert_allclose(m_t[k_t], m_j[k_j], atol=1e-6)  # same order too
    assert (m_t[~k_t] == t_cloud.PAD_COORD).all()


def test_plan_scale_caps_and_compact_match(rng):
    clouds_np = [rng.uniform(-10, 10, size=(n, 3)).astype(np.float32) for n in (3000, 2200)]
    j_clouds = [j_cloud.from_numpy(p, capacity=4096) for p in clouds_np]
    t_clouds = [t_cloud.from_numpy(p, capacity=4096, device="cpu") for p in clouds_np]
    scales = [0.5, 0.3, 0.1]
    assert t_cloud.plan_scale_caps(t_clouds, scales) == j_cloud.plan_scale_caps(j_clouds, scales)
    # compact keeps a uniform stride of the valid rows, like pcr_tpu's
    cj = j_cloud.compact(j_clouds[0], 1024)
    ct = t_cloud.compact(t_clouds[0], 1024)
    np.testing.assert_array_equal(ct.points.numpy(), np.asarray(cj.points))
    np.testing.assert_array_equal(ct.mask.numpy(), np.asarray(cj.mask))
    padded = t_cloud.pad_to(ct, 1536)
    assert padded.capacity == 1536 and int(padded.count()) == int(ct.count())


def test_from_arrays_carries_pcr_tpu_cloud(rng):
    pts = rng.normal(size=(100, 3)).astype(np.float32)
    c = j_cloud.from_numpy(pts, capacity=256)
    normals = np.tile(np.float32([0, 0, 1]), (256, 1))
    t = t_cloud.from_arrays(np.asarray(c.points), np.asarray(c.mask), normals=normals, device="cpu")
    assert t.points.dtype == torch.float32 and t.mask.dtype == torch.bool
    np.testing.assert_array_equal(t.points.numpy(), np.asarray(c.points))
    assert int(t.count()) == 100 and t.normals.shape == (256, 3)


def test_clouds_default_to_the_card(rng):
    """Without ``device`` a cloud goes to the CUDA card; where there is
    none it raises instead of landing on the CPU."""
    pts = rng.normal(size=(10, 3)).astype(np.float32)
    if torch.cuda.is_available():
        assert t_cloud.from_numpy(pts).points.is_cuda
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_cloud.from_numpy(pts)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_cloud.from_arrays(pts, np.ones(10, bool))
    assert t_cloud.from_numpy(pts, device="cpu").points.device.type == "cpu"


def test_kernel_wrapper_refuses_other_devices():
    """A wrapper runs its plain version only for CPU tensors; tensors on any
    other device are launched or refused, never silently computed on CPU."""
    starts = torch.zeros(1, dtype=torch.int32, device="meta")
    q = torch.zeros(256, 3, device="meta")
    with pytest.raises(ValueError):
        nn_kernels.nn1_band(starts, q, torch.zeros(512, 3, device="meta"),
                            q_tile=256, band=256)


def test_port_never_imports_jax():
    """Importing pcr_tpu_torch and every submodule leaves jax and pcr_tpu out
    of sys.modules (the port must run where JAX is absent)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import pcr_tpu_torch\n"
        "for m in pkgutil.walk_packages(pcr_tpu_torch.__path__, 'pcr_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'pcr_tpu' or m.startswith('pcr_tpu.')]\n"
        "assert not bad, bad\n"
        "assert 'pcr_tpu_torch.pipeline' in sys.modules\n"
        "import torch\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
        "assert torch.get_float32_matmul_precision() == 'highest'\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=Path(__file__).resolve().parents[1])
