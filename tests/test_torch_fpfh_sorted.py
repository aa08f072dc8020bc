"""Banded stage-1 features (pcr_tpu_torch.ops.fpfh_sorted, the plain
versions of kernels K4-K6 on CPU) held against pcr_tpu.ops.fpfh_sorted on
the same numpy inputs: its XLA path and its Pallas kernels in interpret
mode, and the O(n^2) numpy FPFH oracle.

Tolerances: pcr_tpu computes d2 by the expansion |q|^2 + |r|^2 - 2 q.r
(~1e-6 abs error at these coordinates), the port directly as (q - r)^2.  A
bisection step flips only where a neighbour distance lies within that error
of a step's threshold, and then tau moves by one bisection cell (log cell
2 ln(40) / 2^10 = 0.7% for K4, 2 ln(200) / 2^10 = 1.0% for K5), admitting or
dropping that one neighbour.  pcr_tpu also weights the FPFH sum by 1/d2 of
the expanded d2, which at a 2 cm neighbour (d2 = 4e-4) is off by up to
~0.3%.  Measured on the 800-point patch: normals within 3e-5, FPFH
relative L1 median 1e-6, 99th percentile 5e-5, max 1.7e-3.  The bounds
below are the Pallas-vs-XLA bound of tests/test_fpfh_sorted.py for the
normals (1e-4) and 20x the measured FPFH percentiles.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pcr_tpu.ops import fpfh_sorted as j_fs
from pcr_tpu.utils import cloud as j_cloud
from pcr_tpu_torch.ops import fpfh_sorted as t_fs
from pcr_tpu_torch.utils import cloud as t_cloud
from tests.test_fpfh import np_fpfh

torch.set_num_threads(1)


def _surface(rng):
    """tests/test_fpfh_sorted.py's 800-point surface patch, capacity 1024."""
    pts = rng.uniform(-2, 2, size=(800, 3)).astype(np.float32)
    pts[:, 2] = 0.1 * np.sin(pts[:, 0] * 2) + 0.05 * pts[:, 1]
    return pts


@pytest.mark.parametrize("backend", ["xla", "pallas_interpret"])
def test_features_match_pcr_tpu(rng, backend):
    pts = _surface(rng)
    cj, fj = j_fs.fgr_features_sorted(j_cloud.from_numpy(pts, capacity=1024), 0.2,
                                      q_tile=256, band=512, backend=backend)
    ct, ft = t_fs.fgr_features_sorted(t_cloud.from_numpy(pts, 1024, device="cpu"), 0.2,
                                      q_tile=256, band=512)
    M = np.asarray(cj.mask)
    np.testing.assert_array_equal(ct.mask.numpy(), M)
    np.testing.assert_array_equal(ct.points.numpy(), np.asarray(cj.points))
    Nj, Nt = np.asarray(cj.normals)[M], ct.normals.numpy()[M]
    nd = np.minimum(np.linalg.norm(Nj - Nt, axis=1), np.linalg.norm(Nj + Nt, axis=1))
    assert nd.max() < 1e-4, nd.max()
    Fj, Ft = np.asarray(fj)[M], ft.numpy()[M]
    l1 = np.abs(Fj - Ft).sum(1) / (np.abs(Fj).sum(1) + 1e-9)
    assert np.median(l1) < 2e-5 and np.percentile(l1, 99) < 1e-3 and l1.max() < 0.03, (
        np.median(l1), l1.max())


def test_oracle_with_normals_in(rng):
    """tests/test_fpfh_sorted.py's oracle contract: with known normals and a
    slab covering the whole cloud, the features match the exact numpy FPFH
    (up to bin-edge jitter and a tied neighbour at the threshold)."""
    pts = rng.uniform(-1, 1, size=(96, 3)).astype(np.float32)
    nrm = rng.normal(size=(96, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    nin = np.zeros((128, 3), np.float32)
    nin[:96] = nrm
    c2, f2 = t_fs.fgr_features_sorted(t_cloud.from_numpy(pts, 128, device="cpu"), 0.1,
                                      q_tile=128, band=128, max_nn=25,
                                      normals_in=torch.from_numpy(nin))
    P2, M2, N2 = c2.points.numpy(), c2.mask.numpy(), c2.normals.numpy()
    assert M2.sum() == 96
    oracle = np_fpfh(P2[M2].astype(np.float64), N2[M2].astype(np.float64), 1.0, 25)
    F2 = f2.numpy()[M2]
    l1 = np.abs(F2 - oracle).sum(1) / (np.abs(oracle).sum(1) + 1e-9)
    assert (l1 < 0.07).mean() > 0.95, (np.median(l1), l1.max())
    np.testing.assert_allclose(F2.sum(), oracle.sum(), rtol=0.02)
    # and the same rows as pcr_tpu's on the same inputs
    cj, fj = j_fs.fgr_features_sorted(j_cloud.from_numpy(pts, capacity=128), 0.1,
                                      q_tile=128, band=128, max_nn=25,
                                      normals_in=jnp.asarray(nin))
    np.testing.assert_array_equal(P2, np.asarray(cj.points))
    lj = np.abs(F2 - np.asarray(fj)[M2]).sum(1) / (np.abs(F2).sum(1) + 1e-9)
    assert np.median(lj) < 1e-3, (np.median(lj), lj.max())


def test_slab_placement_proof():
    """A tiling whose query rows fall outside their own slab is refused;
    q_tile > band is accepted where the tiles still land in their slabs."""
    t_fs.prove_slab_placement([0, 512], 1024, 512, 256)
    with pytest.raises(ValueError, match="placement"):
        t_fs.prove_slab_placement([0, 0], 1024, 512, 256)
