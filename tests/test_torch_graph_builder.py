"""The k-connectivity graph builder (pcr_tpu_torch.models.graph_builder) and
the two branches it leans on, held against pcr_tpu on the same seeded
numpy clouds: 4 overlapping scans of a bumpy surface, 1500 points in a
2048 capacity (tests/test_pipeline.py's ``_bumpy_clouds``, rebuilt here in
numpy), at pcr_tpu's reduced budgets (n_scales=2, iterations=25).

The port's tuple test is handed the uniforms pcr_tpu draws for the same
seed (``jax_uniforms``), so both packages sample the same correspondence
slots.

Tolerances:
  * FGR's absolute-scale GNC on identical correspondences: 300 f32
    Gauss-Newton steps, an LU solve in pcr_tpu and a Cholesky solve here,
    reductions in other orders: poses within 1e-4 (as the relative mode,
    tests/test_torch_fgr.py);
  * the doubling M-GICP from the same seed pose: within 5e-3, stage 2's
    bound (tests/test_torch_stage2.py); on the CPU pcr_tpu searches its
    correspondences in a hash grid, the port in the band sweep;
  * whole pairs (``coarse_to_fine``, each edge of the k=2 graph): the same
    5e-3, where pcr_tpu's FPFH rows and the port's can differ in a bin
    (tests/test_torch_selection.py), which moves a few mutual matches and
    so the FGR seed; gate fitness within 2e-3 (three pairs in the 1500) and
    the log lines, printed to three decimals, equal; information matrices
    at pcr_tpu's own batched-against-serial bounds, rtol 0.05 / atol 50
    (a few correspondences more or fewer at the voxel radius);
  * the port's batched builder against its serial one: pcr_tpu's bounds
    (tests/test_pipeline.py:458-467), edge_T 5e-4, nodes 5e-3, information
    rtol 0.05 / atol 50;
  * against ground truth: pcr_tpu's own, 5 cm for a pair, 8 cm for an
    optimised node (tests/test_pipeline.py:83-122).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcr_tpu.models import fgr as j_fgr
from pcr_tpu.models import graph_builder as j_gb
from pcr_tpu.models import multiscale as j_ms
from pcr_tpu.utils import cloud as j_cloud
from pcr_tpu_torch.models import fgr as t_fgr
from pcr_tpu_torch.models import graph_builder as t_gb
from pcr_tpu_torch.models import multiscale as t_ms
from pcr_tpu_torch.models.global_refine import pose_graph as t_pg
from pcr_tpu_torch.utils import cloud as t_cloud
from pcr_tpu_torch.utils import se3

torch.set_num_threads(1)
VOXEL = 0.2
CAP = 2048
BUDGET = dict(n_scales=2, iterations=25)
N, K = 4, 2


def _rot_z(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def bumpy_clouds(rng, n_clouds=N, n=1500, step=0.4):
    """Scan i views a fixed bumpy surface from a frame shifted by i*step
    with yaw 0.05*i: (scans as (n, 3) float32, absolute poses (n_clouds, 4,
    4)), so cloud s registers onto cloud t by inv(poses[t]) @ poses[s]."""
    scans, poses = [], []
    for i in range(n_clouds):
        xy = rng.uniform(-4, 4, size=(n, 2)).astype(np.float32)
        xy[:, 0] += i * step
        z = (np.sin(1.3 * xy[:, :1]) * 0.5 + np.cos(0.9 * xy[:, 1:2]) * 0.4
             + 0.2 * np.sin(2.7 * xy[:, :1] * xy[:, 1:2] / 4))
        T = np.eye(4)
        T[:3, :3] = _rot_z(0.05 * i)
        T[:3, 3] = [i * step, 0.1 * i, 0.0]
        Ti = np.linalg.inv(T)
        world = np.concatenate([xy, z], axis=1).astype(np.float32)
        scans.append((world @ Ti[:3, :3].T + Ti[:3, 3]).astype(np.float32))
        poses.append(T)
    return scans, np.stack(poses)


_UNIFORMS = {}


def jax_uniforms(seed: int) -> torch.Tensor:
    """The (16384, 3) uniforms of pcr_tpu's tuple test for ``seed``."""
    if seed not in _UNIFORMS:
        u = jax.random.uniform(jax.random.PRNGKey(seed), (16384, 3))
        _UNIFORMS[seed] = torch.from_numpy(np.array(u))
    return _UNIFORMS[seed]


@pytest.fixture(scope="module")
def circuit():
    scans, poses = bumpy_clouds(np.random.default_rng(0))
    return dict(scans=scans, poses=poses,
                t=[t_cloud.from_numpy(s, CAP, device="cpu") for s in scans],
                j=[j_cloud.from_numpy(s, capacity=CAP) for s in scans])


def _rel(poses, s, t):
    return np.linalg.inv(poses[t]) @ poses[s]


def _np(x):
    return x.detach().double().numpy() if torch.is_tensor(x) else np.asarray(x, np.float64)


# --------------------------------------------------------------------------
# The two branches the builder leans on
# --------------------------------------------------------------------------

@pytest.mark.parametrize("pair", [(1, 0), (2, 0)], ids=["0.4m", "0.8m"])
def test_fgr_absolute_scale_gnc_matches_pcr_tpu(circuit, pair):
    """use_absolute_scale=True (no centring, mu0 = (2v)^2 * 1e4) on pcr_tpu's
    own selection features, matches and tuple test."""
    s, t = pair
    src_j, fs = j_fgr.fgr_features(circuit["j"][s], VOXEL)
    tgt_j, ft = j_fgr.fgr_features(circuit["j"][t], VOXEL)
    ci, cj, cm = j_fgr.match_features(fs, src_j.mask, ft, tgt_j.mask)
    keep = j_fgr.tuple_test(src_j.points, tgt_j.points, ci, cj, cm, s * N + t,
                            max_tuples=409)
    opts = j_fgr.default_options(src_j, tgt_j, VOXEL, use_absolute_scale=True)
    assert opts.use_absolute_scale and int(keep.sum()) > 20
    T_j = np.asarray(j_fgr.fgr_from_correspondences(src_j, tgt_j, ci, cj, keep, opts))
    src_t = t_cloud.from_arrays(np.asarray(src_j.points), np.asarray(src_j.mask), device="cpu")
    tgt_t = t_cloud.from_arrays(np.asarray(tgt_j.points), np.asarray(tgt_j.mask), device="cpu")
    T_t = t_fgr.fgr_from_correspondences(
        src_t, tgt_t, torch.from_numpy(np.array(ci)), torch.from_numpy(np.array(cj)),
        torch.from_numpy(np.array(keep)), t_fgr.FgrOptions(*opts)).numpy()
    np.testing.assert_allclose(T_t, T_j, atol=1e-4)
    _, dt = se3.pose_errors(T_t.astype(np.float64), _rel(circuit["poses"], s, t))
    assert float(dt) < 0.25


@pytest.mark.parametrize("n_scales", [2, 3])
def test_doubling_multiscale_gicp_matches_pcr_tpu(circuit, n_scales):
    """The doubling schedule (voxels 0.1 * 2^i, radii from the pair's
    extent clamped to 10x the voxel) from one seed pose 7 cm / 1.1 deg off."""
    E = np.eye(4)
    E[:3, :3] = _rot_z(0.02)
    E[:3, 3] = [0.05, -0.03, 0.02]
    T0 = E @ _rel(circuit["poses"], 1, 0)
    res_j = j_ms.multiscale_gicp(circuit["j"][1], circuit["j"][0], jnp.asarray(T0, jnp.float32),
                                 n_scales=n_scales, iterations=25, schedule="doubling")
    res_t = t_ms.multiscale_gicp(circuit["t"][1], circuit["t"][0], T0, n_scales=n_scales,
                                 iterations=25, schedule="doubling")
    T_t = _np(res_t.transformation)
    np.testing.assert_allclose(T_t, np.asarray(res_j.transformation), atol=5e-3)
    _, dt = se3.pose_errors(T_t, _rel(circuit["poses"], 1, 0))
    assert float(dt) < 0.02


# --------------------------------------------------------------------------
# coarse_to_fine
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair_runs(circuit):
    """coarse_to_fine of scan 1 onto scan 0 in both packages (seed 0)."""
    got = t_gb.coarse_to_fine(circuit["t"][1], circuit["t"][0], VOXEL, uniforms=jax_uniforms,
                              **BUDGET)
    want = j_gb.coarse_to_fine(circuit["j"][1], circuit["j"][0], VOXEL, **BUDGET)
    return got, want


def test_coarse_to_fine_recovers_the_pose(circuit, pair_runs):
    (res, info, gate), _ = pair_runs
    _, dt = se3.pose_errors(_np(res.transformation), _rel(circuit["poses"], 1, 0))
    assert float(dt) < 0.05
    assert float(res.fitness) > 0.4 and isinstance(gate, float) and gate > 0.4
    I = _np(info)
    assert I.shape == (6, 6) and np.isfinite(I).all()
    assert (np.linalg.eigvalsh(I) >= -1e-3).all()
    assert res.scale_iterations.shape == (BUDGET["n_scales"],)


def test_coarse_to_fine_matches_pcr_tpu(pair_runs):
    (res, info, gate), (res_j, info_j, gate_j) = pair_runs
    np.testing.assert_allclose(_np(res.transformation), np.asarray(res_j.transformation),
                               atol=5e-3)
    assert abs(gate - gate_j) <= 2e-3
    np.testing.assert_allclose(_np(info), np.asarray(info_j), rtol=0.05, atol=50.0)


# --------------------------------------------------------------------------
# The k=2 graph
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def graphs(circuit):
    """The k=2 graph of the 4 scans: pcr_tpu's serial builder, the port's
    serial and batched (3 pairs a chunk, so the second chunk is padded)
    builders, with their log lines."""
    out = {}
    for name, build, clouds, kw in (
            ("pcr_tpu", j_gb.full_registration, circuit["j"], {}),
            ("serial", t_gb.full_registration, circuit["t"], dict(uniforms=jax_uniforms)),
            ("batched", t_gb.full_registration_batched, circuit["t"],
             dict(uniforms=jax_uniforms, batch_size=3))):
        log = []
        out[name] = build(clouds, voxel_size=VOXEL, k=K, log=log.append, **BUDGET, **kw), log
    return out


BUILDERS = ["serial", "batched"]


@pytest.mark.parametrize("builder", BUILDERS)
def test_k2_graph_is_the_ports_pose_graph(graphs, builder):
    g, _ = graphs[builder]
    assert isinstance(g, t_pg.PoseGraph)
    assert g.edge_src.shape[0] == K * (2 * N - K - 1) // 2          # 5 edges
    assert g.edge_src.tolist() == [0, 0, 1, 1, 2] and g.edge_dst.tolist() == [1, 2, 2, 3, 3]
    assert g.uncertain.tolist() == [False, True, False, True, False]
    assert bool(g.edge_mask.all())
    assert g.edge_src.dtype == g.edge_dst.dtype == torch.int64
    for x in (g.nodes, g.edge_T, g.edge_info):
        assert x.dtype == torch.float32 and bool(torch.isfinite(x).all())
    assert {x.device.type for x in g} == {"cpu"}
    assert g.nodes.shape == (N, 4, 4) and g.edge_info.shape == (5, 6, 6)
    assert not t_pg.is_circuit_graph(g)                 # k=2 is not a pure circuit


@pytest.mark.parametrize("builder", BUILDERS)
def test_k2_graph_optimises_to_ground_truth(graphs, circuit, builder):
    g, _ = graphs[builder]
    out = t_pg.global_optimization(g, max_correspondence_distance=0.4)
    nodes = _np(out.nodes)
    for i in range(N):
        _, dt = se3.pose_errors(nodes[i], circuit["poses"][i])
        assert float(dt) < 0.08, (i, dt)


def test_batched_builder_matches_serial(graphs):
    ser, _ = graphs["serial"]
    bat, _ = graphs["batched"]
    assert torch.equal(ser.edge_src, bat.edge_src) and torch.equal(ser.edge_dst, bat.edge_dst)
    assert torch.equal(ser.uncertain, bat.uncertain)
    np.testing.assert_allclose(_np(bat.edge_T), _np(ser.edge_T), atol=5e-4)
    np.testing.assert_allclose(_np(bat.nodes), _np(ser.nodes), atol=5e-3)
    np.testing.assert_allclose(_np(bat.edge_info), _np(ser.edge_info), rtol=0.05, atol=50.0)


@pytest.mark.parametrize("builder", BUILDERS)
def test_k2_graph_matches_pcr_tpu_edge_by_edge(graphs, builder):
    g, _ = graphs[builder]
    want, _ = graphs["pcr_tpu"]
    np.testing.assert_array_equal(g.edge_src.numpy(), np.asarray(want.edge_src))
    np.testing.assert_array_equal(g.edge_dst.numpy(), np.asarray(want.edge_dst))
    np.testing.assert_array_equal(g.uncertain.numpy(), np.asarray(want.uncertain))
    for e in range(g.edge_src.shape[0]):
        np.testing.assert_allclose(_np(g.edge_T[e]), np.asarray(want.edge_T[e]), atol=5e-3,
                                   err_msg=f"edge {e}")
        np.testing.assert_allclose(_np(g.edge_info[e]), np.asarray(want.edge_info[e]),
                                   rtol=0.05, atol=50.0, err_msg=f"edge {e}")
    np.testing.assert_allclose(_np(g.nodes), np.asarray(want.nodes), atol=5e-3)


def test_serial_log_lines_equal_pcr_tpus(graphs):
    _, got = graphs["serial"]
    _, want = graphs["pcr_tpu"]
    assert len(got) == 6 and got == want
    assert want[-1] == "5/5 successful registrations (gate 0.4)"


def test_batched_log_lines(graphs):
    """pcr_tpu's batched builder's lines: the serial builder's pair lines
    and its own summary."""
    _, got = graphs["batched"]
    _, want = graphs["pcr_tpu"]
    assert got[:-1] == want[:-1]
    assert got[-1] == "5/5 successful registrations (gate 0.4, 0 retried serially)"


def test_batched_builder_retries_a_gated_pair_like_pcr_tpu(circuit):
    """A gate no pair can pass (0.99): the batched builder's first attempt
    fails it, and the serial ladder (same voxel with seed +101, then 2x and
    4x the voxel) keeps the best of the four candidates, as pcr_tpu's
    ``coarse_to_fine`` does with the same draws."""
    log = []
    g = t_gb.full_registration_batched(circuit["t"][:2], VOXEL, k=1, fitness_gate=0.99,
                                       log=log.append, uniforms=jax_uniforms, batch_size=2,
                                       **BUDGET)
    res_j, info_j, gate_j = j_gb.coarse_to_fine(circuit["j"][0], circuit["j"][1], VOXEL,
                                                seed=1, fitness_gate=0.99, **BUDGET)
    assert log[-1] == "0/1 successful registrations (gate 0.99, 1 retried serially)"
    assert log[0].startswith("pair 0->1 odom fitness=") and log[0].endswith(" FAILED")
    gate = float(log[0].split("fitness=")[1].split()[0])
    assert abs(gate - gate_j) <= 2e-3 and gate > 0.4
    np.testing.assert_allclose(_np(g.edge_T[0]), np.asarray(res_j.transformation), atol=5e-3)
    np.testing.assert_allclose(_np(g.edge_info[0]), np.asarray(info_j), rtol=0.05, atol=50.0)
    _, dt = se3.pose_errors(_np(g.edge_T[0]), _rel(circuit["poses"], 0, 1))
    assert float(dt) < 0.05
