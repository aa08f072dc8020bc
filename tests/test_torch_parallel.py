"""The device meshes of the port (``pcr_tpu_torch/parallel``, the mesh
branches of ``pipeline`` and the CLI's ``--devices`` / ``--shard-points``)
on gloo process groups on the CPU, held against the port's unsharded or
batched forms and against pcr_tpu's sharded forms on its 8-device virtual
CPU mesh (tests/conftest.py), on the same numpy inputs (the sizes of
tests/test_parallel.py).

The port's side runs in spawned ranks (tests/torch_parallel_worker.py, which
imports no JAX): one spawn of 4 ranks for every function of the four
modules, stage 2 on a (2, 2) mesh and ``run_full`` on a pair mesh of 4, one
of 2 ranks for the runners, the point-sharded grid GICP and ``run_pair`` and
the CLI.  Both start before the
parent computes the references, so the two overlap.  Every group has a 90 s
collective timeout and a FileStore rendezvous under ``tmp_path``; the parent
kills the ranks when one fails or when they overrun.  ~75 s on one worker
with a warm JAX compilation cache.

Tolerances, the port's sharded form against its unsharded form (pcr_tpu's
tests/test_parallel.py bounds for the same pairs): GICP 1e-5; FGR and its
fitness 1e-4 (on JAX's uniforms); features, normals and covariances 1e-5
(each scan runs the unsharded function, so 0 is expected); point-sharded
GICP 1e-5 (the grid's on 2 ranks 1e-6) and M-GICP 5e-5; the 2-D forms 5e-4;
nn1 / knn d2 rtol 1e-6 with equal rows;
pose-graph nodes 5e-4; the runners on a pair mesh 1e-6 in stage 2 (each
pair runs the same operations as in the run without a mesh, so 0 is
expected)
and 1e-4 in stage 1 (a chunk's GNC is batched over a rank's block, not over
the chunk); stage 2 on a (2, 2) mesh 5e-4; ``run_full`` on a pair mesh bit
for bit the staged runners on the same mesh (the same operations), its stage
2 within nclt-seq32's pose limits of the benchmark's reference ICP.

Against pcr_tpu's sharded forms, the bounds the port's unsharded tests hold
the same functions to: GICP 1e-4 (tests/test_torch_gicp.py, band, brute
and grid against band, brute and grid); M-GICP 5e-3
(tests/test_torch_stage2.py: there
pcr_tpu resolves 'auto' to its CPU hash grid, the port runs the band sweep,
and pcr_tpu builds its own pyramids); FGR 1e-4 on JAX's uniforms
(tests/test_torch_batched.py); banded features as tests/test_torch_batched.py
and selection features as tests/test_torch_selection.py; nn1 / knn as
tests/test_torch_knn.py; the pose graph 1e-4 (tests/test_torch_pose_graph.py's
small graphs).
"""

import contextlib
import functools
import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from pcr_tpu_torch import __main__ as t_cli
from pcr_tpu_torch import pipeline as t_pipe
from pcr_tpu_torch.models import fgr as t_fgr
from pcr_tpu_torch.models import gicp as t_gicp
from pcr_tpu_torch.models import multiscale as t_ms
from pcr_tpu_torch.models.global_refine import pose_graph as t_pg
from pcr_tpu_torch.ops import fpfh_sorted as t_fs
from pcr_tpu_torch.ops import knn as t_knn
from pcr_tpu_torch.parallel import mesh as t_mesh
from pcr_tpu_torch.parallel import pair_sharding as t_ps
from pcr_tpu_torch.utils import cloud as t_cloud
from pcr_tpu_torch.utils import pcd as t_pcd
from pcr_tpu_torch.utils import poses_io as t_poses
from pcr_tpu_torch.utils import se3
from tests import torch_parallel_worker as worker

torch.set_num_threads(1)
N = 4
SMALL = dict(stage1_band=512, bucket_granularity=256)
ARGS = ["--dataset", "Facade", "--n", str(N), "--voxel-size", "0.2"]
REFINE = ["--scales", "2", "--iterations", "15"]
STAGE2 = dict(dataset="Facade", voxel_size=0.2, mgicp_scales=2, mgicp_iterations=25,
              batch_size=2, retry_failed=True)
STAGE1 = dict(dataset="Facade", voxel_size=0.2, batch_size=2, **SMALL)
PAIR = dict(dataset="Courtyard", voxel_size=0.2, mgicp_scales=2, mgicp_iterations=15)
# The band GICP splits its real rows in whole sorted query tiles.  The
# point-sharded cases sweep tiles of Q_TILE rows, and stage 2 and run_pair on
# a 'points' axis of 2 run scans whose finest level holds more than one
# 1024-row tile, so that every rank sweeps real rows
# (_assert_real_rows_on_every_rank).
Q_TILE = 64
BIG = 2048      # capacity of the circuit of stage 2 and run_pair
N_FULL = 8      # scans of run_full's circuit on the pair mesh of 4


def _leaves(c, prefix=""):
    return {prefix + k: np.asarray(getattr(c, k)) for k in
            ("points", "mask", "normals", "covariances") if getattr(c, k) is not None}


def _jax_inputs(tmp) -> tuple[dict, dict]:
    """The ranks' inputs (numpy) and the JAX-side objects they came from."""
    import jax

    from pcr_tpu.models import fgr as j_fgr
    from pcr_tpu.models import multiscale as j_ms
    from pcr_tpu.ops import fpfh_sorted as j_fs
    from pcr_tpu.utils import cloud as j_cloud
    from tests.test_global_refine import make_pose_graph
    from tests.test_parallel import make_pair_batch
    from tests.test_torch_fpfh_sorted import _surface
    from tests.test_torch_stage2 import bumpy_circuit

    rng = np.random.default_rng(0)
    j = {}
    src, tgt, T0, T_gt = make_pair_batch(rng)
    j["pairs"] = (src, tgt, T0, T_gt)
    x = {"pairs": {**_leaves(src, "s_"), **_leaves(tgt, "t_"), "T0": T0}}
    x["raw"] = {"s_points": x["pairs"]["s_points"][:N], "s_mask": x["pairs"]["s_mask"][:N],
                "t_points": x["pairs"]["t_points"][:N], "t_mask": x["pairs"]["t_mask"][:N],
                "T0": T0[:N], "caps": (512, 640)}
    # tests/test_torch_batched.py's FGR chunk, 4 pairs: scans k+1 -> k of a
    # bumpy circuit with pcr_tpu's banded features
    fgr_scans, fgr_gt = bumpy_circuit(np.random.default_rng(2), n_clouds=N + 1, n=900, step=0.3)
    c, f = j_fs.batched_fgr_features_sorted(
        j_cloud.stack_clouds([j_cloud.from_numpy(sc, capacity=1024) for sc in fgr_scans]), 0.2,
        q_tile=256, band=512)
    fs_src, fs_tgt = (jax.tree.map(lambda a: a[idx], c) for idx in (slice(1, N + 1), slice(0, N)))
    fs, ft = f[1:], f[:N]
    opts = j_fgr.default_options_capacity(1024, 0.2)
    seeds = np.arange(1, N + 1, dtype=np.int32)
    max_tuples = np.array([256, 300, 256, 280], np.int32)
    u = np.stack([np.asarray(jax.random.uniform(jax.random.PRNGKey(int(s)), (4096, 3)))
                  for s in seeds])
    j["fgr"] = (fs_src, fs_tgt, fs, ft, opts, seeds, max_tuples)
    j["fgr_gt"] = fgr_gt[:N]
    x["fgr"] = {**_leaves(fs_src, "s_"), **_leaves(fs_tgt, "t_"), "fs": np.asarray(fs),
                "ft": np.asarray(ft), "seeds": seeds, "opts": tuple(opts), "n_trials": 4096,
                "u": u, "max_tuples": max_tuples}
    x["scans"] = _leaves(j_cloud.stack_clouds(
        [j_cloud.from_numpy(_surface(np.random.default_rng(s)), capacity=1024)
         for s in range(N)]))
    q = rng.uniform(-5, 5, size=(2048, 3)).astype(np.float32)
    r = rng.uniform(-5, 5, size=(4096, 3)).astype(np.float32)
    m = np.ones(4096, dtype=bool)
    m[4000:] = False
    x["nn"] = {"q": q, "r": r, "m": m}
    j["nn"] = (q, r, m)
    src1, tgt1, T01, T_gt1 = make_pair_batch(rng, B=1, n=900, cap=1024)
    src1, tgt1 = jax.tree.map(lambda a: a[0], src1), jax.tree.map(lambda a: a[0], tgt1)
    pyr_s = j_ms.build_pyramid(src1, n_scales=2, scale_capacities=(256, 1024))
    pyr_t = j_ms.build_pyramid(tgt1, n_scales=2, scale_capacities=(256, 1024))
    j["single"] = (src1, tgt1, T01[0], T_gt1[0], pyr_s, pyr_t)
    x["single"] = {**_leaves(src1, "s_"), **_leaves(tgt1, "t_"), "T0": T01[0],
                   "q_tile": Q_TILE}
    for i in range(2):
        x["single"].update({**_leaves(pyr_s[i], f"ps{i}_"), **_leaves(pyr_t[i], f"pt{i}_")})
    src2, tgt2, T02, T_gt2 = make_pair_batch(rng, B=2, n=900, cap=1024)
    j["pairs2"] = (src2, tgt2, T02, T_gt2)
    x["pairs2"] = {**_leaves(src2, "s_"), **_leaves(tgt2, "t_"), "T0": T02,
                   "rs_points": np.asarray(src2.points), "rs_mask": np.asarray(src2.mask),
                   "rt_points": np.asarray(tgt2.points), "rt_mask": np.asarray(tgt2.mask),
                   "caps": (256, 1024), "q_tile": Q_TILE}
    graph, _ = make_pose_graph(rng, 18, drift=0.03)
    j["graph"] = graph
    x["graph"] = {k: np.asarray(v) for k, v in graph._asdict().items()}

    scans, gt = bumpy_circuit(np.random.default_rng(0), n_clouds=N, n=800, step=0.3)
    big, big_gt = bumpy_circuit(np.random.default_rng(0), n_clouds=N, n=1500, step=0.3)
    init = big_gt.copy()
    init[1] = np.eye(4)
    init[1][:3, 3] = [50.0, 50.0, 50.0]          # the retry ladder's pair
    x["stage2"] = dict(scans=big, init=init, capacity=BIG, cfg=STAGE2,
                       out=str(tmp / "stage2_2d"))
    full, full_gt = bumpy_circuit(np.random.default_rng(0), n_clouds=N_FULL, n=2000, step=0.3)
    x["full"] = dict(scans=full, capacity=2048, cfg=dict(STAGE2, **SMALL),
                     out=str(tmp / "run_full"))
    return x, j, dict(scans=scans, gt=gt, big=big, big_gt=big_gt, init=init, full=full,
                      full_gt=full_gt)


def _write_dataset(root, scans, gt, name="Facade"):
    d = root / "nuvens" / "nuvens_pre_processadas" / name
    d.mkdir(parents=True)
    for i, s in enumerate(scans):
        t_pcd.write_pcd(str(d / f"s{i}.pcd"), s)
    return se3.relative_to_absolute_standard(gt)


def _cli_argv(out: str) -> dict:
    return {
        "stage1": ["stage1", *ARGS, "--devices", "2", "--output-root", out + "/cli"],
        "stage2": ["stage2", *ARGS, *REFINE, "--devices", "2", "--output-root", out + "/cli"],
        "full": ["full", *ARGS, *REFINE, "--devices", "2", "--output-root", out + "/full"],
        "stage3": ["stage3", *ARGS, "--devices", "2", "--relative", out + "/full/"
                   "relative_poses_FGR_GICP/Facade", "--output-root", out + "/stage3"],
    }


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Both spawns, then every reference, then the ranks' outputs."""
    tmp = tmp_path_factory.mktemp("parallel")
    x4, j, circ = _jax_inputs(tmp)
    root = tmp / "reference"
    _write_dataset(root, circ["scans"], circ["gt"])
    absolute = _write_dataset(root, circ["big"], circ["big_gt"], "Courtyard")
    x2 = {"stage1": dict(scans=circ["scans"], capacity=1024, cfg=STAGE1,
                         out=str(tmp / "stage1")),
          "stage2": dict(scans=circ["big"], init=circ["init"], capacity=BIG, cfg=STAGE2,
                         out=str(tmp / "stage2")),
          "single": x4["single"],
          "cli": dict(root=str(root), n=N, bucket=1024, pair_bucket=BIG, small=SMALL,
                      out=str(tmp), pair_cfg=PAIR, argv=_cli_argv(str(tmp)))}
    ranks4 = worker.start(4, "functions", x4, tmp / "ranks4")
    ranks2 = worker.start(2, "pipeline", x2, tmp / "ranks2")
    try:
        jax_refs = _jax_references(j)
        with _dataset(root):
            port_refs = _port_references(x4, circ, tmp)
            out4, out2 = ranks4.join(), ranks2.join()
            # the CLI's stage 3 without --devices, on the relative poses of
            # the CLI's `full --devices 2`
            port_refs["stage3"] = _main(
                ["stage3", *ARGS, "--relative",
                 str(tmp / "full" / "relative_poses_FGR_GICP" / "Facade"),
                 "--output-root", str(tmp / "stage3_single")])
    finally:
        ranks4.kill()
        ranks2.kill()
    return dict(x4=x4, j=j, circ=circ, absolute=absolute, tmp=tmp, jax=jax_refs,
                port=port_refs, out4=out4, out2=out2)


@contextlib.contextmanager
def _dataset(root):
    """The port pointed at the PCD circuit under ``root`` with the CLI's
    small sizes (tests/test_torch_cli.py's ``mini``)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_poses, "REFERENCE_ROOT", str(root))
        mp.setitem(t_poses.CIRCUIT_SIZES, "Facade", N)
        mp.setitem(t_cloud.BUCKETS, "Facade", 1024)
        mp.setitem(t_cloud.BUCKETS, "Courtyard", BIG)
        mp.setattr(t_pipe, "PipelineConfig", functools.partial(t_pipe.PipelineConfig, **SMALL))
        yield


def _main(argv) -> dict:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert t_cli.main(argv, device="cpu") == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def _port_references(x, circ, tmp) -> dict:
    """The port's unsharded and batched forms on the ranks' inputs."""
    cloud, res_np = worker.cloud, worker.result_np
    out = {}
    p = x["pairs"]
    for method in ("brute", "band"):
        out[f"gicp_{method}"] = res_np(t_ps.batched_gicp(
            cloud(p, "s_"), cloud(p, "t_"), p["T0"], 0.3, corr_method=method, max_iteration=10))
    r = x["raw"]
    out["mgicp"] = res_np(t_ps.batched_mgicp(cloud(r, "s_"), cloud(r, "t_"), r["T0"], n_scales=2,
                                             iterations=8, scale_capacities=r["caps"]))
    f = x["fgr"]
    out["fgr"] = res_np(t_fgr.batched_registration_fgr(
        cloud(f, "s_"), cloud(f, "t_"), torch.as_tensor(f["fs"]), torch.as_tensor(f["ft"]),
        t_fgr.FgrOptions(*f["opts"]), list(f["seeds"]), n_trials=f["n_trials"],
        max_tuples=list(f["max_tuples"]), u=torch.as_tensor(f["u"])))
    scans = cloud(x["scans"])
    for kind, (c, feats) in (("banded", t_fs.batched_fgr_features_sorted(scans, 0.2, band=512)),
                             ("selection", t_fgr.batched_fgr_features(scans, 0.2))):
        out[f"features_{kind}"] = dict(points=c.points.numpy(), mask=c.mask.numpy(),
                                       normals=c.normals.numpy(),
                                       covariances=c.covariances.numpy(), feats=feats.numpy())
    n = {k: torch.as_tensor(v) for k, v in x["nn"].items()}
    out["nn1"] = [t.numpy() for t in t_knn.nn1_exact(n["q"], n["r"], n["m"])]
    out["knn"] = [t.numpy() for t in t_knn.knn_exact(n["q"][:512], n["r"][:2048],
                                                     n["m"][:2048], 8)]
    s = x["single"]
    for method in ("brute", "band", "grid"):
        out[f"point_gicp_{method}"] = res_np(t_gicp.registration_gicp(
            cloud(s, "s_"), cloud(s, "t_"), 0.3, s["T0"], corr_method=method, max_iteration=10,
            q_tile=Q_TILE))
    out["point_mgicp"] = res_np(_multiscale_at_q_tile(
        [cloud(s, f"ps{i}_") for i in range(2)], [cloud(s, f"pt{i}_") for i in range(2)],
        s["T0"]))
    t2 = x["pairs2"]
    out["gicp_2d"] = res_np(t_ps.batched_gicp(cloud(t2, "s_"), cloud(t2, "t_"), t2["T0"], 0.3,
                                              corr_method="brute", max_iteration=10))
    src2, tgt2 = cloud(t2, "rs_"), cloud(t2, "rt_")
    pyrs = [[t_ms.build_pyramid(c[b], n_scales=2, scale_capacities=t2["caps"])
             for c in (src2, tgt2)] for b in range(2)]
    out["mgicp_2d"] = res_np(t_ps.stack_results([_multiscale_at_q_tile(*pyr, t2["T0"][b])
                                                 for b, pyr in enumerate(pyrs)]))
    out["mgicp_2d_valid"] = [[int(pyr[0][i].mask.sum()) for i in range(2)] for pyr in pyrs]
    g = worker.graph(x["graph"])
    for solver in ("tridiag", "dense"):
        res = t_pg.optimize_pose_graph_once(g, mu=10.0, max_iterations=30, solver=solver)
        out[f"pg_{solver}"] = dict(nodes=res.nodes.numpy(), cost=res.final_cost,
                                   iterations=res.iterations_used,
                                   line_process=res.line_process.numpy())
    out["pg_global"] = t_pg.global_optimization(g, max_correspondence_distance=0.5).nodes.numpy()

    clouds = [t_cloud.from_numpy(sc, 1024, device="cpu") for sc in circ["scans"]]
    big = [t_cloud.from_numpy(sc, BIG, device="cpu") for sc in circ["big"]]
    for stage, cfg in (("stage1", STAGE1), ("stage2", STAGE2)):
        metrics = t_pipe.PairMetrics()
        c = t_pipe.PipelineConfig(output_root=str(tmp / f"{stage}_batched"), **cfg)
        poses = (t_pipe.run_stage1_fgr(c, clouds=clouds, n=N, metrics=metrics)
                 if stage == "stage1" else
                 t_pipe.run_stage2_mgicp(c, init_poses=circ["init"], clouds=big, n=N,
                                         metrics=metrics))
        out[stage] = dict(poses=poses, rows=metrics.rows)
    # stage 2 and run_pair on a 'points' axis of 2: every scan's finest level
    # holds more real rows than one 1024-row tile
    caps = t_cloud.plan_scale_caps(big, t_ms.create_scales(STAGE2["mgicp_scales"]))
    out["big_finest"] = [int(t_ms.build_pyramid(c, n_scales=2, scale_capacities=caps)[-1]
                             .mask.sum()) for c in big]
    out["run_pair"] = t_pipe.run_pair(t_pipe.PipelineConfig(
        output_root=str(tmp / "pair_single"), **PAIR), 2, 0, device="cpu")
    return out


def _multiscale_at_q_tile(src_pyr, tgt_pyr, T0):
    """``multiscale_gicp_pyramids`` (2 scales, 8 iterations) with the band
    sweep's tiles of Q_TILE rows."""
    dists = t_ms.max_correspondence_distances(t_ms.create_scales(2))
    T, its = T0, []
    for src, tgt, d in zip(src_pyr, tgt_pyr, dists):
        res = t_gicp.registration_gicp(src, tgt, d, T, max_iteration=8, q_tile=Q_TILE)
        its.append(res.iterations)
        T = res.transformation
    return res._replace(scale_iterations=torch.stack(its))


def _assert_real_rows_on_every_rank(n_valid: int, q_tile: int, ranks: int):
    """The band GICP splits the sorted tiles that hold real rows (masked rows
    sort last) over the ranks: the last rank's block starts below
    ``n_valid``, so every rank sweeps real rows."""
    n_tiles = max(-(-n_valid // q_tile), ranks)
    assert n_valid > (ranks - 1) * n_tiles // ranks * q_tile, (n_valid, q_tile, ranks)


def _jax_references(j) -> dict:
    """pcr_tpu's sharded forms on its virtual CPU mesh."""
    import jax
    import jax.numpy as jnp

    from pcr_tpu.parallel import distributed_pg as j_dpg
    from pcr_tpu.parallel import mesh as j_mesh
    from pcr_tpu.parallel import pair_sharding as j_ps
    from pcr_tpu.parallel import point_sharding as j_pts
    from pcr_tpu.utils import cloud as j_cloud
    from tests.test_torch_fpfh_sorted import _surface

    def res(r):
        return {k: np.asarray(v) for k, v in r._asdict().items() if v is not None}

    m4, q4, m24 = j_mesh.make_pair_mesh(4), j_mesh.make_point_mesh(4), j_mesh.make_2d_mesh(2, 4)
    out = {}
    src, tgt, T0, _ = j["pairs"]
    out["gicp_band"] = res(j_ps.sharded_batched_gicp(m4, src, tgt, jnp.asarray(T0), 0.3,
                                                     corr_method="band", max_iteration=10))
    first4 = functools.partial(jax.tree.map, lambda a: a[:N])
    out["mgicp"] = res(j_ps.sharded_mgicp(
        m4, first4(src.with_(normals=None, covariances=None)),
        first4(tgt.with_(normals=None, covariances=None)), jnp.asarray(T0[:N]), n_scales=2,
        iterations=8, scale_capacities=(512, 640)))
    fs_src, fs_tgt, fs, ft, opts, seeds, max_tuples = j["fgr"]
    out["fgr"] = res(j_ps.sharded_fgr(m4, fs_src, fs_tgt, fs, ft, jnp.asarray(seeds), opts,
                                      n_trials=4096, max_tuples=jnp.asarray(max_tuples)))
    stacked = j_cloud.stack_clouds(
        [j_cloud.from_numpy(_surface(np.random.default_rng(s)), capacity=1024)
         for s in range(N)])
    for kind, band in (("banded", 512), ("selection", 2048)):
        c, f = j_ps.sharded_fgr_features(m4, stacked, 0.2, features=kind, band=band)
        out[f"features_{kind}"] = dict(mask=np.asarray(c.mask), normals=np.asarray(c.normals),
                                       covariances=np.asarray(c.covariances),
                                       feats=np.asarray(f))
    q, r, m = (jnp.asarray(a) for a in j["nn"])
    out["nn1"] = [np.asarray(a) for a in j_pts.sharded_nn1(q4, q, r, m)]
    out["knn"] = [np.asarray(a) for a in j_pts.sharded_knn(q4, q[:512], r[:2048], m[:2048], 8)]
    src1, tgt1, T01, _, pyr_s, pyr_t = j["single"]
    for method in ("brute", "grid"):
        out[f"point_gicp_{method}"] = res(j_pts.point_sharded_gicp(
            q4, src1, tgt1, 0.3, T01, corr_method=method, max_iteration=10))
    out["point_mgicp"] = res(j_pts.point_sharded_multiscale_gicp(
        q4, pyr_s, pyr_t, T01, n_scales=2, iterations=8, corr_method="band"))
    src2, tgt2, T02, _ = j["pairs2"]
    out["gicp_2d"] = res(j_pts.sharded_gicp_2d(m24, src2, tgt2, 0.3, T02, corr_method="brute",
                                               max_iteration=10))
    out["mgicp_2d"] = res(j_pts.sharded_mgicp_2d(
        m24, src2.with_(normals=None, covariances=None),
        tgt2.with_(normals=None, covariances=None), T02, n_scales=2, iterations=8,
        scale_capacities=(256, 1024)))
    g = j["graph"]
    out["pad_edges"] = {k: np.asarray(v) for k, v in j_dpg.pad_edges(g, 4)._asdict().items()}
    out["pg_tridiag"] = np.asarray(j_dpg.distributed_optimize(m4, g, mu=10.0,
                                                              max_iterations=30).nodes)
    out["pg_global"] = np.asarray(j_dpg.distributed_global_optimization(
        m4, g, max_correspondence_distance=0.5).nodes)
    return out


# ---------------------------------------------------------------------------
# the mesh and its collectives
# ---------------------------------------------------------------------------

def test_mesh_layout_and_collectives(run):
    """Row-major layout (jax.make_mesh's order), per-axis groups, the rank's
    blocks, and the collectives every module calls: sums, rank-ordered
    gathers (bool too), broadcast, objects; a mesh that does not take the
    whole world raises."""
    outs = [o["mesh"] for o in run["out4"]]
    for r, o in enumerate(outs):
        assert o["shapes"] == [{"pairs": 4}, {"points": 4}, {"pairs": 2, "points": 2}]
        assert o["names"] == [("pairs",), ("points",), ("pairs", "points")]
        assert o["index_2d"] == (r // 2, r % 2) and o["group_sizes_2d"] == (2, 2)
        np.testing.assert_array_equal(o["reduce"], [6.0, 4.0])
        np.testing.assert_array_equal(o["reduce_points"], [sum(range(r // 2 * 2, r // 2 * 2 + 2))])
        np.testing.assert_array_equal(o["gather"], np.repeat(np.arange(4), 2)[:, None]
                                      * np.ones((1, 3), np.int32))
        np.testing.assert_array_equal(o["gather_bool"], [True, False, True, False])
        np.testing.assert_array_equal(o["gather_points"], [r // 2 * 2, r // 2 * 2 + 1])
        np.testing.assert_array_equal(o["broadcast"], [5.0])
        assert o["objects"] == [{"rank": k} for k in range(4)]
        assert o["pad"] == [0, 4, 4, 8] and o["init_again"] is True
        assert o["rank"] == (r, 4, 2)
        lo = r % 2
        assert o["blocks"] == [slice(lo * 7 // 2, (lo + 1) * 7 // 2), slice(lo * 4, lo * 4 + 4),
                               slice(2 * r, 2 * r + 2)]
        assert len(o["errors"]) == 2 and all("world of 4" in e for e in o["errors"])


def test_mesh_outside_a_launcher_names_torchrun():
    """A mesh of N > 1 devices needs N processes: without a launcher (and
    without a process group, as here) it raises before starting one, naming
    the torchrun command; the CLI's --devices raises the same."""
    import torch.distributed as dist

    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        t_mesh.make_pair_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 6"):
        t_mesh.make_2d_mesh(2, 3, device="cpu")
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        t_cli.main(["stage1", *ARGS, "--devices", "2"], device="cpu")
    assert not dist.is_initialized()


def test_sharded_functions_refuse_indivisible_batches(run):
    """pcr_tpu's ValueErrors: batches, scans, ref rows, source capacity and
    scale capacities that do not divide by the axis."""
    errors = run["out4"][0]["refusals"]
    assert len(errors) == 8, errors
    for e, want in zip(errors, ("pair batch 3", "pair batch 3", "scan batch 3", "pair batch 3",
                                "ref rows 4001", "source capacity 1022", "pair batch 3",
                                "scale capacities [255]")):
        assert e.startswith(want), (e, want)


def _same_on_every_rank(outs, key):
    """The replicated return: every rank's output equals rank 0's (but for
    the host-clock ``seconds`` of a metrics row and the file writes)."""
    def eq(a, b):
        if isinstance(a, dict):
            return all(eq(a[k], b[k]) for k in a if k not in ("seconds", "writes"))
        if isinstance(a, (list, tuple)):
            return all(eq(u, v) for u, v in zip(a, b))
        return np.array_equal(np.asarray(a), np.asarray(b))

    assert all(eq(outs[0][key], o[key]) for o in outs[1:]), key


# ---------------------------------------------------------------------------
# pair_sharding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["brute", "band"])
def test_sharded_batched_gicp(run, method):
    """8 pairs over 4 ranks: 1e-5 of the port's batched_gicp (the same
    operations a pair), 1e-4 of pcr_tpu's sharded band GICP, and within 1 cm
    of ground truth (tests/test_parallel.py)."""
    key = f"gicp_{method}"
    _same_on_every_rank(run["out4"], key)
    got = run["out4"][0][key]
    want = run["port"][key]
    np.testing.assert_allclose(got["transformation"], want["transformation"], atol=1e-5)
    np.testing.assert_allclose(got["fitness"], want["fitness"], atol=1e-5)
    np.testing.assert_array_equal(got["iterations"], want["iterations"])
    if method == "band":
        np.testing.assert_allclose(got["transformation"], run["jax"]["gicp_band"]["transformation"],
                                   atol=1e-4)
    T_gt = run["j"]["pairs"][3]
    for b in range(8):
        _, dt = se3.pose_errors(got["transformation"][b].astype(np.float64), T_gt[b])
        assert float(dt) < 0.01


def test_sharded_mgicp(run):
    """4 pairs over 4 ranks through the 2-scale pyramid: 1e-5 of the port's
    batched_mgicp (every scale's iterations equal), 5e-3 of pcr_tpu's."""
    _same_on_every_rank(run["out4"], "mgicp")
    got, want = run["out4"][0]["mgicp"], run["port"]["mgicp"]
    np.testing.assert_allclose(got["transformation"], want["transformation"], atol=1e-5)
    np.testing.assert_array_equal(got["scale_iterations"], want["scale_iterations"])
    assert got["scale_iterations"].shape == (N, 2)
    np.testing.assert_allclose(got["transformation"], run["jax"]["mgicp"]["transformation"],
                               atol=5e-3)


def test_sharded_fgr(run):
    """4 FGR pairs over 4 ranks (per-pair seeds and tuple caps sharded with
    the pairs) on JAX's uniforms: pose and fitness within 1e-4 of the port's
    batched FGR and of pcr_tpu's sharded FGR (tests/test_torch_batched.py's
    bound: its bumpy-circuit chunk, whose mutual matches are equal in both
    packages), within 0.25 m of ground truth."""
    _same_on_every_rank(run["out4"], "fgr")
    got = run["out4"][0]["fgr"]
    for want in (run["port"]["fgr"], run["jax"]["fgr"]):
        np.testing.assert_allclose(got["transformation"], want["transformation"], atol=1e-4)
        np.testing.assert_allclose(got["fitness"], want["fitness"], atol=1e-4)
    assert got["iterations"].tolist() == [300] * N
    for k in range(N):
        _, dt = se3.pose_errors(got["transformation"][k].astype(np.float64), run["j"]["fgr_gt"][k])
        assert float(dt) < 0.25, (k, dt)


@pytest.mark.parametrize("kind", ["banded", "selection"])
def test_sharded_fgr_features(run, kind):
    """4 surface patches over 4 ranks: equal to the port's batched features
    (1e-5; each scan runs the same function); against pcr_tpu's sharded
    features, tests/test_torch_batched.py's bounds (banded) or
    tests/test_torch_selection.py's (selection)."""
    from tests.test_torch_selection import (_assert_cov_match, _assert_fpfh_match,
                                            _assert_normals_match)

    key = f"features_{kind}"
    _same_on_every_rank(run["out4"], key)
    got, want, ref = run["out4"][0][key], run["port"][key], run["jax"][key]
    for leaf in ("points", "mask", "normals", "covariances", "feats"):
        np.testing.assert_allclose(got[leaf], want[leaf], atol=1e-5, err_msg=leaf)
    for b in range(N):
        M = ref["mask"][b]
        np.testing.assert_array_equal(got["mask"][b], M)
        if kind == "banded":
            Nj, Nt = ref["normals"][b][M], got["normals"][b][M]
            nd = np.minimum(np.linalg.norm(Nj - Nt, axis=1), np.linalg.norm(Nj + Nt, axis=1))
            assert (nd > 1e-4).sum() <= 1 and nd.max() < 1e-2, (b, np.sort(nd)[-3:])
            Fj, Ft = ref["feats"][b][M], got["feats"][b][M]
            l1 = np.abs(Fj - Ft).sum(1) / (np.abs(Fj).sum(1) + 1e-9)
            assert np.median(l1) < 2e-5 and np.percentile(l1, 99) < 1e-3 and l1.max() < 0.03
        else:
            _assert_normals_match(got["normals"][b], ref["normals"][b], ref["covariances"][b], M)
            _assert_cov_match(got["covariances"][b], ref["covariances"][b], M)
            _assert_fpfh_match(got["feats"][b], ref["feats"][b])


# ---------------------------------------------------------------------------
# point_sharding
# ---------------------------------------------------------------------------

def test_sharded_nn1(run):
    """Ref rows over 4 ranks: d2 within rtol 1e-6 of the port's nn1_exact,
    rows equal (ties go to the lowest shard, the unsharded scan order); and
    of pcr_tpu's sharded_nn1 (tests/test_torch_knn.py: the same selection by
    the expanded d2 and exact re-score in both)."""
    _same_on_every_rank(run["out4"], "nn1")
    (d, i), (d1, i1), (dj, ij) = run["out4"][0]["nn1"], run["port"]["nn1"], run["jax"]["nn1"]
    np.testing.assert_allclose(d, d1, rtol=1e-6)
    np.testing.assert_array_equal(i, i1)
    np.testing.assert_allclose(d, dj, rtol=1e-6, atol=1e-9)
    np.testing.assert_array_equal(i, ij)


def test_sharded_knn(run):
    """k = 8 with ref rows over 4 ranks: ascending d2 within rtol 1e-6 of the
    port's knn_exact and of pcr_tpu's sharded_knn; rows equal on 99.9%
    (exact ties may be listed in either order)."""
    _same_on_every_rank(run["out4"], "knn")
    d, i = run["out4"][0]["knn"]
    for d1, i1 in (run["port"]["knn"], run["jax"]["knn"]):
        np.testing.assert_allclose(d, d1, rtol=1e-6, atol=1e-7)
        assert (i == i1).mean() > 0.999
    assert (np.diff(d, axis=1) >= 0).all()


@pytest.mark.parametrize("method", ["brute", "band", "grid"])
def test_point_sharded_gicp(run, method):
    """Source rows over 4 ranks, (H, g) and the metric sums summed each
    iteration: 1e-5 of the unsharded registration_gicp (pose and fitness),
    the same iterations; brute and grid within 1e-4 of pcr_tpu's
    point_sharded_gicp of the same method; within 1 cm of ground truth.  The
    band sweep's tiles of Q_TILE rows give every rank real rows; the grid is
    built over the whole target on every rank."""
    key = f"point_gicp_{method}"
    s = run["x4"]["single"]
    _assert_real_rows_on_every_rank(int(s["s_mask"].sum()), Q_TILE, 4)
    _same_on_every_rank(run["out4"], key)
    got, want = run["out4"][0][key], run["port"][key]
    np.testing.assert_allclose(got["transformation"], want["transformation"], atol=1e-5)
    np.testing.assert_allclose(got["fitness"], want["fitness"], atol=1e-5)
    assert int(got["iterations"]) == int(want["iterations"])
    if method != "band":
        np.testing.assert_allclose(got["transformation"],
                                   run["jax"][key]["transformation"], atol=1e-4)
    _, dt = se3.pose_errors(got["transformation"].astype(np.float64), run["j"]["single"][3])
    assert float(dt) < 0.01


def test_point_sharded_grid_on_two_ranks(run):
    """The grid GICP with the source rows over a points axis of 2 (the
    pipeline spawn): within 1e-6 of one device (pose, fitness, rmse), the
    same iterations and correspondences, on both ranks; both halves of the
    source hold real rows."""
    s = run["x4"]["single"]
    half = s["s_mask"].shape[0] // 2
    assert s["s_mask"][:half].any() and s["s_mask"][half:].any()
    _same_on_every_rank(run["out2"], "point_gicp_grid")
    got, want = run["out2"][0]["point_gicp_grid"], run["port"]["point_gicp_grid"]
    for key in ("transformation", "fitness", "inlier_rmse"):
        np.testing.assert_allclose(got[key], want[key], atol=1e-6, err_msg=key)
    assert int(got["iterations"]) == int(want["iterations"])
    assert float(got["num_correspondences"]) == float(want["num_correspondences"])


def test_point_sharded_multiscale_gicp(run):
    """Both pyramid scales point-sharded, every rank sweeping real rows
    (tiles of Q_TILE rows): 5e-5 of multiscale_gicp_pyramids at those
    tiles, every scale's iterations equal; 1e-4 of pcr_tpu's (band)."""
    s = run["x4"]["single"]
    for i in range(2):
        _assert_real_rows_on_every_rank(int(s[f"ps{i}_mask"].sum()), Q_TILE, 4)
    _same_on_every_rank(run["out4"], "point_mgicp")
    got, want = run["out4"][0]["point_mgicp"], run["port"]["point_mgicp"]
    np.testing.assert_allclose(got["transformation"], want["transformation"], atol=5e-5)
    np.testing.assert_array_equal(got["scale_iterations"], want["scale_iterations"])
    np.testing.assert_allclose(got["transformation"], run["jax"]["point_mgicp"]["transformation"],
                               atol=1e-4)


def test_sharded_gicp_2d(run):
    """2 pairs on a (2, 2) mesh, brute: 5e-4 of batched_gicp, 1e-4 of
    pcr_tpu's (2, 4) mesh, within 2 cm of ground truth."""
    _same_on_every_rank(run["out4"], "gicp_2d")
    got = run["out4"][0]["gicp_2d"]
    np.testing.assert_allclose(got["transformation"], run["port"]["gicp_2d"]["transformation"],
                               atol=5e-4)
    np.testing.assert_allclose(got["transformation"], run["jax"]["gicp_2d"]["transformation"],
                               atol=1e-4)
    for b in range(2):
        _, dt = se3.pose_errors(got["transformation"][b].astype(np.float64),
                                run["j"]["pairs2"][3][b])
        assert float(dt) < 0.02


def test_sharded_mgicp_2d(run):
    """The 2-D product path (pyramids per pair block, every scale
    point-sharded, both 'points' ranks sweeping real rows in tiles of Q_TILE
    rows): 5e-4 of batched_mgicp at those tiles, 5e-3 of pcr_tpu's."""
    for valid in run["port"]["mgicp_2d_valid"]:
        for n_valid in valid:
            _assert_real_rows_on_every_rank(n_valid, Q_TILE, 2)
    _same_on_every_rank(run["out4"], "mgicp_2d")
    got = run["out4"][0]["mgicp_2d"]
    np.testing.assert_allclose(got["transformation"], run["port"]["mgicp_2d"]["transformation"],
                               atol=5e-4)
    np.testing.assert_allclose(got["transformation"], run["jax"]["mgicp_2d"]["transformation"],
                               atol=5e-3)
    for b in range(2):
        _, dt = se3.pose_errors(got["transformation"][b].astype(np.float64),
                                run["j"]["pairs2"][3][b])
        assert float(dt) < 0.02


# ---------------------------------------------------------------------------
# distributed_pg
# ---------------------------------------------------------------------------

def test_pad_edges(run):
    """18 edges padded to 20 with dead edges, leaf for leaf pcr_tpu's."""
    got, want = run["out4"][0]["pad_edges"], run["jax"]["pad_edges"]
    assert got["edge_src"].shape == (20,) and not got["edge_mask"][18:].any()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("solver", ["tridiag", "dense"])
def test_distributed_optimize(run, solver):
    """Edge shards over 4 ranks, the normal equations summed: nodes within
    5e-4 of the single-device LM pass and the final cost within 1e-3 (the
    summation order moves the last, converging steps, so iteration counts
    are not compared, as in tests/test_torch_pose_graph.py), the line
    process over the padded edge set; the circuit's nodes within 1e-4 of
    pcr_tpu's distributed_optimize."""
    key = f"pg_{solver}"
    _same_on_every_rank(run["out4"], key)
    got, want = run["out4"][0][key], run["port"][key]
    np.testing.assert_allclose(got["nodes"], want["nodes"], atol=5e-4)
    assert got["line_process"].shape == (20,)
    np.testing.assert_allclose(got["line_process"][:18], want["line_process"], atol=1e-4)
    np.testing.assert_allclose(got["cost"], want["cost"], rtol=1e-3)
    if solver == "tridiag":
        np.testing.assert_allclose(got["nodes"], run["jax"]["pg_tridiag"], atol=1e-4)


def test_distributed_global_optimization(run):
    """Optimise, prune, re-optimise: 5e-4 of global_optimization, 1e-4 of
    pcr_tpu's distributed form; the loop closes."""
    _same_on_every_rank(run["out4"], "pg_global")
    got = run["out4"][0]["pg_global"]
    np.testing.assert_allclose(got["nodes"], run["port"]["pg_global"], atol=5e-4)
    np.testing.assert_allclose(got["nodes"], run["jax"]["pg_global"], atol=1e-4)
    assert got["edge_mask"].all()


# ---------------------------------------------------------------------------
# the runners and the CLI
# ---------------------------------------------------------------------------

def _check_rows(rows, want_rows, keys):
    assert [(r["src"], r["tgt"]) for r in rows] == [(r["src"], r["tgt"]) for r in want_rows]
    for key in keys:
        assert [r.get(key) for r in rows] == [r.get(key) for r in want_rows], key


def test_stage1_on_a_pair_mesh(run):
    """run_stage1_fgr(mesh=) on 2 ranks (B = 2, scans featurized sharded,
    one GNC over each rank's pair) against the batched branch at B = 2:
    1e-4 on the poses, the same metrics rows; only rank 0 wrote the pose
    files; every pair within 0.25 m of ground truth."""
    _same_on_every_rank(run["out2"], "stage1")
    got, want = run["out2"][0]["stage1"], run["port"]["stage1"]
    np.testing.assert_allclose(got["poses"], want["poses"], atol=1e-4)
    _check_rows(got["rows"], want["rows"], ("stage",))
    assert [o["stage1"]["writes"] for o in run["out2"]] == [{"save_relative_circuit": 1}, {}]
    for k in range(N):
        _, dt = se3.pose_errors(got["poses"][k], run["circ"]["gt"][k])
        assert float(dt) < 0.25


@pytest.mark.parametrize("where", ["pairs", "pairs_points"])
def test_stage2_on_a_mesh(run, where):
    """run_stage2_mgicp(mesh=), the retry ladder on and pair (2, 1) thrown
    50 m off, against the branch without a mesh at batch_size 2: on a pair
    mesh of 2 ranks within 1e-6 (each pair runs the same operations), on a
    (2, 2) mesh within 5e-4, both 'points' ranks sweeping real rows; the
    thrown pair rescued in both (by the rank whose block holds it), the same
    statuses and iterations, gate fitness 1e-6; only rank 0 wrote the
    files."""
    if where == "pairs_points":
        for n_valid in run["port"]["big_finest"]:
            _assert_real_rows_on_every_rank(n_valid, 1024, 2)
    outs = run["out2"] if where == "pairs" else [o["stage2_2d"] for o in run["out4"]]
    outs = [{"stage2": o["stage2"]} if where == "pairs" else {"stage2": o} for o in outs]
    _same_on_every_rank(outs, "stage2")
    got, want = outs[0]["stage2"], run["port"]["stage2"]
    tol = 1e-6 if where == "pairs" else 5e-4
    np.testing.assert_allclose(got["poses"], want["poses"], atol=tol)
    _check_rows(got["rows"], want["rows"], ("status",)
                + (("scale_iterations",) if where == "pairs" else ()))
    np.testing.assert_allclose([r["gate_fitness"] for r in got["rows"]],
                               [r["gate_fitness"] for r in want["rows"]],
                               atol=1e-6 if where == "pairs" else 1e-3)
    assert got["rows"][1]["status"].startswith("retried"), got["rows"][1]
    _, dt = se3.pose_errors(got["poses"][1], run["circ"]["big_gt"][1])
    assert float(dt) < 0.1
    writes = [o["stage2"]["writes"] for o in outs]
    assert writes[0] == {"save_relative_circuit": 1, "save_absolute_poses": 1}
    assert all(w == {} for w in writes[1:])


def test_run_pair_on_a_point_mesh(run):
    """run_pair(point_mesh=make_point_mesh(2)) from its FGR seed, on scans
    whose finest level gives both ranks real rows: within 5e-5 of run_pair
    on one device (the point-sharded M-GICP bound), the same keys plus
    ``point_mesh``, and within 0.1 m of ground truth."""
    for scan in (2, 0):
        _assert_real_rows_on_every_rank(run["port"]["big_finest"][scan], 1024, 2)
    got = [o["run_pair"] for o in run["out2"]]
    want = run["port"]["run_pair"]
    assert got[0]["point_mesh"] == 2 and set(got[0]) == set(want) | {"point_mesh"}
    np.testing.assert_array_equal(got[0]["T"], got[1]["T"])
    np.testing.assert_allclose(got[0]["T"], want["T"], atol=5e-5)
    A = run["absolute"]
    _, dt = se3.pose_errors(np.asarray(got[0]["T"]), np.linalg.inv(A[0]) @ A[2])
    assert float(dt) < 0.1


@pytest.mark.parametrize("command", ["stage1", "stage2", "full"])
def test_cli_devices(run, command):
    """``--devices 2`` on 2 ranks over the 4-scan PCD circuit: rank 0 prints
    one JSON line with ``mesh``, rank 1 prints nothing; stage 1 gives the
    poses of run_stage1_fgr on the same mesh (the same clouds from the PCD
    files, the same B), stage 2 and full within 8 cm of ground truth
    (tests/test_torch_cli.py), full's stage-1 files as stage1's."""
    cli = [o["cli"][command] for o in run["out2"]]
    assert [c["rc"] for c in cli] == [0, 0] and len(cli[1]["lines"]) == 0
    (summary,) = cli[0]["lines"]
    assert summary["mesh"] == {"pairs": 2} and summary["command"] == command
    root = run["tmp"] / ("full" if command == "full" else "cli")
    rel1 = t_poses.load_relative_circuit(str(root / "relative_poses_FGR" / "Facade"), N)
    np.testing.assert_allclose(rel1, run["out2"][0]["stage1"]["poses"], atol=1e-9)
    if command == "stage1":
        return
    rel2 = t_poses.load_relative_circuit(str(root / "relative_poses_FGR_GICP" / "Facade"), N)
    for k in range(N):
        _, dt = se3.pose_errors(rel2[k], run["circ"]["gt"][k])
        assert float(dt) < 0.08, (k, dt)
    assert summary["success_rate"] > 0.7
    if command == "full":
        assert summary["methods"] == ["LUM", "SLERP", "SLERP_LUM", "pose_graph"]


def test_cli_stage3_ignores_devices(run):
    """``stage3 --devices 2`` builds the mesh and does not use it, as
    pcr_tpu's does: rank 0 alone runs it, and every method's poses equal
    (1e-9) those of stage3 without the flag."""
    cli = [o["cli"]["stage3"] for o in run["out2"]]
    assert len(cli[0]["lines"]) == 1 and not cli[1]["lines"]
    assert cli[0]["lines"][0]["methods"] == run["port"]["stage3"]["methods"]
    for m in cli[0]["lines"][0]["methods"]:
        got = t_poses.load_absolute_poses(
            str(run["tmp"] / "stage3" / f"absolute_poses_{m}" / "Facade"), N)
        want = t_poses.load_absolute_poses(
            str(run["tmp"] / "stage3_single" / f"absolute_poses_{m}" / "Facade"), N)
        np.testing.assert_allclose(got, want, atol=1e-9, err_msg=m)


# ---------------------------------------------------------------------------
# run_full on a pair mesh
# ---------------------------------------------------------------------------

METHODS = ["LUM", "SLERP", "SLERP_LUM", "pose_graph"]


def test_run_full_on_a_pair_mesh(run):
    """run_full(mesh=make_pair_mesh(4)) over an 8-scan circuit (B = 4, one
    pair a rank a chunk in stage 1, two pairs a rank in stage 2): every rank
    returns the same stage 1, 2 and 3 and the same metrics rows, bit for bit
    what the CLI's staged branch gave on the same mesh before run_full took
    one (stage 1, stage 2, then stage 3 on rank 0)."""
    outs = [o["run_full"] for o in run["out4"]]
    for key in ("stage1", "stage2", "stage3", "rows"):
        _same_on_every_rank(outs, key)
    got, staged = outs[0], outs[0]["staged"]
    for stage in ("stage1", "stage2"):
        assert got[stage].shape == (N_FULL, 4, 4)
        np.testing.assert_array_equal(got[stage], staged[stage], err_msg=stage)
    assert sorted(got["stage3"]) == sorted(staged["stage3"]) == METHODS
    for m in METHODS:
        np.testing.assert_array_equal(got["stage3"][m], staged["stage3"][m], err_msg=m)
    _check_rows(got["rows"], staged["rows"], ("stage", "fitness", "rmse", "status",
                                              "scale_iterations", "gate_fitness"))


def test_run_full_on_a_pair_mesh_writes_on_rank_0(run):
    """Only rank 0 wrote pose files (stage 1's relative poses, stage 2's
    relative and absolute ones, one absolute file a stage-3 method) and
    opened the span ``mesh.stage3``; every rank's ``collective`` spans add up
    to its counters ``collective.calls`` and ``collective.bytes``."""
    outs = [o["run_full"] for o in run["out4"]]
    assert outs[0]["writes"] == {"save_relative_circuit": 2, "save_absolute_poses": 5}
    assert all(o["writes"] == {} for o in outs[1:])
    assert ["mesh.stage3" in o["spans"] for o in outs] == [True, False, False, False]
    for o in outs:
        c = o["collective"]
        assert c["counters"] == {"collective.calls": c["calls"], "collective.bytes": c["bytes"]}
        assert {"all_gather_rows", "all_gather_objects", "broadcast_object",
                "barrier"} <= set(c["ops"]), c["ops"]
        assert c["bytes"] > 0


def test_run_full_on_a_pair_mesh_against_the_reference(run):
    """The pair mesh's stage-2 poses within nclt-seq32's ``gicp_mm`` and
    ``gicp_mdeg`` limits of the benchmark's plain reference, point-to-plane
    ICP from the truth at the cell's check settings."""
    from portbench import reference as ref
    from portbench import work

    root = Path(__file__).resolve().parent.parent
    limits = json.loads((root / "portbench" / "limits" / "nclt-seq32.json").read_text())
    scans, gt = run["circ"]["full"], run["circ"]["full_gt"]
    got = run["out4"][0]["run_full"]["stage2"]
    for k in range(N_FULL):
        s, t = t_pipe.circuit_pairs(N_FULL)[k]
        T_ref = ref.icp(scans[s], scans[t], gt[k], voxel=0.1, max_dist=0.2)
        mm, mdeg = work.pose_gap(got[k], T_ref)
        assert mm <= limits["gicp_mm"] and mdeg <= limits["gicp_mdeg"], (k, mm, mdeg)


def test_run_full_refuses_a_2d_mesh(run):
    """run_full on a (pairs, points) mesh raises on every rank, before any
    collective, naming the pair mesh it takes."""
    refusals = [o["run_full"]["refusal"] for o in run["out4"]]
    assert all(r is not None and "pair mesh" in r for r in refusals), refusals
