"""The ranks of tests/test_torch_parallel.py: gloo process groups on the CPU.

``start(world, task, inputs, tmp)`` spawns ``world`` daemon processes, each of
which joins a gloo group through a FileStore under ``tmp`` (no TCP port, so
test workers never collide) with a 90 s collective timeout, runs
``TASKS[task]`` on the pickled ``inputs`` and pickles its output dict.
``Ranks.join()`` waits with a time limit, kills every rank as soon as one
fails or the limit passes, and returns the outputs in rank order;
``Ranks.kill()`` ends whatever still runs.

This module imports only torch, numpy and pcr_tpu_torch: the ranks must not
import jax or pcr_tpu.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import io
import json
import multiprocessing as mp
import os
import pickle
import time
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

COLLECTIVE_TIMEOUT = timedelta(seconds=90)


class Ranks:
    def __init__(self, procs, tmp: str, limit_s: float):
        self.procs, self.tmp, self.deadline = procs, tmp, time.time() + limit_s

    def join(self) -> list[dict]:
        try:
            while any(p.is_alive() for p in self.procs):
                failed = [p.exitcode for p in self.procs if p.exitcode not in (None, 0)]
                if failed or time.time() > self.deadline:
                    raise AssertionError(f"ranks failed or overran: exit codes "
                                         f"{[p.exitcode for p in self.procs]}")
                time.sleep(0.05)
        finally:
            self.kill()
        codes = [p.exitcode for p in self.procs]
        assert codes == [0] * len(codes), f"rank exit codes {codes}"
        outs = []
        for r in range(len(self.procs)):
            with open(os.path.join(self.tmp, f"out{r}.pkl"), "rb") as fh:
                outs.append(pickle.load(fh))
        return outs

    def kill(self) -> None:
        for p in self.procs:
            if p.is_alive():
                p.kill()
            p.join(10)


def start(world: int, task: str, inputs: dict, tmp, limit_s: float = 240) -> Ranks:
    tmp = str(tmp)
    os.makedirs(tmp, exist_ok=True)
    with open(os.path.join(tmp, "inputs.pkl"), "wb") as fh:
        pickle.dump(inputs, fh)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, world, tmp, task), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    return Ranks(procs, tmp, limit_s)


def _rank_main(rank: int, world: int, tmp: str, task: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
                            rank=rank, world_size=world, timeout=COLLECTIVE_TIMEOUT)
    with open(os.path.join(tmp, "inputs.pkl"), "rb") as fh:
        inputs = pickle.load(fh)
    out = TASKS[task](inputs)
    with open(os.path.join(tmp, f"out{rank}.pkl"), "wb") as fh:
        pickle.dump(out, fh)
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def cloud(d: dict, prefix: str = ""):
    """A port Cloud on the CPU from numpy leaves ``{prefix}points``, ...;
    stacked leaves give a stacked Cloud."""
    from pcr_tpu_torch.utils.cloud import Cloud

    def get(k):
        x = d.get(prefix + k)
        return None if x is None else torch.as_tensor(np.array(x))

    return Cloud(points=get("points"), mask=get("mask"), normals=get("normals"),
                 covariances=get("covariances"))


def result_np(res) -> dict:
    return {k: None if v is None else v.cpu().numpy() for k, v in res._asdict().items()}


def graph(d: dict):
    from pcr_tpu_torch.models.global_refine import pose_graph as pg

    leaves = [torch.as_tensor(np.array(d[k])) for k in pg.PoseGraph._fields]
    leaves[1], leaves[2] = leaves[1].long(), leaves[2].long()
    return pg.PoseGraph(*leaves)


def _counting(module, names, counts):
    """Count the calls of ``module.<name>`` (the pose-file writers)."""
    for name in names:
        fn = getattr(module, name)

        def counted(*a, _fn=fn, _name=name, **k):
            counts[_name] = counts.get(_name, 0) + 1
            return _fn(*a, **k)

        setattr(module, name, counted)


# ---------------------------------------------------------------------------
# tasks
# ---------------------------------------------------------------------------

def task_functions(x: dict) -> dict:
    """Every public function of parallel/ on 4 ranks: pair mesh (4), point
    mesh (4), (pairs 2, points 2) mesh; then stage 2 on the 2-D mesh and
    run_full on the pair mesh."""
    from pcr_tpu_torch.models.fgr import FgrOptions
    from pcr_tpu_torch.parallel import distributed_pg, mesh, pair_sharding, point_sharding
    from pcr_tpu_torch.utils import collectives as coll

    pm = mesh.make_pair_mesh(4, device="cpu")
    qm = mesh.make_point_mesh(4, device="cpu")
    m2 = mesh.make_2d_mesh(2, 2, device="cpu")
    me = dist.get_rank()
    out: dict = {"mesh": dict(
        shapes=[pm.shape, qm.shape, m2.shape], names=[pm.axis_names, qm.axis_names, m2.axis_names],
        index_2d=(m2.index("pairs"), m2.index("points")),
        group_sizes_2d=(dist.get_world_size(m2.group("pairs")),
                        dist.get_world_size(m2.group("points"))),
        reduce=coll.all_reduce_sum(torch.tensor([float(me), 1.0])).numpy(),
        reduce_points=coll.all_reduce_sum(torch.tensor([float(me)]), m2.group("points")).numpy(),
        gather=coll.all_gather_rows(torch.full((2, 3), me, dtype=torch.int32)).numpy(),
        gather_bool=coll.all_gather_rows(torch.tensor([me % 2 == 0])).numpy(),
        gather_points=coll.all_gather_rows(torch.tensor([me]), m2.group("points")).numpy(),
        broadcast=coll.broadcast(torch.tensor([float(me) + 5.0])).numpy(),
        objects=coll.all_gather_objects({"rank": me}),
        pad=[mesh.pad_to_multiple(n, 4) for n in (0, 1, 4, 5)],
        rank=(mesh.rank(), mesh.world_size(), coll.group_size(m2.group("points"))),
        blocks=[coll.rank_block(n, m2.group("points")) for n in (7, 8)] + [pm.block("pairs", 8)])}
    errors = []
    for make in (lambda: mesh.make_pair_mesh(3, device="cpu"),
                 lambda: mesh.make_2d_mesh(2, 4, device="cpu")):
        try:
            make()
        except ValueError as e:
            errors.append(str(e))
    out["mesh"]["errors"] = errors
    out["mesh"]["init_again"] = mesh.maybe_initialize_distributed(device="cpu")

    p = x["pairs"]
    src, tgt = cloud(p, "s_"), cloud(p, "t_")
    for method in ("brute", "band"):
        out[f"gicp_{method}"] = result_np(pair_sharding.sharded_batched_gicp(
            pm, src, tgt, p["T0"], 0.3, corr_method=method, max_iteration=10))
    r = x["raw"]
    out["mgicp"] = result_np(pair_sharding.sharded_mgicp(
        pm, cloud(r, "s_"), cloud(r, "t_"), r["T0"], n_scales=2, iterations=8,
        scale_capacities=r["caps"]))
    f = x["fgr"]
    out["fgr"] = result_np(pair_sharding.sharded_fgr(
        pm, cloud(f, "s_"), cloud(f, "t_"), torch.as_tensor(f["fs"]), torch.as_tensor(f["ft"]),
        list(f["seeds"]), FgrOptions(*f["opts"]), n_trials=f["n_trials"],
        max_tuples=list(f["max_tuples"]), u=torch.as_tensor(f["u"])))
    for kind, band in (("banded", 512), ("selection", 2048)):
        c, feats = pair_sharding.sharded_fgr_features(pm, cloud(x["scans"]), 0.2,
                                                      features=kind, band=band)
        out[f"features_{kind}"] = dict(points=c.points.numpy(), mask=c.mask.numpy(),
                                       normals=c.normals.numpy(),
                                       covariances=c.covariances.numpy(), feats=feats.numpy())
    n = x["nn"]
    q, ref, m = (torch.as_tensor(n[k]) for k in ("q", "r", "m"))
    out["nn1"] = [t.numpy() for t in point_sharding.sharded_nn1(qm, q, ref, m)]
    out["knn"] = [t.numpy() for t in point_sharding.sharded_knn(qm, q[:512], ref[:2048],
                                                                m[:2048], 8)]
    s = x["single"]
    for method in ("brute", "band", "grid"):
        out[f"point_gicp_{method}"] = result_np(point_sharding.point_sharded_gicp(
            qm, cloud(s, "s_"), cloud(s, "t_"), 0.3, s["T0"], corr_method=method,
            max_iteration=10, q_tile=s["q_tile"]))
    pyr = [(cloud(s, f"ps{i}_"), cloud(s, f"pt{i}_")) for i in range(2)]
    out["point_mgicp"] = result_np(point_sharding.point_sharded_multiscale_gicp(
        qm, [a for a, _ in pyr], [b for _, b in pyr], s["T0"], n_scales=2, iterations=8,
        q_tile=s["q_tile"]))
    t2 = x["pairs2"]
    out["gicp_2d"] = result_np(point_sharding.sharded_gicp_2d(
        m2, cloud(t2, "s_"), cloud(t2, "t_"), 0.3, t2["T0"], corr_method="brute",
        max_iteration=10))
    out["mgicp_2d"] = result_np(point_sharding.sharded_mgicp_2d(
        m2, cloud(t2, "rs_"), cloud(t2, "rt_"), t2["T0"], n_scales=2, iterations=8,
        scale_capacities=t2["caps"], q_tile=t2["q_tile"]))
    g = graph(x["graph"])
    padded = distributed_pg.pad_edges(g, 4)
    out["pad_edges"] = {k: v.numpy() for k, v in padded._asdict().items()}
    for solver in ("tridiag", "dense"):
        res = distributed_pg.distributed_optimize(pm, g, mu=10.0, max_iterations=30,
                                                  solver=solver)
        out[f"pg_{solver}"] = dict(nodes=res.nodes.numpy(), cost=res.final_cost,
                                   iterations=res.iterations_used,
                                   line_process=res.line_process.numpy())
    glob = distributed_pg.distributed_global_optimization(pm, g, max_correspondence_distance=0.5)
    out["pg_global"] = dict(nodes=glob.nodes.numpy(), edge_mask=glob.edge_mask.numpy())
    out["stage2_2d"] = _stage2(x["stage2"], m2)
    out["refusals"] = _refusals(pm, qm, m2, src, tgt, p["T0"], x)
    out["run_full"] = _run_full(x["full"], pm, m2)
    return out


def _refusals(pm, qm, m2, src, tgt, T0, x) -> list[str]:
    """The ValueErrors of indivisible batches and capacities (raised before
    any collective)."""
    from pcr_tpu_torch.parallel import pair_sharding, point_sharding

    n = x["nn"]
    scans = cloud(x["scans"])
    s = cloud(x["single"], "s_")
    calls = [
        lambda: pair_sharding.sharded_batched_gicp(pm, src[:3], tgt[:3], T0[:3], 0.3),
        lambda: pair_sharding.sharded_mgicp(pm, src[:3], tgt[:3], T0[:3]),
        lambda: pair_sharding.sharded_fgr_features(pm, scans[:3], 0.2),
        lambda: pair_sharding.sharded_fgr(pm, src[:3], tgt[:3], None, None, [0, 1, 2], None),
        lambda: point_sharding.sharded_nn1(qm, torch.as_tensor(n["q"]),
                                           torch.as_tensor(n["r"][:4001]),
                                           torch.as_tensor(n["m"][:4001])),
        lambda: point_sharding.point_sharded_gicp(qm, s[:1022], s, 0.3, np.eye(4)),
        lambda: point_sharding.sharded_gicp_2d(m2, src[:3], tgt[:3], 0.3, T0[:3]),
        lambda: point_sharding.sharded_mgicp_2d(m2, src[:2], tgt[:2], T0[:2],
                                                scale_capacities=(255, 640)),
    ]
    errors = []
    for call in calls:
        try:
            call()
        except ValueError as e:
            errors.append(str(e))
    return errors


def _stage2(x: dict, m):
    """run_stage2_mgicp on mesh ``m`` over ``x``'s circuit; its poses, rows
    and the calls of the pose-file writers on this rank."""
    from pcr_tpu_torch import pipeline
    from pcr_tpu_torch.utils import cloud as cloud_mod

    counts: dict = {}
    _counting(pipeline.poses_io, ("save_relative_circuit", "save_absolute_poses"), counts)
    cfg = pipeline.PipelineConfig(output_root=x["out"], **x["cfg"])
    metrics = pipeline.PairMetrics()
    poses = pipeline.run_stage2_mgicp(
        cfg, init_poses=x["init"], n=len(x["scans"]), mesh=m, metrics=metrics,
        clouds=[cloud_mod.from_numpy(s, x["capacity"], device="cpu") for s in x["scans"]])
    return dict(poses=poses, rows=metrics.rows, writes=dict(counts))


def _run_full(x: dict, pm, m2) -> dict:
    """run_full(mesh=) on the pair mesh over ``x``'s circuit, traced, this
    rank's pose-file writes counted; then the CLI's staged branch from before
    run_full took a mesh, on the same mesh (stage 1, stage 2, stage 3 on rank
    0 alone); and run_full on the (pairs, points) mesh, which is refused."""
    from pcr_tpu_torch import pipeline
    from pcr_tpu_torch.utils import cloud as cloud_mod
    from pcr_tpu_torch.utils import trace

    counts: dict = {}
    _counting(pipeline.poses_io, ("save_relative_circuit", "save_absolute_poses"), counts)
    clouds = [cloud_mod.from_numpy(s, x["capacity"], device="cpu") for s in x["scans"]]
    n = len(clouds)
    cfg = pipeline.PipelineConfig(output_root=x["out"] + "/run_full", **x["cfg"])
    metrics = pipeline.PairMetrics()
    trace.reset()
    trace.enable()
    try:
        full = pipeline.run_full(cfg, clouds=clouds, n=n, metrics=metrics, mesh=pm)
    finally:
        trace.disable()
    snap = trace.snapshot()
    writes = dict(counts)
    staged_cfg = dataclasses.replace(cfg, output_root=x["out"] + "/staged")
    staged = pipeline.PairMetrics()
    rel1 = pipeline.run_stage1_fgr(staged_cfg, clouds=clouds, n=n, metrics=staged, mesh=pm)
    rel2 = pipeline.run_stage2_mgicp(staged_cfg, init_poses=rel1, clouds=clouds, n=n,
                                     metrics=staged, mesh=pm)
    stage3 = (pipeline.run_stage3_global(staged_cfg, relative_poses=rel2, clouds=clouds, n=n)
              if dist.get_rank() == 0 else {})
    try:
        pipeline.run_full(cfg, clouds=clouds, n=n, mesh=m2)
        refusal = None
    except ValueError as e:
        refusal = str(e)
    collective = [s[5] for s in snap.spans if s[0] == "collective"]
    return dict(
        stage1=full["stage1"], stage2=full["stage2"], stage3=full["stage3"], rows=metrics.rows,
        writes=writes, spans=sorted({s[0] for s in snap.spans}),
        collective=dict(ops=sorted({a["op"] for a in collective}),
                        calls=len(collective), bytes=sum(a["bytes"] for a in collective),
                        counters={k: v for k, v in snap.counters.items()
                                  if k.startswith("collective.")}),
        staged=dict(stage1=rel1, stage2=rel2, stage3=stage3, rows=staged.rows),
        refusal=refusal)


def task_pipeline(x: dict) -> dict:
    """The runners, the grid GICP on a points axis of 2 and the CLI on 2
    ranks."""
    from pcr_tpu_torch import __main__ as cli
    from pcr_tpu_torch import pipeline
    from pcr_tpu_torch.parallel import mesh, point_sharding
    from pcr_tpu_torch.utils import cloud as cloud_mod
    from pcr_tpu_torch.utils import poses_io

    pm = mesh.make_pair_mesh(2, device="cpu")
    out: dict = {}
    s1 = x["stage1"]
    counts: dict = {}
    _counting(pipeline.poses_io, ("save_relative_circuit",), counts)
    cfg = pipeline.PipelineConfig(output_root=s1["out"], **s1["cfg"])
    metrics = pipeline.PairMetrics()
    poses = pipeline.run_stage1_fgr(
        cfg, n=len(s1["scans"]), mesh=pm, metrics=metrics,
        clouds=[cloud_mod.from_numpy(s, s1["capacity"], device="cpu") for s in s1["scans"]])
    out["stage1"] = dict(poses=poses, rows=metrics.rows, writes=dict(counts))
    out["stage2"] = _stage2(x["stage2"], pm)

    # the CLI over the PCD dataset the parent wrote
    c = x["cli"]
    poses_io.REFERENCE_ROOT = c["root"]
    poses_io.CIRCUIT_SIZES["Facade"] = c["n"]
    cloud_mod.BUCKETS["Facade"] = c["bucket"]
    cloud_mod.BUCKETS["Courtyard"] = c["pair_bucket"]
    pipeline.PipelineConfig = functools.partial(pipeline.PipelineConfig, **c["small"])
    qm = mesh.make_point_mesh(2, device="cpu")
    s = x["single"]
    out["point_gicp_grid"] = result_np(point_sharding.point_sharded_gicp(
        qm, cloud(s, "s_"), cloud(s, "t_"), 0.3, s["T0"], corr_method="grid", max_iteration=10))
    pcfg = pipeline.PipelineConfig(output_root=c["out"] + "/run_pair", **c["pair_cfg"])
    out["run_pair"] = pipeline.run_pair(pcfg, 2, 0, point_mesh=qm, device="cpu")
    out["cli"] = {}
    for name, argv in c["argv"].items():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv, device="cpu")
        lines = [line for line in buf.getvalue().splitlines() if line.strip()]
        out["cli"][name] = dict(rc=rc, lines=[json.loads(line) for line in lines])
    return out


def task_collectives(x: dict) -> dict:
    """Each collective of ``x["ops"]`` alone with the tracer on: all_gather_rows
    of a (rows, 3) float32 block, all_gather_objects and broadcast_object of
    ``x["object"]``; the spans (name, attributes) and the counters
    ``collective.*`` of each."""
    from pcr_tpu_torch.utils import collectives as coll
    from pcr_tpu_torch.utils import trace

    calls = {
        "all_gather_rows": lambda: coll.all_gather_rows(
            torch.full((x["rows"], 3), float(dist.get_rank()))),
        "all_gather_objects": lambda: coll.all_gather_objects(x["object"]),
        "broadcast_object": lambda: coll.broadcast_object(x["object"]),
    }
    out = {}
    for op in x["ops"]:
        trace.reset()
        trace.enable()
        try:
            calls[op]()
        finally:
            trace.disable()
        snap = trace.snapshot()
        out[op] = dict(spans=[(s[0], s[5]) for s in snap.spans],
                       counters={k: v for k, v in snap.counters.items()
                                 if k.startswith("collective.")})
    return out


TASKS = {"functions": task_functions, "pipeline": task_pipeline,
         "collectives": task_collectives}
