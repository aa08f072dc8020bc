"""The command line of the port: ``python -m pcr_tpu_torch``, with the
commands, arguments and defaults of ``python -m pcr_tpu``.

  python -m pcr_tpu_torch stage1 --dataset Facade          # FGR circuit
  python -m pcr_tpu_torch stage2 --dataset Facade          # M-GICP refine
  python -m pcr_tpu_torch stage3 --dataset Facade          # global refinement
  python -m pcr_tpu_torch full   --dataset NCLT            # all three (run_full)
  python -m pcr_tpu_torch pair   --dataset Courtyard --src 4 --tgt 2
  python -m pcr_tpu_torch report --dataset Facade          # PLY/plot artifacts

Scans are read from ``$PCR_REFERENCE_ROOT/nuvens/nuvens_pre_processadas/
<dataset>/s{i}.pcd`` onto the CUDA card.  Each stage persists poses in the
reference's text layout (pose_{i+1}_{i}.txt / pose{i}.txt), so stages restart
independently and read the shipped fixture files.  One JSON summary line is
printed at the end.

Device meshes, one process a device (``parallel/``):

  torchrun --nproc-per-node 4 -m pcr_tpu_torch full --dataset NCLT --devices 4
  torchrun --nproc-per-node 4 -m pcr_tpu_torch stage2 --devices 2 --shard-points 2
  torchrun --nproc-per-node 2 -m pcr_tpu_torch pair --dataset Courtyard \
      --src 4 --tgt 2 --shard-points 2

``--devices N`` shards the pairs of stage1 / stage2 / full over N ranks
(``--shard-points Q`` as well: stage 2 also splits each pair's source rows
over Q ranks, N x Q in all); ``pair --shard-points Q`` splits the pair's
source rows.  The mesh needs as many ranks as devices (``--devices 1`` runs
in this process).  ``stage3`` builds the mesh and does not use it, as
pcr_tpu's does.  Only rank 0 writes files and prints the summary line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m pcr_tpu_torch",
        description="Point-cloud registration with global refinement (PyTorch/CUDA)",
    )
    sub = p.add_subparsers(dest="command", required=True)

    def add_common(sp):
        sp.add_argument("--dataset", default="Facade",
                        choices=["NCLT", "Facade", "Courtyard"])
        sp.add_argument("--n", type=int, default=None,
                        help="number of scans (default: full circuit)")
        sp.add_argument("--voxel-size", type=float, default=0.1)
        sp.add_argument("--output-root", default="outputs")
        sp.add_argument("--batch-size", type=int, default=1)
        sp.add_argument("--devices", type=int, default=None,
                        help="shard pairs over N devices (N ranks)")
        sp.add_argument("--shard-points", type=int, default=None,
                        help="shard each pair's source rows over N devices")
        sp.add_argument("--trace", default=None, metavar="FILE",
                        help="record the port's spans and counters (utils/trace) and "
                             "write them to FILE as Chrome trace-event JSON")
        return sp

    add_common(sub.add_parser("stage1", help="FGR coarse pairwise registration"))
    s2 = add_common(sub.add_parser("stage2", help="multi-scale GICP refinement"))
    s2.add_argument("--scales", type=int, default=5)
    s2.add_argument("--iterations", type=int, default=100)
    s2.add_argument("--init", default=None,
                    help="relative-pose dir for initialization "
                         "(default: this run's stage-1 output; 'reference' "
                         "uses the shipped FGR fixtures)")
    s3 = add_common(sub.add_parser("stage3", help="global refinement shoot-out"))
    s3.add_argument("--methods", nargs="+",
                    default=["LUM", "SLERP", "SLERP_LUM", "pose_graph"])
    s3.add_argument("--relative", default=None,
                    help="relative-pose dir (default: this run's stage-2 "
                         "output; 'reference' uses the shipped FGR_GICP fixtures)")
    f = add_common(sub.add_parser("full", help="stages 1-3 end to end"))
    f.add_argument("--scales", type=int, default=5)
    f.add_argument("--iterations", type=int, default=100)
    pr = add_common(sub.add_parser(
        "pair", help="register one scan pair (for incomplete circuits, "
                     "e.g. Courtyard which ships only s2/s4)"))
    pr.add_argument("--src", type=int, required=True)
    pr.add_argument("--tgt", type=int, required=True)
    pr.add_argument("--init", default="fgr", choices=["fgr", "fixture"])
    pr.add_argument("--scales", type=int, default=5)
    pr.add_argument("--iterations", type=int, default=100)
    r = add_common(sub.add_parser("report", help="export trajectories + error plots"))
    r.add_argument("--methods", nargs="+",
                   default=["LUM", "SLERP", "SLERP_LUM", "pose_graph"])
    return p


def _config(args) -> "pipeline.PipelineConfig":
    from . import pipeline

    kw = dict(dataset=args.dataset, voxel_size=args.voxel_size,
              output_root=args.output_root, batch_size=args.batch_size)
    if getattr(args, "scales", None) is not None:
        kw["mgicp_scales"] = args.scales
    if getattr(args, "iterations", None) is not None:
        kw["mgicp_iterations"] = args.iterations
    return pipeline.PipelineConfig(**kw)


def _load_init(args, cfg, n, stage_dir, fixture_kind):
    import numpy as np

    from .utils import poses_io

    src = getattr(args, "init", None) or getattr(args, "relative", None)
    if src == "reference":
        rel = poses_io.load_reference_relative(fixture_kind, cfg.dataset)
        return np.asarray(rel)[:n]
    if src:
        return poses_io.load_relative_circuit(src, n)
    return poses_io.load_relative_circuit(cfg.out_dir(stage_dir), n)


def main(argv=None, device=None) -> int:
    """Run one command.  ``device`` is where every scan the command loads is
    placed (default: the CUDA card; without one pass "cpu"), and the
    backend of a mesh's process group when this call starts it (NCCL on
    the card, gloo on the CPU).  With ``--trace FILE`` the port's tracer is
    on for the command and rank 0 writes what it recorded to FILE."""
    args = _build_parser().parse_args(argv)
    if not args.trace:
        return _run(args, device)
    from .parallel import mesh as mesh_mod
    from .utils import trace

    trace.reset()
    trace.enable()
    try:
        code = _run(args, device)
    finally:
        trace.disable()
    if mesh_mod.rank() == 0:
        trace.write_chrome(trace.snapshot(), args.trace)
    return code


def _run(args, device) -> int:
    cfg = _config(args)

    from . import pipeline
    from .parallel import mesh as mesh_mod
    from .utils import collectives, poses_io

    n = args.n or poses_io.CIRCUIT_SIZES[cfg.dataset]
    t0 = time.time()
    summary: dict = {"command": args.command, "n": n,
                     "config": dataclasses.asdict(cfg)}
    mesh = pmesh = None
    if args.devices and args.shard_points and args.command != "pair":
        # pairs x points: stage 2 also splits every pair's source rows
        mesh = mesh_mod.make_2d_mesh(args.devices, args.shard_points, device=device)
        summary["mesh"] = {"pairs": args.devices, "points": args.shard_points}
    elif args.devices:
        mesh = mesh_mod.make_pair_mesh(args.devices, device=device)
        summary["mesh"] = {"pairs": args.devices}
    if args.command == "pair" and args.shard_points:
        pmesh = mesh_mod.make_point_mesh(args.shard_points, device=device)
    # a command that runs no sharded work runs on rank 0 alone, so that one
    # rank writes its files
    sharded = (args.command in ("stage1", "stage2", "full") and mesh is not None
               or pmesh is not None)
    lead = mesh_mod.rank() == 0

    def load():
        return pipeline._load_circuit_clouds(cfg, range(n), device=device)

    def stage2_rates(metrics):
        """Success at the gate's measurement (full-cloud fitness at
        2*voxel, what the retry ladder scores) and the finest-scale rate."""
        return {
            "success_rate": metrics.success_rate(
                cfg.fitness_gate, key="gate_fitness", stage="mgicp"),
            "success_rate_finest_scale": metrics.success_rate(
                cfg.fitness_gate, stage="mgicp"),
        }

    if not (sharded or lead):
        pass    # another rank runs this command
    elif args.command == "stage1":
        metrics = pipeline.PairMetrics()
        pipeline.run_stage1_fgr(cfg, clouds=load(), n=n, metrics=metrics, mesh=mesh)
        summary["success_rate"] = metrics.success_rate(cfg.fitness_gate)
    elif args.command == "stage2":
        init = _load_init(args, cfg, n, "relative_poses_FGR", "FGR")
        metrics = pipeline.PairMetrics()
        pipeline.run_stage2_mgicp(cfg, init_poses=init, clouds=load(), n=n, metrics=metrics,
                                  mesh=mesh)
        summary.update(stage2_rates(metrics))
    elif args.command == "stage3":
        rel = _load_init(args, cfg, n, "relative_poses_FGR_GICP", "FGR_GICP")
        # the closed forms need no scans; only the pose graph loads them
        clouds = load() if "pose_graph" in args.methods else None
        results = pipeline.run_stage3_global(cfg, relative_poses=rel, clouds=clouds, n=n,
                                             methods=tuple(args.methods))
        summary["methods"] = sorted(results)
    elif args.command == "full":
        metrics = pipeline.PairMetrics()
        clouds = load()
        if (mesh is None and cfg.batch_size <= 1
                or mesh is not None and mesh.axis_names == ("pairs",)):
            # without a mesh stage 2 streams behind stage 1 in one window; on a
            # pair mesh the staged runners, then stage 3 on rank 0 (run_full)
            out = pipeline.run_full(cfg, clouds=clouds, n=n, metrics=metrics, mesh=mesh)
            results = out["stage3"]
        else:
            rel1 = pipeline.run_stage1_fgr(cfg, clouds=clouds, n=n, metrics=metrics, mesh=mesh)
            rel2 = pipeline.run_stage2_mgicp(cfg, init_poses=rel1, clouds=clouds, n=n,
                                             metrics=metrics, mesh=mesh)
            # stage 3 is not sharded (as in pcr_tpu): rank 0 runs it
            results = (pipeline.run_stage3_global(cfg, relative_poses=rel2, clouds=clouds, n=n)
                       if lead else {})
        summary["methods"] = sorted(results)
        summary.update(stage2_rates(metrics))
        summary["stage1_success_rate"] = metrics.success_rate(cfg.fitness_gate, stage="fgr")
    elif args.command == "pair":
        out = pipeline.run_pair(cfg, args.src, args.tgt, init=args.init, point_mesh=pmesh,
                                device=device)
        summary.update(out)
    elif args.command == "report":
        import numpy as np

        from . import viz

        results = {}
        for name in args.methods:
            try:
                results[name] = poses_io.load_absolute_poses(
                    cfg.out_dir(f"absolute_poses_{name}"), n)
            except FileNotFoundError:
                print(f"skipping {name}: no saved poses", file=sys.stderr)
        try:
            ref = np.asarray(poses_io.load_reference_absolute(cfg.dataset))[:n]
        except (FileNotFoundError, KeyError):
            ref = None
        paths = viz.report_circuit(cfg.out_dir("report"), None, results, reference=ref)
        summary["artifacts"] = paths

    if mesh is not None or pmesh is not None:
        collectives.barrier()
    summary["seconds"] = round(time.time() - t0, 2)
    if lead:
        print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
