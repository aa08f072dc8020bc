#!/usr/bin/env python3
"""What the four-card cell's stage 1 and gate read, on one card, against the
plain reference (``portbench/reference.py``) from the truth.

    python3 tools/mesh_witness.py [--seeds 5000000029,2147483659] [--out FILE]

Makes the cell ``nclt-seq128-4card``'s 128 scans from each seed, as its kind
does, then on ``cuda:0``:

* stage 1 two ways: the streamed branch (``batch_size`` 1: each scan's
  features at its own capacity bucket, one FGR a pair), and the batched
  branch at ``batch_size`` 4 with no mesh, which computes what a pair mesh
  of four ranks computes (chunks of 4 pairs, each chunk's scans compacted to
  its largest bucket, one GNC over the chunk).  Each pair's gap to the
  reference's ICP pose, in mm.  For the batched branch's worst pair: that
  pair alone through the streamed step with its features at the chunk's
  capacity, which separates the features' capacity from the batched GNC,
  and how many of its feature rows and mutual matches differ between the
  two capacities;
* the gate (fitness at 2 x voxel) at the stage-2 poses three ways: the band
  NN (K1) on the full clouds (``run_stage2_mgicp``'s gate, which a pair mesh
  runs), the band NN on the scans compacted to their buckets
  (``run_full``'s streamed gate), and the exact NN (K7), each against
  ``reference.fitness``.  For the worst pair: the band NN's plain version on
  the CPU at band 2048 and 8192.

Prints one JSON line a seed (and appends it to ``--out``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from portbench import reference as ref  # noqa: E402
from portbench import run  # noqa: E402
from portbench.kinds import circuit  # noqa: E402
from portbench.work import pose_gap  # noqa: E402

WORKLOAD = "nclt-seq128-4card"


def _worst(values, k=3):
    order = np.argsort(values)[::-1][:k]
    return [[int(i), float(values[i])] for i in order]


def stage1(runner, pc, T_ref):
    from pcr_tpu_torch import pipeline
    from pcr_tpu_torch.models import fgr as fgr_mod

    n, clouds = runner.n, runner.clouds
    out, rel = {}, {}
    for name, bs in (("streamed", 1), ("batched4", 4)):
        t0 = time.perf_counter()
        rel[name] = pipeline.run_stage1_fgr(dataclasses.replace(pc, batch_size=bs),
                                            clouds=clouds, n=n)
        gaps = np.array([pose_gap(rel[name][k], T_ref[k])[0] for k in range(n)])
        out[name] = {"max_mm": float(gaps.max()), "median_mm": float(np.median(gaps)),
                     "over_1m": int((gaps > 1000).sum()), "worst": _worst(gaps),
                     "s": time.perf_counter() - t0}
    # the batched branch's worst pair, alone, with its features at the chunk's capacity
    k = out["batched4"]["worst"][0][0]
    s, t = pipeline.circuit_pairs(n)[k]
    buckets = pipeline._buckets(clouds, n, pc.bucket_granularity)
    start = (k // 4) * 4
    chunk_cap = max(buckets[(start + j) % n] for j in range(min(4, n - start) + 1))
    tuples = max(int(0.2 * max(buckets[s], buckets[t])), 256)
    dig = {"pair": k, "src": s, "tgt": t, "own_buckets": [buckets[s], buckets[t]],
           "chunk_capacity": chunk_cap}
    feats = {}
    for name, (cs, ct) in (("own", (buckets[s], buckets[t])), ("chunk", (chunk_cap, chunk_cap))):
        src_f, fs = pipeline._prep_features(clouds[s], cs, pc.voxel_size, pc.stage1_band,
                                            pc.stage1_features)
        tgt_f, ft = pipeline._prep_features(clouds[t], ct, pc.voxel_size, pc.stage1_band,
                                            pc.stage1_features)
        B = max(src_f.capacity, tgt_f.capacity)
        opts = fgr_mod.default_options_capacity(B, pc.voxel_size)
        src_p, fsp, tgt_p, ftp = pipeline._pad_pair(src_f, fs, tgt_f, ft, B)
        res = fgr_mod.registration_fgr(src_p, tgt_p, fsp, ftp, opts, seed=pc.fgr_seed + s,
                                       max_tuples=tuples)
        T = res.transformation.double().cpu().numpy()
        _, cj, cm = fgr_mod.match_features(fsp, src_p.mask, ftp, tgt_p.mask)
        feats[name] = (fs, ft, cj, cm)
        dig[f"fgr_{name}_capacity_mm"] = pose_gap(T, T_ref[k])[0]
        dig[f"mutual_{name}"] = int(cm.sum())
    ns, nt = int(clouds[s].mask.sum()), int(clouds[t].mask.sum())
    (fs0, ft0, cj0, cm0), (fs1, ft1, cj1, cm1) = feats["own"], feats["chunk"]
    dig["feature_rows_differing"] = [
        int((torch.abs(fs0[:ns] - fs1[:ns]).amax(dim=1) > 1e-3).sum()),
        int((torch.abs(ft0[:nt] - ft1[:nt]).amax(dim=1) > 1e-3).sum())]
    same = cm0[:ns] & cm1[:ns] & (cj0[:ns] == cj1[:ns])
    dig["mutual_matches_shared"] = int(same.sum())
    out["dig"] = dig
    return out, rel["streamed"]


def gate(runner, pc, init):
    from pcr_tpu_torch import pipeline
    from pcr_tpu_torch.models import evaluate as eval_mod
    from pcr_tpu_torch.utils import cloud as cloud_mod

    n, clouds, scans = runner.n, runner.clouds, runner.scans
    metrics = pipeline.PairMetrics()
    rel = pipeline.run_stage2_mgicp(pc, init_poses=init, clouds=clouds, n=n, metrics=metrics)
    pairs = pipeline.circuit_pairs(n)
    full = {(r["src"], r["tgt"]): r["gate_fitness"] for r in metrics.rows if r["stage"] == "mgicp"}
    buckets = pipeline._buckets(clouds, n, pc.bucket_granularity)
    d = 2 * pc.voxel_size
    rows = []
    for k, (s, t) in enumerate(pairs):
        T = np.asarray(rel[k], np.float32)
        B = max(buckets[s], buckets[t])
        sp = cloud_mod.pad_to(cloud_mod.compact(clouds[s], buckets[s]), B)
        tp = cloud_mod.pad_to(cloud_mod.compact(clouds[t], buckets[t]), B)
        compact = float(eval_mod.evaluate_registration(sp, tp, d, T)[0])
        exact = float(eval_mod.evaluate_registration(clouds[s], clouds[t], d, T,
                                                     method="exact")[0])
        r = ref.fitness(scans[s], scans[t], rel[k], runner.cfg["check"]["gate_dist"])
        rows.append((full[(s, t)], compact, exact, r))
    a = np.array(rows)
    gaps = np.abs(a[:, :3] - a[:, 3:4])
    out = {name: {"max": float(gaps[:, i].max()), "worst": _worst(gaps[:, i])}
           for i, name in enumerate(("band_full", "band_compact", "exact"))}
    k = int(np.argmax(gaps[:, 0]))
    s, t = pairs[k]
    cap = runner.cfg["scans"]["capacity"]
    src = cloud_mod.from_numpy(scans[s], cap, device="cpu")
    tgt = cloud_mod.from_numpy(scans[t], cap, device="cpu")
    T = np.asarray(rel[k], np.float32)
    out["worst_pair"] = {
        "pair": k, "fitness": dict(zip(("band_full", "band_compact", "exact", "reference"),
                                       map(float, a[k]))),
        "cpu_band_2048": float(eval_mod.evaluate_registration(src, tgt, d, T, band=2048)[0]),
        "cpu_band_8192": float(eval_mod.evaluate_registration(src, tgt, d, T, band=8192)[0])}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", default="5000000029,2147483659")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = run.load_spec(ROOT, WORKLOAD)
    traffic = {"kind": "circuit", "scans": spec["traffic"]["scans"],
               "methods": spec["traffic"]["methods"]}
    dev = torch.device("cuda", 0)
    for seed in [int(s) for s in args.seeds.split(",")]:
        with tempfile.TemporaryDirectory(prefix="mesh-witness-") as tmp:
            runner = circuit.Runner(spec["config"], traffic, seed, dev, tmp)
            runner.setup()
            pc = runner.pipeline_config("w")
            T_ref = runner._icp()
            s1, init = stage1(runner, pc, T_ref)
            line = json.dumps({"seed": seed, "stage1": s1, "gate": gate(runner, pc, init)})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
