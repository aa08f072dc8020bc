#!/usr/bin/env python3
"""Where the k-connectivity graph builders spend their time, and how the
doubling M-GICP's band search holds against the brute one, on one GPU, over
chip_smoke.py's Facade-scale circuit (phase 22's scans and call).

    python3 tools/profile_graph_builder.py [OTHER_CHECKOUT]

  1. band against brute: pairs 3->5, 4->5 and 5->6 from their FGR pose
     (absolute scale, the builders' seeds) through the doubling M-GICP's
     three scales, once with the band GICP (kernel K1) and once with the
     brute one (K7): each scale's points, iterations, fitness and error
     against ground truth, and the 2*voxel gate fitness of both searches at
     the end.  With OTHER_CHECKOUT, the same with that checkout's package
     (the scans still come from this checkout's chip_smoke.py);
  2. the builders warm (full_registration_batched at batch 2, then
     full_registration, each run twice, the second read): walls and the
     time in features (and, inside it, the k = 200 selection: knn_exact,
     kernel K13 on the card), matching + tuple test, GNC, M-GICP,
     evaluations and information matrices, each call timed between two
     device drains;
  3. FGR's GNC over 2 pairs' fixed correspondences at 24576 and 90112
     rows: the two pairs one after another against one batched GNC, and
     the batched GNC's three largest kernels by device time
     (torch.profiler).
"""

from __future__ import annotations

import collections
import importlib.util
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PAIRS = ((3, 5), (4, 5), (5, 6))


def _chip_smoke():
    """This checkout's chip_smoke.py, whichever package is on the path."""
    if "chip_smoke" not in sys.modules:
        spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
        sys.modules["chip_smoke"] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(sys.modules["chip_smoke"])
    return sys.modules["chip_smoke"]


def _clouds(cs, capacity: int):
    import torch

    from pcr_tpu_torch.utils import cloud

    scans, absolute = cs.make_facade_circuit()
    return [cloud.from_numpy(s[:capacity], capacity, device=torch.device("cuda", 0))
            for s in scans], absolute


def band_against_brute(label: str) -> None:
    """Part 1 with the pcr_tpu_torch first on the path."""
    import numpy as np
    import torch

    from pcr_tpu_torch.models import evaluate, fgr, gicp, multiscale

    cs = _chip_smoke()
    clouds, absolute = _clouds(cs, cs.FACADE_CAPACITY)
    v = cs.FACADE_CALL["voxel_size"]
    scales = multiscale.create_scales_doubling(cs.FACADE_CALL["n_scales"])
    n = len(clouds)
    for s, t in PAIRS:
        src, tgt = clouds[s], clouds[t]
        gt = np.linalg.inv(absolute[t]) @ absolute[s]
        base = float(multiscale.radius_from_cloud_pair(src, tgt))
        dists = [float(min(np.float32(base * 2.0 ** (-i)), np.float32(10.0 * scales[i])))
                 for i in range(len(scales))]
        T_fgr = fgr.registro_fgr(src, tgt, v, use_absolute_scale=True,
                                 seed=s * n + t).transformation
        e = cs.pose_error(T_fgr.double().cpu().numpy(), gt)
        print(f"{label} pair {s}->{t}: radii {[round(d, 3) for d in dists]} m, FGR "
              f"{e[0] * 100:.3f} cm {e[1]:.4f} deg", flush=True)
        for method in ("band", "brute"):
            T, line = T_fgr, []
            for scale, dist in zip(scales, dists):
                a = multiscale._preprocess_scale(src, scale, None)
                b = multiscale._preprocess_scale(tgt, scale, None)
                res = gicp.registration_gicp(a, b, dist, T, corr_method=method,
                                             max_iteration=cs.FACADE_CALL["iterations"])
                T = res.transformation
                e = cs.pose_error(T.double().cpu().numpy(), gt)
                line.append(f"{scale:g} m: {int(a.mask.sum())} pts, {int(res.iterations)} it, "
                            f"fitness {float(res.fitness):.3f}, {e[0] * 100:.3f} cm "
                            f"{e[1]:.4f} deg")
            gates = [float(evaluate.evaluate_registration(src, tgt, 2 * v, T, method=m)[0])
                     for m in ("band", "exact")]
            print(f"  {method}: " + "; ".join(line)
                  + f"; gate band {gates[0]:.4f}, exact {gates[1]:.4f}", flush=True)


def _timed(timings, mod, name: str, key: str) -> None:
    import torch

    f = getattr(mod, name)

    def run(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = f(*args, **kw)
        torch.cuda.synchronize()
        timings[key][0] += time.perf_counter() - t0
        timings[key][1] += 1
        return out

    setattr(mod, name, run)


def builder_split() -> None:
    """Part 2."""
    from pcr_tpu_torch.models import evaluate, fgr, graph_builder, multiscale
    from pcr_tpu_torch.ops import knn

    cs = _chip_smoke()
    clouds, _ = _clouds(cs, cs.FACADE_CAPACITY)
    timings = collections.defaultdict(lambda: [0.0, 0])
    for mod, name, key in ((fgr, "fgr_features", "features"),
                           (knn, "knn_exact", "features' kNN"),
                           (fgr, "_correspondences", "matching + tuple test"),
                           (fgr, "fgr_from_correspondences", "GNC"),
                           (multiscale, "multiscale_gicp", "M-GICP"),
                           (evaluate, "evaluate_registration", "evaluations"),
                           (evaluate, "information_matrix", "information matrices")):
        _timed(timings, mod, name, key)
    builders = (("batched", lambda: graph_builder.full_registration_batched(
                    clouds, log=None, batch_size=cs.FACADE_BATCH, **cs.FACADE_CALL)),
                ("serial", lambda: graph_builder.full_registration(clouds, log=None,
                                                                   **cs.FACADE_CALL)))
    for run in ("cold", "warm"):
        for name, build in builders:
            timings.clear()
            _, wall = cs.synced(build)
            if run == "warm":
                print(f"{name} builder, warm: {wall:.3f} s; " + "; ".join(
                    f"{key} {sec:.3f} s / {calls} calls"
                    for key, (sec, calls) in timings.items()), flush=True)


def gnc_batched() -> None:
    """Part 3."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pcr_tpu_torch.models import fgr
    from pcr_tpu_torch.utils import cloud

    cs = _chip_smoke()
    v = cs.FACADE_CALL["voxel_size"]
    for cap in (24576, 90112):
        clouds, _ = _clouds(cs, cap)
        feats = [fgr.fgr_features(c, v) for c in clouds[:3]]
        opts = fgr.default_options(feats[0][0], feats[1][0], v, use_absolute_scale=True)
        corr = [fgr._correspondences(feats[s][0], feats[t][0], feats[s][1], feats[t][1],
                                     opts, s * 7 + t, 16384, None) for s, t in ((0, 1), (1, 2))]
        src = cloud.stack_clouds([feats[0][0], feats[1][0]])
        tgt = cloud.stack_clouds([feats[1][0], feats[2][0]])
        ci, cj, cm = (torch.stack(x) for x in zip(*corr))

        def one(b):
            return fgr.fgr_from_correspondences(src[b], tgt[b], ci[b], cj[b], cm[b], opts)

        def both():
            return fgr.fgr_from_correspondences(src, tgt, ci, cj, cm, opts)

        cs.synced(lambda: (one(0), one(1), both()))             # warm up
        _, w_one = cs.synced(lambda: (one(0), one(1)))
        _, w_both = cs.synced(both)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            cs.synced(both)
        rows = sorted((e for e in prof.key_averages() if e.device_type.name == "CUDA"),
                      key=lambda e: -e.self_device_time_total)[:3]
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type.name == "CUDA")
        print(f"GNC at {cap} rows: two pairs one after another {w_one:.3f} s, one batched "
              f"GNC over both {w_both:.3f} s; batched device time {total / 1e3:.1f} ms, "
              "largest kernels " + "; ".join(
                  f"{e.key[:40]} {e.self_device_time_total / 1e3:.1f} ms / {e.count}"
                  for e in rows), flush=True)


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--band":
        sys.path.insert(0, sys.argv[2])
        band_against_brute(sys.argv[3])
        return 0
    if len(sys.argv) > 2:
        print(__doc__, file=sys.stderr)
        return 2
    cs = _chip_smoke()
    print(cs.gpu_line(), flush=True)
    roots = [("this checkout", str(ROOT))]
    if len(sys.argv) == 2:
        roots.append((sys.argv[1], str(Path(sys.argv[1]).resolve())))
    for label, root in roots:
        subprocess.run([sys.executable, __file__, "--band", root, label], check=True)
    sys.path.insert(0, str(ROOT))
    builder_split()
    gnc_batched()
    return 0


if __name__ == "__main__":
    sys.exit(main())
