#!/usr/bin/env python3
"""Stage-1 or stage-2 poses of this checkout against another checkout's, on
one GPU.

    python3 tools/compare_circuit.py OTHER_CHECKOUT [1|2]     (default: 2)

Runs ``pipeline.run_stage1_fgr`` (1) or ``pipeline.run_stage2_mgicp`` (2,
from the real NCLT FGR errors) over chip_smoke.py's synthetic circuit (its
seed) once with each checkout's own package and chip_smoke.py, each in a
process of its own, and prints, pair by pair, the translation (mm) and
rotation (deg) between the two poses, and the largest of each; for stage 1
also whether every scan's banded FPFH features (kernels K4-K6, the stage's
defaults) are bit-equal in both checkouts; for stage 2 each pair's GICP
iterations a scale in both checkouts, and whether they are all equal.
"""

from __future__ import annotations

import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def dump(root: str, stage: int, out: str) -> None:
    """The stage with the package and chip_smoke.py of ``root``; poses to ``out``."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke
    from pcr_tpu_torch import pipeline
    from pcr_tpu_torch.utils import cloud

    if not torch.cuda.is_available():
        raise SystemExit("compare_circuit: no CUDA device")
    scans, _, init = chip_smoke.make_circuit()
    clouds = [cloud.from_numpy(s, chip_smoke.CAPACITY, device=torch.device("cuda", 0))
              for s in scans]
    metrics = pipeline.PairMetrics()
    features = []
    with tempfile.TemporaryDirectory() as tmp:
        if stage == 1:
            cfg = chip_smoke.stage1_config(tmp)
            poses = pipeline.run_stage1_fgr(cfg, clouds=clouds, n=chip_smoke.N_SCANS)
            features = [pipeline._prep_features(c, cloud.bucket_capacity(
                c, cfg.bucket_granularity), cfg.voxel_size, cfg.stage1_band)[1].cpu().numpy()
                for c in clouds]
        else:
            poses = pipeline.run_stage2_mgicp(chip_smoke.stage2_config(tmp),
                                              init_poses=init.copy(), clouds=clouds,
                                              n=chip_smoke.N_SCANS, metrics=metrics)
    iterations = [row["scale_iterations"] for row in metrics.rows]
    np.savez(out, poses=np.asarray(poses), iterations=np.asarray(iterations, dtype=np.int64),
             **{f"features{k}": f for k, f in enumerate(features)})


def main() -> int:
    if len(sys.argv) == 5 and sys.argv[1] == "--dump":
        dump(sys.argv[2], int(sys.argv[3]), sys.argv[4])
        return 0
    if len(sys.argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    stage = int(sys.argv[2]) if len(sys.argv) == 3 else 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    print(chip_smoke.gpu_line())
    roots = [str(ROOT), str(Path(sys.argv[1]).resolve())]
    with tempfile.TemporaryDirectory() as tmp:
        outs = [str(Path(tmp) / f"run{i}.npz") for i in range(2)]
        for root, out in zip(roots, outs):
            subprocess.run([sys.executable, __file__, "--dump", root, str(stage), out],
                           check=True)
        za, zb = (dict(np.load(out)) for out in outs)
    a, its_a, b, its_b = za["poses"], za["iterations"], zb["poses"], zb["iterations"]
    worst = [0.0, 0.0]
    for k in range(a.shape[0]):
        d_t, d_r = chip_smoke.pose_error(a[k], b[k])
        worst = [max(worst[0], d_t), max(worst[1], d_r)]
        its = (f"; iterations/scale {its_a[k].tolist()} / {its_b[k].tolist()}"
               if its_a.size else "")
        print(f"pair {k}: {d_t * 1e3:.6f} mm, {d_r:.6f} deg{its}")
    print(f"stage {stage}, this checkout against {roots[1]}: largest {worst[0] * 1e3:.6f} mm, "
          f"{worst[1]:.6f} deg")
    if its_a.size:
        print(f"stage 2 GICP iterations a scale equal in both: {np.array_equal(its_a, its_b)}")
    feats = sorted(k for k in za if k.startswith("features"))
    if feats:
        same = all(np.array_equal(za[k], zb[k]) for k in feats)
        print(f"stage-1 FPFH features of all {len(feats)} scans bit-equal in both: {same}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
