#!/usr/bin/env python3
"""Stage-1 yardstick: the JAX package's own FGR on chip_smoke's circuit.

    JAX_PLATFORMS=cpu python3 tools/stage1_reference_cpu.py [FGR_SEED]

Runs ``pcr_tpu.pipeline.run_stage1_fgr`` (streamed branch, batch_size=1,
banded features at band 2048, the NCLT defaults) over the seeded synthetic
8-scan circuit of ``chip_smoke.make_circuit`` and prints every pair's pose
error against ground truth and its fitness, with the limits chip_smoke holds
the port's stage 1 to (0.5 m / 5 deg).  FGR_SEED (default 0) is the
pipeline's ``fgr_seed``: each pair's tuple test draws from fgr_seed + its
source scan.  The tuple test draws other random
numbers in the two packages, so the port agrees with these errors
statistically, not pair for pair.  Takes minutes on a CPU.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    import jax

    import chip_smoke
    from pcr_tpu import pipeline
    from pcr_tpu.utils import cloud

    scans, gt, _ = chip_smoke.make_circuit()
    print("backend:", jax.default_backend(), "| scan valid points:",
          [len(s) for s in scans])
    clouds = [cloud.from_numpy(s, chip_smoke.CAPACITY) for s in scans]
    with tempfile.TemporaryDirectory() as tmp:
        cfg = pipeline.PipelineConfig(dataset="NCLT", batch_size=1, output_root=tmp,
                                      fgr_seed=int(sys.argv[1]) if len(sys.argv) > 1 else 0)
        metrics = pipeline.PairMetrics()
        t0 = time.perf_counter()
        out = pipeline.run_stage1_fgr(cfg, clouds=clouds, n=chip_smoke.N_SCANS,
                                      metrics=metrics)
        wall = time.perf_counter() - t0
    worst = 0.0, 0.0
    for k, row in enumerate(metrics.rows):
        e_t, e_r = chip_smoke.pose_error(out[k], gt[k])
        worst = max(worst[0], e_t), max(worst[1], e_r)
        print(f"pair ({row['src']},{row['tgt']}): {e_t * 100:.2f} cm {e_r:.3f} deg; "
              f"fitness {row['fitness']:.4f}")
    print(f"worst pair error {worst[0] * 100:.2f} cm, {worst[1]:.3f} deg (chip_smoke "
          f"limits {chip_smoke.MAX_FGR_T_ERR_M * 100:g} cm, {chip_smoke.MAX_FGR_R_ERR_DEG} deg); "
          f"wall {wall:.1f} s on the CPU, compiles included")
    return 0


if __name__ == "__main__":
    sys.exit(main())
