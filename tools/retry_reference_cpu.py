#!/usr/bin/env python3
"""Retry-ladder yardstick: the JAX package's own stage 2 on chip_smoke's
circuit, with one pair's initial pose thrown 50 m off.

    JAX_PLATFORMS=cpu python3 tools/retry_reference_cpu.py [PAIR [OFFSET_M]]

Runs ``pcr_tpu.pipeline.run_stage2_mgicp`` (streamed branch, batch_size=1,
the reference defaults: 5 scales, 100 iterations, retry_failed=True with
retry_voxel_mults (2, 4)) over the seeded synthetic 8-scan circuit of
``chip_smoke.make_circuit``, from the circuit's real NCLT FGR-error initial
poses, except pair PAIR (default ``chip_smoke.RETRY_PAIR``) whose initial
translation is moved OFFSET_M (default ``chip_smoke.RETRY_OFFSET_M``) along
x.  Prints every pair's status, pose error against ground truth and
fitness, with the limits chip_smoke holds the port's rescued pair to
(3 cm / 0.2 deg).  The ladder's FGR draws other random numbers in the two
packages, so the port agrees with this outcome statistically.  Takes
minutes on a CPU.
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

    pair = int(sys.argv[1]) if len(sys.argv) > 1 else chip_smoke.RETRY_PAIR
    offset = float(sys.argv[2]) if len(sys.argv) > 2 else chip_smoke.RETRY_OFFSET_M
    scans, gt, init = chip_smoke.make_circuit()
    seeded = chip_smoke.thrown_off(init, pair, offset)
    print("backend:", jax.default_backend(), "| scan valid points:",
          [len(s) for s in scans], f"| pair {pair} thrown {offset:g} m off")
    clouds = [cloud.from_numpy(s, chip_smoke.CAPACITY) for s in scans]
    with tempfile.TemporaryDirectory() as tmp:
        cfg = pipeline.PipelineConfig(dataset="NCLT", batch_size=1, output_root=tmp)
        metrics = pipeline.PairMetrics()
        t0 = time.perf_counter()
        out = pipeline.run_stage2_mgicp(cfg, init_poses=seeded, clouds=clouds,
                                        n=chip_smoke.N_SCANS, metrics=metrics)
        wall = time.perf_counter() - t0
    for k, row in enumerate(metrics.rows):
        e_t, e_r = chip_smoke.pose_error(out[k], gt[k])
        print(f"pair ({row['src']},{row['tgt']}): status {row['status']}; "
              f"{e_t * 100:.3f} cm {e_r:.4f} deg; fitness {row['fitness']:.4f}; "
              f"gate fitness {row['gate_fitness']:.4f}")
    print(f"limits {chip_smoke.MAX_T_ERR_M * 100:g} cm, {chip_smoke.MAX_R_ERR_DEG} deg; "
          f"wall {wall:.1f} s on the CPU, compiles included")
    return 0


if __name__ == "__main__":
    sys.exit(main())
