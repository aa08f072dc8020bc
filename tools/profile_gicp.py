#!/usr/bin/env python3
"""The band GICP's Gauss-Newton loop through K10 on one GPU, against the
same loop on K10's plain versions.

    python3 tools/profile_gicp.py

On chip_smoke's first NCLT pair and its Facade-scale pair
(``chip_smoke.gicp_pair``, 5 scales at the main path's capacities):

  * one Gauss-Newton iteration of ``registration_gicp`` at the finest scale
    with the convergence test off: 11 iterations less 1 over 10, host clock
    around synchronized runs (median of 5), through K10 and on the plain
    loops (``chip_smoke.plain_loops``), and the device operations an
    iteration the profiler records (``chip_smoke.device_ops``);
  * the 5-scale M-GICP (host clock, median of 5), through K10 and on the
    plain loops: iterations per scale and the two poses' gap.

K10's launches one by one, against their plain versions, are chip_smoke's
phase 23 (``chip_smoke.check_k10``).
"""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
REPS = 5


def main() -> int:
    import torch

    import chip_smoke
    from pcr_tpu_torch.models import gicp, multiscale

    if not torch.cuda.is_available():
        print("profile_gicp: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(chip_smoke.gpu_line())
    dists = multiscale.max_correspondence_distances(multiscale.create_scales(5))
    for kind in chip_smoke.GICP_PAIRS:
        src, tgt, T0, T_gt = chip_smoke.gicp_pair(kind, dev)
        print(f"{kind}: rows a scale {[c.capacity for c in src]} x {[c.capacity for c in tgt]}")

        def gn(n):
            return lambda: gicp.registration_gicp(src[4], tgt[4], dists[4], T0, max_iteration=n,
                                                  relative_fitness=0.0, relative_rmse=0.0)

        def mgicp():
            return multiscale.multiscale_gicp_pyramids(src, tgt, T0, n_scales=5)

        def wall_ms(fn):
            return chip_smoke.plain_times(fn, REPS)[1]

        def per_iteration(measure):
            return (measure(gn(11)) - measure(gn(1))) / 10

        it_ms, ops = per_iteration(wall_ms), per_iteration(chip_smoke.device_ops)
        res, m_ms = mgicp(), wall_ms(mgicp)
        with chip_smoke.plain_loops():
            it_ms_p, ops_p = per_iteration(wall_ms), per_iteration(chip_smoke.device_ops)
            res_p, m_ms_p = mgicp(), wall_ms(mgicp)
        gap = chip_smoke.pose_error(res.transformation.double().cpu().numpy(),
                                    res_p.transformation.double().cpu().numpy())
        err = chip_smoke.pose_error(res.transformation.double().cpu().numpy(), T_gt)
        print(f"{kind}: a Gauss-Newton iteration at the finest scale {it_ms:.4f} ms host, "
              f"{ops:.1f} device operations (plain loops {it_ms_p:.4f} ms, {ops_p:.1f}); "
              f"5-scale M-GICP {m_ms:.3f} ms, iterations {res.scale_iterations.tolist()} "
              f"(plain loops {m_ms_p:.3f} ms, {res_p.scale_iterations.tolist()}); poses "
              f"{gap[0] * 1e3:.4f} mm / {gap[1] * 1e3:.3f} mdeg apart, {err[0] * 1e3:.3f} mm / "
              f"{err[1] * 1e3:.3f} mdeg from the truth")
    return 0


if __name__ == "__main__":
    sys.exit(main())
