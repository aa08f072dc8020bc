#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pcr_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit code):
  1. device  — needs a CUDA device; prints the card's name and power limit;
  2. build   — compiles the CUDA kernels from pcr_tpu_torch/csrc;
  3. kernels — runs each kernel (K1 banded 1-NN, K2 outlier statistics,
               K3 survivor moments) and its plain PyTorch version on the same
               tensors at every shape and band the main path gives it (each
               pyramid scale, each GICP and final-metrics band, the gate's
               32768-row clouds), prints their agreement and both times
               (CUDA events, median);
  4. slice   — stage 2 (pipeline.run_stage2_mgicp: 5 scales, 100 iterations,
               L1) over a seeded synthetic 8-scan circuit at NCLT scale whose
               relative motions and initial-pose errors are the real NCLT
               ones (outputs/NCLT_poses.npz); every pair must land within
               3 cm / 0.2 deg of ground truth, and K1-K3 must each have been
               launched by the warm run;
  5. split   — the warm circuit's time divided into pyramids and GICP.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
N_SCANS = 8
CAPACITY = 32768          # pcr_tpu's NCLT bucket
TARGET_POINTS = 24000     # valid points per scan (about)
NOISE_M = 0.01
MAX_T_ERR_M = 0.03
MAX_R_ERR_DEG = 0.2
SEED = 0


# ---------------------------------------------------------------------------
# Synthetic circuit (numpy, from SEED)
# ---------------------------------------------------------------------------

def _rot_z(a: float) -> np.ndarray:
    c, s = math.cos(a), math.sin(a)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def _world(rng: np.random.Generator, center: np.ndarray) -> np.ndarray:
    """Dense point samples of a scene that constrains all six degrees of
    freedom: bumpy ground, walls in three directions and yawed boxes."""
    parts = []
    # ground within 36 m: low bumps (a few cm to 20 cm)
    n = 900_000
    r = 36.0 * np.sqrt(rng.random(n))
    th = rng.uniform(0, 2 * np.pi, n)
    x, y = center[0] + r * np.cos(th), center[1] + r * np.sin(th)
    z = (0.12 * np.sin(0.31 * x) * np.cos(0.27 * y) + 0.05 * np.sin(1.3 * x + 0.7 * y)
         - 1.8)
    parts.append(np.stack([x, y, z], 1))
    # walls: (anchor x, anchor y, direction angle, length, height)
    walls = [(-20, 14, 0.0, 45, 5), (-16, -18, np.pi / 2, 32, 4),
             (22, -12, 2.2, 30, 6), (8, 20, -0.4, 20, 3)]
    for ax, ay, ang, length, height in walls:
        m = int(2000 * length * height / 10)
        s = rng.uniform(0, length, m)
        h = rng.uniform(0, height, m)
        d = np.array([math.cos(ang), math.sin(ang)])
        parts.append(np.stack([center[0] + ax + s * d[0], center[1] + ay + s * d[1],
                               h - 1.8], 1))
    # boxes: (x, y, yaw, sx, sy, sz)
    boxes = [(6, 4, 0.3, 2.0, 1.5, 1.2), (-5, 7, 1.0, 3.0, 1.0, 2.0),
             (3, -7, -0.6, 1.5, 1.5, 2.5), (-9, -4, 0.1, 2.5, 2.0, 1.0),
             (12, 2, 0.8, 1.0, 3.0, 1.8), (-2, -12, 0.5, 4.0, 1.2, 1.5)]
    for bx, by, yaw, sx, sy, sz in boxes:
        m = int(600 * (2 * (sx + sy) * sz + sx * sy))
        u = rng.random((m, 3)) * [sx, sy, sz]
        face = rng.integers(0, 5, m)                # 4 sides + top
        u[face == 0, 0] = 0.0
        u[face == 1, 0] = sx
        u[face == 2, 1] = 0.0
        u[face == 3, 1] = sy
        u[face == 4, 2] = sz
        local = u - [sx / 2, sy / 2, 0.0]
        pts = local @ _rot_z(yaw).T + [center[0] + bx, center[1] + by, -1.8]
        parts.append(pts)
    return np.concatenate(parts)


def make_circuit(seed: int = SEED):
    """(scans as (n_i, 3) float32 arrays in their sensor frames,
    ground-truth relative poses (N_SCANS, 4, 4), initial poses (N_SCANS, 4, 4)).

    Relative motions are NCLT's first refined pairs, the wraparound pair closes
    the chain, and each initial pose carries the real FGR error of its pair
    (relative_FGR @ inv(relative_FGR_GICP)).
    """
    z = np.load(ROOT / "outputs" / "NCLT_poses.npz")
    rel_ref, rel_fgr = z["relative_FGR_GICP"], z["relative_FGR"]
    absolute = [np.eye(4)]
    for k in range(N_SCANS - 1):
        absolute.append(absolute[-1] @ rel_ref[k])
    gt = np.stack([np.linalg.inv(absolute[k]) @ absolute[(k + 1) % N_SCANS]
                   for k in range(N_SCANS)])
    err = np.stack([rel_fgr[k] @ np.linalg.inv(rel_ref[k]) for k in range(N_SCANS)])
    init = np.einsum("kij,kjl->kil", err, gt)

    rng = np.random.default_rng(seed)
    center = np.mean([A[:3, 3] for A in absolute], axis=0)
    world = _world(rng, center)
    scans = []
    for A in absolute:
        rng_k = np.linalg.norm(world - A[:3, 3], axis=1)
        w = np.where((rng_k > 1.0) & (rng_k < 30.0), 1.0 / np.maximum(rng_k, 2.0) ** 2, 0.0)
        p = np.minimum(1.0, w * (TARGET_POINTS / w.sum()))
        pts = world[rng.random(len(world)) < p]
        pts = pts[:CAPACITY]
        pts = pts + rng.normal(0.0, NOISE_M, pts.shape)
        local = (pts - A[:3, 3]) @ A[:3, :3]            # world -> sensor frame
        scans.append(local.astype(np.float32))
    return scans, gt, init


def pose_error(T: np.ndarray, T_gt: np.ndarray) -> tuple[float, float]:
    """(translation error m, rotation error deg) of T against T_gt."""
    dR = T[:3, :3] @ T_gt[:3, :3].T
    axis = np.array([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0], dR[1, 0] - dR[0, 1]])
    ang = math.degrees(math.atan2(np.linalg.norm(axis) / 2.0, (np.trace(dR) - 1.0) / 2.0))
    return float(np.linalg.norm(T[:3, 3] - T_gt[:3, 3])), ang


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------

def gpu_line() -> str:
    """The first card's name and power limit, as nvidia-smi reports them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True)
    return smi.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` runs, CUDA events."""
    import torch

    fn()                                                  # warm up
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def stage2_config(output_root: str):
    """The reference's stage-2 defaults, as the slice phase runs them."""
    from pcr_tpu_torch import pipeline

    return pipeline.PipelineConfig(
        dataset="NCLT", mgicp_scales=5, mgicp_iterations=100, batch_size=1,
        retry_failed=False, scale_capacities="auto", output_root=output_root)


def check_k1(label: str, src, tgt, T, max_dist: float, band: int):
    """K1 against its plain version on the slabs that ``nn1_band_query``
    builds for (src moved by T) in tgt; returns (max |d2 err|, ms, plain ms).
    In-radius sets must be identical and d2 within 1e-5 relative."""
    import torch

    from pcr_tpu_torch.ops import band_nn
    from pcr_tpu_torch.ops.kernels import nn_kernels as nk
    from pcr_tpu_torch.utils import se3
    from pcr_tpu_torch.utils.cloud import pad_rows

    p = se3.transform_points(T, src.points)
    index = band_nn.build_band_index(p, src.mask, tgt.points, tgt.mask, band=band)
    nq_pad = -(-p.shape[0] // 1024) * 1024
    q = torch.where(src.mask[:, None], p, band_nn.SENTINEL)[index.q_order]
    q = pad_rows(q, nq_pad, band_nn.SENTINEL).contiguous()
    starts = band_nn.slab_starts(index, q, max_dist, 1024, band)
    args = (starts, q, index.r_sorted)
    d_k, i_k = nk.nn1_band(*args, q_tile=1024, band=band)
    d_p, i_p = nk.nn1_band_reference(*args, q_tile=1024, band=band)
    md2 = max_dist * max_dist
    in_k, in_p = d_k <= md2, d_p <= md2
    if not torch.equal(in_k, in_p):
        raise AssertionError(f"K1 {label}: in-radius sets differ "
                             f"({int((in_k ^ in_p).sum())} queries)")
    rel = ((d_k - d_p).abs() / torch.clamp(d_p.abs(), min=1e-12))[in_p]
    if rel.numel() and float(rel.max()) > 1e-5:
        raise AssertionError(f"K1 {label}: d2 relative error {float(rel.max())}")
    err = float((d_k - d_p)[in_p].abs().max()) if int(in_p.sum()) else 0.0
    ms = cuda_ms(lambda: nk.nn1_band(*args, q_tile=1024, band=band), 20)
    plain_ms = cuda_ms(lambda: nk.nn1_band_reference(*args, q_tile=1024, band=band), 5)
    print(f"K1 nn1_band {label}: {q.shape[0]} q, band {band}, {int(in_p.sum())} in radius, "
          f"rows equal {float((i_k == i_p).float().mean()):.6f}, "
          f"max |d2 err| {err:.3e}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return err, ms, plain_ms


def check_k2_k3(label: str, c, voxel_size: float, cap: int):
    """K2 and K3 against their plain versions on the cloud that
    ``preprocess_scale_fused(c, voxel_size, cap)`` hands them; returns
    ((K2 err, ms, plain ms), (K3 err, ms, plain ms)).  K2's found set and tau
    must be identical and its mean distance within 1e-5 relative; K3's
    neighbour counts identical and its moments within a summation-order
    bound."""
    import torch

    from pcr_tpu_torch.ops import preprocess, voxel
    from pcr_tpu_torch.ops.kernels import feature_kernels as fk
    from pcr_tpu_torch.utils.cloud import pad_rows

    d = voxel.voxel_downsample_cloud(c, voxel_size)
    points, mask = d.points[:cap], d.mask[:cap]
    band = preprocess._band_width(cap)
    ps, ms_, p_q, p_r, starts = preprocess.sort_and_tile(points, mask, 1024, band)
    k2_args = (starts, p_q, p_r, voxel_size)
    mean_k, found_k, tau_k = fk.outlier_stats(*k2_args, q_tile=1024, band=band)
    mean_p, found_p, tau_p = fk.outlier_stats_reference(*k2_args, q_tile=1024, band=band)
    if not torch.equal(found_k, found_p):
        raise AssertionError(f"K2 {label}: found sets differ "
                             f"({int((found_k ^ found_p).sum())})")
    if not torch.equal(tau_k, tau_p):
        raise AssertionError(f"K2 {label}: tau differs, "
                             f"max {float((tau_k - tau_p).abs().max())}")
    tol = 1e-5 * mean_p.abs() + 1e-7
    if bool(((mean_k - mean_p).abs() > tol).any()):
        raise AssertionError(f"K2 {label}: mean_d max err "
                             f"{float((mean_k - mean_p).abs().max())}")
    err2 = float((mean_k - mean_p).abs().max())
    ms2 = cuda_ms(lambda: fk.outlier_stats(*k2_args, q_tile=1024, band=band), 10)
    plain2 = cuda_ms(lambda: fk.outlier_stats_reference(*k2_args, q_tile=1024, band=band), 3)
    print(f"K2 outlier_stats {label}: {cap} rows, band {band}, {int(found_p.sum())} found, "
          f"found/tau equal, max |mean_d err| {err2:.3e}, kernel {ms2:.4f} ms, "
          f"plain {plain2:.4f} ms")

    # the survivor gate of outlier_and_normals_sorted (std_ratio 1)
    stat = ms_ & found_p[:cap]
    keep = stat & (mean_p[:cap] <= mean_p[:cap][stat].mean() + mean_p[:cap][stat].std())
    keep_r = pad_rows(keep, p_r.shape[0], False)
    center = fk.slab_centroids(starts, p_r, band)
    k3_args = (starts, p_q, p_r, keep_r, tau_p, center)
    S_k = fk.survivor_moments(*k3_args, q_tile=1024, band=band)
    S_p = fk.survivor_moments_reference(*k3_args, q_tile=1024, band=band)
    if not torch.equal(S_k[:, 9], S_p[:, 9]):
        raise AssertionError(f"K3 {label}: neighbour counts differ")
    # summation-order bound: ~count * 2^-24 of the sum of |terms|, which the
    # trace, sqrt(count * trace) and count bound for every column
    trace = S_p[:, 3] + S_p[:, 6] + S_p[:, 8]
    bound = 1e-5 * (trace + torch.sqrt(S_p[:, 9] * trace) + S_p[:, 9]) + 1e-6
    if bool(((S_k - S_p).abs() > bound[:, None]).any()):
        raise AssertionError(f"K3 {label}: moments max err {float((S_k - S_p).abs().max())}")
    err3 = float((S_k - S_p).abs().max())
    ms3 = cuda_ms(lambda: fk.survivor_moments(*k3_args, q_tile=1024, band=band), 10)
    plain3 = cuda_ms(lambda: fk.survivor_moments_reference(*k3_args, q_tile=1024,
                                                           band=band), 3)
    print(f"K3 survivor_moments {label}: {cap} rows, band {band}, {int(keep.sum())} "
          f"survivors, counts equal, max |moment err| {err3:.3e}, kernel {ms3:.4f} ms, "
          f"plain {plain3:.4f} ms")
    return (err2, ms2, plain2), (err3, ms3, plain3)


def phase_kernels(dev, clouds, gt) -> list[dict]:
    """Each kernel against its plain version at every shape and band the
    main path gives it on the first pair (scan 1 into scan 0): K2/K3 at each
    pyramid scale, K1 at each scale's GICP band and final-metrics band and
    at the gate evaluation.  A kernel's time in the JSON record is that of
    its finest-scale (largest) GICP or pyramid call."""
    import torch

    from pcr_tpu_torch.models import gicp, multiscale
    from pcr_tpu_torch.utils import cloud

    cfg = stage2_config("unused")
    scales = multiscale.create_scales(cfg.mgicp_scales)
    dists = multiscale.max_correspondence_distances(scales)
    caps = cloud.plan_scale_caps(clouds, scales)
    src, tgt = clouds[1], clouds[0]
    T = torch.as_tensor(gt[0], dtype=torch.float32, device=dev)

    k2, k3 = [], []
    for v, cap in zip(scales, caps):
        r2, r3 = check_k2_k3(f"scale {v:.1f} m", tgt, v, cap)
        k2.append(r2)
        k3.append(r3)

    src_pyr = multiscale.build_pyramid(src, len(scales), caps)
    tgt_pyr = multiscale.build_pyramid(tgt, len(scales), caps)
    k1 = []
    for s, (v, cap, dist) in enumerate(zip(scales, caps, dists)):
        band = gicp._band_width(cap, 1024)
        k1_gicp_finest = check_k1(f"GICP scale {v:.1f} m", src_pyr[s], tgt_pyr[s], T,
                                  dist, band)
        k1.append(k1_gicp_finest)
        band_f = gicp._band_width(cap, 2048)
        if band_f != band:
            k1.append(check_k1(f"final metrics scale {v:.1f} m", src_pyr[s], tgt_pyr[s], T,
                               dist, band_f))
    k1.append(check_k1("gate", src, tgt, T, 2 * cfg.voxel_size, 2048))

    def record(name, source, replaces, results, timed):
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    max_abs_err=max(r[0] for r in results), ms=timed[1], plain_ms=timed[2])

    return [
        record("nn1_band", "pcr_tpu_torch/csrc/band_nn.cu",
               "pcr_tpu/ops/pallas/nn_kernels.py:92", k1, k1_gicp_finest),
        record("outlier_stats", "pcr_tpu_torch/csrc/preprocess.cu",
               "pcr_tpu/ops/pallas/feature_kernels.py:479", k2, k2[-1]),
        record("survivor_moments", "pcr_tpu_torch/csrc/preprocess.cu",
               "pcr_tpu/ops/pallas/feature_kernels.py:580", k3, k3[-1]),
    ]


def phase_slice(clouds, gt, init):
    """Stage 2 over the circuit twice; returns the warm run's launch counts."""
    import torch

    from pcr_tpu_torch import pipeline
    from pcr_tpu_torch.ops.kernels import feature_kernels as fk
    from pcr_tpu_torch.ops.kernels import nn_kernels as nk

    counters = (nk.LAUNCHES, fk.LAUNCHES)
    with tempfile.TemporaryDirectory() as tmp:
        for run in ("cold", "warm"):
            cfg = stage2_config(str(Path(tmp) / run))
            metrics = pipeline.PairMetrics()
            for c in counters:
                for key in c:
                    c[key] = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = pipeline.run_stage2_mgicp(cfg, init_poses=init.copy(), clouds=clouds,
                                            n=N_SCANS, metrics=metrics)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {k: v for c in counters for k, v in c.items()}
            print(f"{run} run: {wall:.3f} s, {N_SCANS / wall:.3f} pairs/s, "
                  f"launches {launches}")
        if not np.isfinite(out).all() or out.shape != (N_SCANS, 4, 4):
            raise AssertionError("non-finite or misshapen poses")
        rel_dir = Path(cfg.out_dir("relative_poses_FGR_GICP"))
        files = [rel_dir / f"pose_{k + 1}_{k}.txt" for k in range(N_SCANS - 1)]
        files.append(rel_dir / f"pose_0_{N_SCANS - 1}.txt")
        for k, f in enumerate(files):
            if not np.allclose(np.loadtxt(f), out[k], atol=1e-8):
                raise AssertionError(f"{f.name} does not hold pair {k}'s pose")
    worst = 0.0, 0.0
    for k, row in enumerate(metrics.rows):
        e_t, e_r = pose_error(out[k], gt[k])
        e0_t, e0_r = pose_error(init[k], gt[k])
        worst = max(worst[0], e_t), max(worst[1], e_r)
        print(f"pair ({row['src']},{row['tgt']}): init {e0_t * 100:.2f} cm {e0_r:.3f} deg"
              f" -> {e_t * 100:.3f} cm {e_r:.4f} deg; iterations/scale "
              f"{row['scale_iterations']}; fitness {row['fitness']:.4f}; "
              f"gate fitness {row['gate_fitness']:.4f}")
        if not (e_t < MAX_T_ERR_M and e_r < MAX_R_ERR_DEG):
            raise AssertionError(f"pair {k} off ground truth: {e_t} m, {e_r} deg")
    print(f"worst pair error {worst[0] * 100:.3f} cm, {worst[1]:.4f} deg "
          f"(limits {MAX_T_ERR_M * 100:g} cm, {MAX_R_ERR_DEG} deg)")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"kernel {name} was not launched by the main path")
    return launches


def phase_split(clouds, init) -> None:
    """Warm stage-2 time split into pyramid building and GICP."""
    import torch

    from pcr_tpu_torch.models import multiscale as ms_mod
    from pcr_tpu_torch.pipeline import circuit_pairs
    from pcr_tpu_torch.utils import cloud

    caps = cloud.plan_scale_caps(clouds, ms_mod.create_scales(5))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pyrs = [ms_mod.build_pyramid(c, 5, caps) for c in clouds]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for k, (s, t) in enumerate(circuit_pairs(N_SCANS)):
        ms_mod.multiscale_gicp_pyramids(pyrs[s], pyrs[t], init[k].astype(np.float32))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    print(f"split: scale caps {caps}; pyramids {t1 - t0:.3f} s for {N_SCANS} clouds "
          f"({(t1 - t0) / N_SCANS * 1e3:.1f} ms/cloud); GICP {t2 - t1:.3f} s for "
          f"{N_SCANS} pairs ({(t2 - t1) / N_SCANS * 1e3:.1f} ms/pair)")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(gpu_line())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    import pcr_tpu_torch  # noqa: F401  (sets the f32 matmul policy)
    from pcr_tpu_torch.ops.kernels import build

    t0 = time.perf_counter()
    build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {build.library_path()}")

    from pcr_tpu_torch.utils import cloud

    scans, gt, init = make_circuit()
    clouds = [cloud.from_numpy(s, CAPACITY, device=dev) for s in scans]
    print("scan valid points:", [len(s) for s in scans])
    records = phase_kernels(dev, clouds, gt)
    launches = phase_slice(clouds, gt, init)
    phase_split(clouds, init)
    for rec in records:
        rec["launches"] = launches[rec["name"]]
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
