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
               32768-row clouds, stage 3's information matrix), prints
               their agreement (K1: d2 bit-equal, every row the first
               minimum) and both times (CUDA events,
               median; each timed launch waits behind a short spin on the
               device, so the host's launch work is not counted), and K1's
               times at each shape and K2's and K3's at each scale on a line;
  4. slice   — stage 2 (pipeline.run_stage2_mgicp: 5 scales, 100 iterations,
               L1) over a seeded synthetic 8-scan out-and-back circuit at
               NCLT scale whose relative motions and initial-pose errors are
               real NCLT ones (outputs/NCLT_poses.npz); every pair must land within
               3 cm / 0.2 deg of ground truth, and K1-K3 must each have been
               launched by the warm run;
  5. split   — the warm circuit's time divided into pyramids and GICP;
  6. feature kernels — K4 moments, K5 SPFH and K6 FPFH against their plain
               versions on scan 0 compacted to its bucket (24576 rows,
               q_tile 512, band 2048, voxel 0.1 m, the stage-1 path's shape),
               on a 4096-row compaction at band 1024 and on scan 0 at
               fgr_features_sorted's default band 4096; K6 also bit for bit
               against the serial sums in its own ascending-row order;
  7. stage 1 — pipeline.run_stage1_fgr (banded features, mutual matching,
               tuple test, 300 GNC iterations) over the circuit, cold and
               warm; every pair within 0.5 m / 5 deg of ground truth, and K1,
               K4, K5, K6, K8 and K11 must each have been launched by the warm
               run, K8 and K11 (the mutual matching) once a pair;
  8. stage 1 -> 2 — stage 2 seeded with the port's own stage-1 poses, the
               retry ladder on; every pair within 3 cm / 0.2 deg;
  9. stage 3 — pipeline.run_stage3_global, all four methods (LUM, SLERP,
               SLERP+LUM on the host in float64; the pose-graph LM on the
               card over K1's band-NN information matrices) on the stage-2
               poses of phase 8: each trajectory within 5 cm of ground truth
               (aligned ATE), the card's pose graph within 1e-4 of the same
               graph solved on the CPU, K1 launched, K12's two launches once
               an LM iteration and K9's two; cold and warm walls and each
               method's seconds;
 10. run_full — pipeline.run_full on the default PipelineConfig (stages 1 -> 3
               in one window, the main path): its stage-1 and stage-2 poses
               equal phases 7 and 8's, K1-K6, K8, K9, K11 (at least once a
               pair) and K12 (once an LM iteration) each launched; its wall
               beside the staged runners' sum;
 11. batched — run_stage1_fgr and run_stage2_mgicp at the default
               batch_size=2 (stage 1 in chunks of pairs, one GNC over a
               chunk; stage 2 streams at every batch size), cold and warm:
               stage 1 within 0.5 m / 5 deg, stage 2 within 3 cm / 0.2 deg,
               K1, K4-K6, K8 (once a chunk), K11 (once a pair) and K1-K3
               launched; both warm walls beside the streamed ones;
 12. NCLT stage 3 — the 901-pose circuit of outputs/NCLT_poses.npz: the
               closed forms held to the file's trajectories (1e-6), the pose
               graph on the card with identity information matrices, timed
               (iterations, ms an iteration, the block-Thomas solves' share,
               the Hessian blocks and bands' share, K12 beside its plain
               version), K9 launched twice an LM iteration and K12's two
               launches once; the circuit with the information of
               test_global_optimization_at_n901_matches through K9 and K12
               and on the plain loops, both walls, held at that test's
               bounds (pruning, mu, final costs, edge mask, circuit
               consistency);
 13. stage-1 split — features ms/scan; matching, tuple test, GNC and
               evaluation ms/pair; the GNC of two pairs one after another
               beside one batched GNC over both;
 14. K7 brute   — K7 (brute-force 1-NN) against its plain version at the
               finest-scale brute GICP pair, the 32768-row gate and an odd
               1000 x 3001 shape: d2 bit-equal, rows equal; kernel, plain
               and library (cdist + min) times; then on inputs full of exact
               ties (k7_tie_inputs) at four shapes: the same, and every tie
               across a group or ref-range boundary at its first row;
 15. brute GICP — registration_gicp(corr_method="brute") warm-started over
               the 5 pyramid scales of every pair: within 3 cm / 0.2 deg of
               ground truth and 5 mm / 0.05 deg of the band GICP; the same
               with corr_method="grid" (the hash grid of ops/grid_nn), held
               to ground truth and within 5 mm / 0.05 deg of brute, its
               iterations a scale beside brute's; the exact
               gate evaluation beside the band one; K7 must have been
               launched; the ms of one Gauss-Newton iteration of grid, band
               (K1) and brute (K7) at pair 0's finest scale; pair 0 again on
               K7's plain version: the same pose bit for bit;
 16. stage 1, selection — run_stage1_fgr(stage1_features="selection"):
               every pair within 0.5 m / 5 deg;
 17. retry ladder — stage 2 with retry_failed=True (the reference default),
               pair RETRY_PAIR thrown RETRY_OFFSET_M off: its status must
               start with "retried" and it must land within 3 cm / 0.2 deg;
               the other pairs as in phase 4.
 18. entry points — the 8 scans written as binary PCD in the NCLT layout
               under a temporary reference root; pcr_tpu_torch.__main__.main
               runs ``full --dataset NCLT --n 8`` (loading, run_full through
               K1-K12 but K7; the main path as a user calls it; K10's and
               slab_starts' arguments kept for phase 23): its
               stage-1 and stage-2 pose files within 1e-6 of phase 10's, those
               kernels launched (K11 at least once a pair, K12 once an LM
               iteration),
               its wall beside phase 10's; run_full over
               load_dataset_lazy("NCLT", range(8)) equal to the same poses and
               its uploaded clouds equal to the in-memory ones; ``python -m
               pcr_tpu_torch pair --src 1 --tgt 0`` as a subprocess within
               3 cm / 0.2 deg; ``stage3 --relative`` the CLI's stage-2 poses,
               all four methods within 5 cm aligned ATE; ``report`` (the
               trajectory PLYs); models/gicp.gicp_loss_log on pair 0's
               finest scale, corr_method "brute" (K7, one launch an
               iteration and one for the final metrics, the default on the
               card) and "grid" (pcr_tpu's default); knn(method="band") with
               exclude_self on scan 0 at k = 30 and 200 against knn_exact
               (every distance within 1e-6 relative, recall >= 0.9999);
               the native PCD reader must have built;
 19. data plane — 901 paths (the 8 files and symlinks cycling over them, the
               NCLT circuit's length): seconds to parse them (native,
               threaded) and to pin them, the Python parser's seconds on the
               8 files, plan_scale_caps' seconds and caps at the 5 scales
               on the host clouds and through a LazyClouds on the card,
               LazyClouds' prefix upload ms a scan over all 901, and the eager
               load_dataset's seconds and device MiB;
 20. mesh, one rank — a world of one rank over NCCL in this process
               (parallel.mesh.make_pair_mesh(1)): run_stage1_fgr and
               run_stage2_mgicp with mesh= at batch_size=2 against phase 11's
               batched runners (stage 1 within 1e-5, stage 2 within 1e-6),
               K1-K6 launched by them; stage 2 again from the mesh's stage-1
               poses; run_pair(point_mesh=make_point_mesh(1)) against phase
               18's ``pair`` (1e-5); ``full --devices 1 --batch-size 2``
               through the CLI, its pose files those of the mesh runners
               (1e-6); distributed_global_optimization on the 8-node circuit
               graph against global_optimization (5e-4); walls beside the
               batched runners';
 21. mesh, two ranks — two processes spawned on this card, each in a gloo
               group of 2 (CUDA tensors exchanged through host memory):
               stage 1 -> 2 on a (pairs=2) mesh, the poses of phase 20's
               mesh runners (1e-5); stage 2 on a (pairs=1, points=2) mesh
               (every scale's GICP over the cached pyramids point-sharded)
               within 5e-5 of phase 11's batched poses and 3 cm / 0.2 deg
               of ground truth, and sharded_mgicp_2d on the same pairs
               within 1e-6 of it where no retry ran;
               distributed_global_optimization on the 2 ranks against phase
               20's (5e-4).  A rank that fails or overruns fails the run.
 22. graph builder — the k-connectivity "SLAM mode" at Facade scale: a
               seeded 7-scan circuit of the same scene (44.6k-83.6k valid
               points in the 90112 bucket, neighbours 0.5-1.5 m apart, 1 cm
               noise) through models/graph_builder with
               benchmarks/facade_k2_report.py's call (voxel 0.1, k=2, 3
               doubling scales, 100 iterations; 11 edges):
               full_registration_batched (batch 2; cold, then again after
               the serial builder, the two graphs bit for bit equal) and
               full_registration, each builder's wall, edges/s, retried
               pairs, peak memory and K1-K9 launches (K1-K3 and K8 must be
               launched); every edge's gate fitness and error against
               ground truth (odometry edges within 3 cm / 0.2 deg);
               global_optimization of the batched graph (every node within
               8 cm, aligned ATE; K12 once an LM iteration), run twice bit
               for bit (the dense assembly in a fixed order); the serial
               graph against the batched one
               on the pairs neither builder retried (edge_T 5e-4, nodes
               5e-3, information rtol 0.05 / atol 50).
 23. loop kernels — K8 (the GNC, csrc/loops.cu) on the arguments phases 7,
               11 and 22 gave it (NCLT stage 1 at batch 1 and 2, relative
               scale; the Facade builder's chunk of 2 at 90112 rows, absolute
               scale) and K9 (block-Thomas) on those of phases 9 and 12
               (m = 7 and the NCLT m = 900), each against its plain version
               on the same tensors: K8's normalised poses within 1e-4 and the
               poses they denormalise to within 5 mm / 0.02 deg; K9's refined
               relative residual within 10x the plain solve's (or under
               1e-6); K11 (mutual 1-NN, csrc/mutual_nn.cu) on the features
               of phase 7's first pair (24576 x 24576 x 33) and of phase
               22's first chunk: every pick that differs from the plain
               version's within the expanded form's rounding
               (mutual_rounding; the count printed), and on integer inputs
               full of exact ties at the same shape (k11_tie_inputs) ij and
               ji equal; K12 (csrc/pose_graph.cu) on the edges of phases 9,
               12 (n = 901) and 22 (the k-graph, dense): blocks within their
               bound of the plain version's (edge_block_errors), the bands
               or dense system of the kernel's own blocks bit-equal to the
               CPU's index_add_ / index_put_ of them; each kernel run twice
               bit for bit; kernel ms, plain ms and host wall, bound, and
               for K9 at m = 900 a dense torch.linalg.solve of the (6m)^2
               system, for K11 torch.cdist and its minima on both axes, for
               K12's assembly one index_add_ of every edge's packed terms;
               K10 (csrc/gicp.cu) on the first Gauss-Newton iteration of
               each scale of phase 18's ``full`` run (10240-21504 sorted
               rows) and of the Facade-scale pair's finest scale (check_k10:
               gicp_move's starts bit-equal to the rule's, q_sp within 1e-4
               m, gicp_rows' sums within 1e-4 of the largest entry with the
               counts exact, gicp_update's T within 1e-6 of the plain update
               of the same sums; each twice bit for bit), each launch's ms,
               plain ms and bound at the finest scales and one iteration's
               chain with K1 against the plain chain; at most 5 device
               operations a band GICP iteration (profiler); the band sweep's
               slab_starts (csrc/band_nn.cu) bit-equal to the rule in
               PyTorch on every shape phase 18's run gave it (the GICP's
               final metrics, the gate, stage 3's information matrices,
               stage 1's features), twice bit for bit.
 24. knn kernel — K13 (exact k-NN, csrc/knn.cu) against its plain
               version on knn_exact's arguments: the selection features'
               k = 200 self-kNN (exclude_self) of phase 22's first and last
               Facade scans in the 90112-row bucket (44.6k and 83.6k valid)
               and of the NCLT circuit's scan 0 in its 24576-row bucket, a
               query cloud other than the refs (the last Facade scan against
               the first half of its bucket), viz's k = 1, and every
               knn_exact call of the unfused pyramid
               (build_pyramid(fused=False): k = 30 outlier
               statistics and k = 20 normals at the 5 scales): d2 and
               indices equal, twice bit for bit, sampled rows within FP32
               rounding of the float64 k smallest; kernel ms, plain ms,
               bound, and the former tiled torch.topk path (knn_tiled) at the
               Facade, NCLT and finest pyramid shapes.
 25. voxel counts — the pyramid planner's occupied-voxel counts
               (feature_kernels.voxel_counts, csrc/voxel_counts.cu) at 2, 32
               and 128 NCLT-scale scans (the circuit's 8, each copy moved
               by its own offset), 5 scales: the table bit-equal to the
               host route's (native.count_voxels) on the same CUDA clouds,
               plan_scale_caps' caps equal to the host route's on CPU
               clouds and through a LazyClouds on the card at 128; the
               kernel's ms (every chunk of the call), the planner's wall
               on the card and the host route's wall on the same CUDA
               clouds (copies and sorts, the former path; the record's
               ``plain_ms``), the bound.
The line before the last is the kernels' JSON record (``launches``: K1-K6,
K8-K12 and slab_starts from the CLI's ``full`` run of phase 18, K7 from the
brute GICP; ``max_abs_err`` of K4 over the cloud's real rows, of K8 over
the normalised poses, of K9 the refined solve's relative residual, of K11
the worst differing pick over its rounding bound, of K12's blocks their
worst error over its bound and of its assembly the (zero) difference from
the CPU's, of K10's launches the worst q_sp, sums and T error; the times
of K8 and K11 at the main path's shape, one NCLT pair, of K9 and K12 at
n = 901, of K10 at the main path's finest scale and of slab_starts at its
largest shape; K12 is two records, ``edge_blocks`` and ``edge_assembly``,
and K10 three, ``gicp_move``, ``gicp_rows`` and ``gicp_update``, one a
launch);
the last line is {"ok": true, "device": {...}}.  A kernel's ``bound_ms`` is the larger of its
bytes (each input read once, each output written once; K8 needs p and q
only on the rows of nonzero weight) over 3.35 TB/s and
its FP32 operations over 67 TFLOP/s (H100 SXM data sheet), counting one d2
and one compare (9 operations) per (query, candidate) pair and the per-pair
work of the pairs this run's data keeps (K8: 70 operations a kept row a
step and about 400 a pair a step; K9: the elimination's count a block
step; K11: the 33-term dot and 5 more a pair; K12: EDGE_BLOCK_OPS an edge
and one addition a term of the assembly; K13: the d2 of every query
against every valid ref, a brute-force selection's work, which K13 beats
by skipping ref tiles); ``library_ms`` is null for K1-K6,
K8 and K12's blocks, as no single PyTorch call computes a banded
neighbourhood reduction, the GNC or an SE(3) log's Jacobian, for K7 the
time of torch.cdist (direct formula) and its row minimum, for K9 that of
torch.linalg.solve on the dense (6m)^2 system, for K11 torch.cdist and
its minima on both axes, for K12's assembly one index_add_ and for K13
the tiled torch.topk selection it replaced (``ops/knn.knn_tiled``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
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
# stage 1 (FGR): twice the worst real NCLT FGR error of the circuit's pairs
# (22 cm / 2.1 deg, make_circuit's ``err``)
MAX_FGR_T_ERR_M = 0.5
MAX_FGR_R_ERR_DEG = 5.0
SEED = 0
SIDE_STEP_M = 1.0         # the way back runs this far to the left of the way out
# the retry ladder: this pair's initial translation is thrown this far off
RETRY_PAIR = 1
RETRY_OFFSET_M = 50.0
# exact-correspondence GICP against the band GICP, pair by pair
MAX_BRUTE_BAND_T_M = 0.005
MAX_BRUTE_BAND_R_DEG = 0.05
FEATURE_BAND = 2048       # PipelineConfig.stage1_band
FEATURE_Q_TILE = 512      # fgr_features_sorted's query tile
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


# ---------------------------------------------------------------------------
# Synthetic circuit (numpy, from SEED)
# ---------------------------------------------------------------------------

def _rot_z(a: float) -> np.ndarray:
    c, s = math.cos(a), math.sin(a)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def _cylinder(rng, m: int, x: float, y: float, radius: float, z0: float, height: float):
    """m samples of a vertical cylinder's side."""
    a = rng.uniform(0, 2 * np.pi, m)
    return np.stack([x + radius * np.cos(a), y + radius * np.sin(a),
                     z0 + rng.uniform(0, height, m)], 1)


def _sphere(rng, m: int, c, radius: float):
    """m samples of a sphere's surface."""
    v = rng.normal(size=(m, 3))
    return np.asarray(c) + radius * v / np.linalg.norm(v, axis=1, keepdims=True)


def _world(rng: np.random.Generator, center: np.ndarray) -> np.ndarray:
    """Dense point samples of a scene that constrains all six degrees of
    freedom and gives FPFH distinct neighbourhoods: undulating ground with
    mounds, walls in three directions, yawed boxes, trees (trunk and
    canopy) and poles."""
    parts = []
    # ground within 36 m: low bumps (a few cm to 20 cm)
    n = 900_000
    r = 36.0 * np.sqrt(rng.random(n))
    th = rng.uniform(0, 2 * np.pi, n)
    x, y = center[0] + r * np.cos(th), center[1] + r * np.sin(th)
    z = (0.12 * np.sin(0.31 * x) * np.cos(0.27 * y) + 0.05 * np.sin(1.3 * x + 0.7 * y)
         - 1.8)
    # terrain: 12 plane waves (wavelengths >= 2.1 m, amplitudes 0.06-0.2 m),
    # so that every 1 m FPFH neighbourhood of the ground has its own shape
    for kx, ky, ph, a in rng.uniform([-3.0, -3.0, 0.0, 0.06], [3.0, 3.0, 2 * np.pi, 0.2],
                                     (12, 4)):
        z += a * np.sin(kx * (x - center[0]) + ky * (y - center[1]) + ph)
    # mounds: (x, y, height, width) Gaussian bumps
    for mx, my, mh, mw in rng.uniform([-25, -25, 0.3, 1.0], [25, 25, 1.2, 3.0], (24, 4)):
        z += mh * np.exp(-((x - center[0] - mx) ** 2 + (y - center[1] - my) ** 2)
                         / (2 * mw * mw))
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
    boxes += [tuple(b) for b in rng.uniform([-25, -25, -np.pi, 1.5, 1.5, 0.8],
                                            [25, 25, np.pi, 4.5, 2.0, 1.6], (14, 6))]
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
    # trees: (x, y, trunk radius, trunk height, canopy radius)
    for tx, ty, tr, th_, cr in rng.uniform([-25, -25, 0.15, 2.0, 1.0],
                                          [25, 25, 0.4, 4.0, 2.5], (40, 5)):
        parts.append(_cylinder(rng, int(3000 * th_ * tr), center[0] + tx, center[1] + ty,
                               tr, -1.8, th_))
        parts.append(_sphere(rng, int(1500 * cr * cr), [center[0] + tx, center[1] + ty,
                                                         th_ - 1.8 + 0.8 * cr], cr))
    # poles: (x, y, height)
    for px, py, ph in rng.uniform([-25, -25, 3.0], [25, 25, 7.0], (20, 3)):
        parts.append(_cylinder(rng, int(400 * ph), center[0] + px, center[1] + py, 0.1,
                               -1.8, ph))
    return np.concatenate(parts)


def make_circuit(seed: int = SEED):
    """(scans as (n_i, 3) float32 arrays in their sensor frames,
    ground-truth relative poses (N_SCANS, 4, 4), initial poses (N_SCANS, 4, 4)).

    An out-and-back circuit: the way out follows NCLT's first refined
    relative motions, the way back passes the same places SIDE_STEP_M to the
    left in reverse order, so every pair, the closing one included, is a
    neighbour pair (0.45-1.5 m apart).  Each initial pose carries the real
    FGR error of NCLT pair k (relative_FGR @ inv(relative_FGR_GICP)).
    """
    z = np.load(ROOT / "outputs" / "NCLT_poses.npz")
    rel_ref, rel_fgr = z["relative_FGR_GICP"], z["relative_FGR"]
    forward = [np.eye(4)]
    for k in range(N_SCANS // 2 - 1):
        forward.append(forward[-1] @ rel_ref[k])
    side = np.eye(4)
    side[1, 3] = SIDE_STEP_M
    absolute = forward + [A @ side for A in reversed(forward)]
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


def thrown_off(init: np.ndarray, pair: int, offset_m: float) -> np.ndarray:
    """``init`` with pair ``pair``'s translation moved ``offset_m`` along x."""
    out = init.copy()
    out[pair, 0, 3] += offset_m
    return out


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


SPIN_CYCLES = 1_000_000   # ~0.5 ms of the card's clock


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` runs, CUDA events.  Each
    run is enqueued behind a short spin on the device, so that the host's
    part of a launch (allocating outputs, the call into the library) runs
    ahead of the card and is not counted as a kernel's time."""
    import torch

    fn()                                                  # warm up
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(n_bytes: float, ops: float) -> tuple[float, str]:
    """(least milliseconds the card could take, what bounds it): the larger
    of the bytes over the memory rate and the FP32 operations over the peak."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def slab_work(starts, q, r, q_tile: int, band: int, per_kept: float, tau=None,
              exclude_self: bool = False) -> float:
    """FP32 operations of a slab pass: 9 a (query, slab row) pair (the d2 and
    one threshold compare) plus ``per_kept`` for every pair the data keeps
    (real, d2 <= tau and, for K5/K6, d2 > 0 off the query's own row)."""
    from pcr_tpu_torch.ops.kernels import common
    from pcr_tpu_torch.ops.kernels import feature_kernels as fk

    n_tiles = starts.shape[0]
    pairs = n_tiles * q_tile * 2 * band
    if tau is None:
        return 9.0 * pairs
    q_t, tau_t = q.view(n_tiles, q_tile, 3), tau.view(n_tiles, q_tile)
    kept = 0
    for g in common.tile_groups(n_tiles, q_tile * 2 * band):
        d2 = common.sqdist_tiles(q_t[g], common.slabs(starts[g], r, band))
        if exclude_self:
            keep = fk.pair_keep(d2, tau_t[g], starts[g], q_tile, band, g.start)
        else:
            keep = (d2 < common.REAL_D2_MAX) & (d2 <= tau_t[g][..., None])
        kept += int(keep.sum())
    return 9.0 * pairs + per_kept * kept


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def stage2_config(output_root: str):
    """The reference's stage-2 defaults, as the slice phase runs them."""
    from pcr_tpu_torch import pipeline

    return pipeline.PipelineConfig(
        dataset="NCLT", mgicp_scales=5, mgicp_iterations=100, batch_size=1,
        retry_failed=False, scale_capacities="auto", output_root=output_root)


def k1_inputs(src, tgt, T, max_dist: float, band: int):
    """(slab starts, sorted queries, sorted refs) that ``nn1_band_query``
    hands K1 (q_tile 1024) for the cloud src moved by T in tgt."""
    import torch

    from pcr_tpu_torch.ops import band_nn
    from pcr_tpu_torch.utils import se3
    from pcr_tpu_torch.utils.cloud import pad_rows

    p = se3.transform_points(T, src.points)
    index = band_nn.build_band_index(p, src.mask, tgt.points, tgt.mask, band=band)
    nq_pad = -(-p.shape[0] // 1024) * 1024
    q = torch.where(src.mask[:, None], p, band_nn.SENTINEL)[index.q_order]
    q = pad_rows(q, nq_pad, band_nn.SENTINEL).contiguous()
    return band_nn.slab_starts(index, q, max_dist, 1024, band), q, index.r_sorted


def first_min_rows(starts, q, r, q_tile: int, band: int, d_min):
    """Absolute row of each query's first slab row at d2 == d_min (its first
    minimum), found without relying on torch.min's tie rule."""
    import torch

    from pcr_tpu_torch.ops.kernels import common

    n_tiles = starts.shape[0]
    q_t, dm = q.view(n_tiles, q_tile, 3), d_min.view(n_tiles, q_tile)
    col = torch.arange(2 * band, device=q.device)
    rows = []
    for g in common.tile_groups(n_tiles, q_tile * 2 * band):
        d2 = common.sqdist_tiles(q_t[g], common.slabs(starts[g], r, band))
        j = torch.where(d2 == dm[g][..., None], col, 2 * band).amin(dim=-1)
        rows.append(starts[g].long()[:, None] + j)
    return torch.cat(rows).reshape(-1).to(torch.int32)


def check_k1(label: str, src, tgt, T, max_dist: float, band: int):
    """K1 against its plain version on the slabs that ``nn1_band_query``
    builds for (src moved by T) in tgt: d2 bit-equal (the same rounded
    formula) and every row the query's first minimum; returns (max |d2
    err| (0), ms, plain ms, bound ms, bound by)."""
    import torch

    from pcr_tpu_torch.ops.kernels import nn_kernels as nk

    starts, q, r = k1_inputs(src, tgt, T, max_dist, band)
    d_k, i_k = nk.nn1_band(starts, q, r, q_tile=1024, band=band)
    d_p, i_p = nk.nn1_band_reference(starts, q, r, q_tile=1024, band=band)
    if not torch.equal(d_k, d_p):
        raise AssertionError(f"K1 {label}: d2 differs at {int((d_k != d_p).sum())} queries, "
                             f"max {float((d_k - d_p).abs().max())}")
    first = first_min_rows(starts, q, r, 1024, band, d_p)
    if not torch.equal(i_k, first):
        raise AssertionError(f"K1 {label}: {int((i_k != first).sum())} rows are not the "
                             f"first minimum")
    in_p = d_p <= max_dist * max_dist
    ms = cuda_ms(lambda: nk.nn1_band(starts, q, r, q_tile=1024, band=band), 20)
    plain_ms = cuda_ms(lambda: nk.nn1_band_reference(starts, q, r, q_tile=1024, band=band), 5)
    lim = bound(4 * starts.shape[0] + 12 * q.shape[0] + 12 * r.shape[0] + 8 * q.shape[0],
                slab_work(starts, q, r, 1024, band, 0.0))
    print(f"K1 nn1_band {label}: {q.shape[0]} q, band {band}, {int(in_p.sum())} in radius, "
          f"d2 bit-equal, rows the first minimum (torch.min's: "
          f"{int((i_p != first).sum())} differ), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {lim[0]:.4f} ms")
    return float((d_k - d_p).abs().max()), ms, plain_ms, *lim


@dataclasses.dataclass
class PreprocessInputs:
    """What ``preprocess_scale_fused(c, voxel_size, cap)`` hands K2 and K3
    (q_tile 1024), K3's survivors and tau taken from K2's plain version."""
    band: int
    k2_args: tuple        # (starts, p_q, p_r, spacing hint)
    k2_plain: tuple       # (mean_d, found, tau) of the plain version
    k3_args: tuple        # (starts, p_q, p_r, keep_r, tau, center)
    survivors: int


def preprocess_inputs(c, voxel_size: float, cap: int) -> PreprocessInputs:
    from pcr_tpu_torch.ops import preprocess, voxel
    from pcr_tpu_torch.ops.kernels import feature_kernels as fk
    from pcr_tpu_torch.utils.cloud import pad_rows

    d = voxel.voxel_downsample_cloud(c, voxel_size)
    points, mask = d.points[:cap], d.mask[:cap]
    band = preprocess._band_width(cap)
    _, ms_, p_q, p_r, starts = preprocess.sort_and_tile(points, mask, 1024, band)
    k2_args = (starts, p_q, p_r, voxel_size)
    mean_p, found_p, tau_p = fk.outlier_stats_reference(*k2_args, q_tile=1024, band=band)
    # the survivor gate of outlier_and_normals_sorted (std_ratio 1)
    stat = ms_ & found_p[:cap]
    keep = stat & (mean_p[:cap] <= mean_p[:cap][stat].mean() + mean_p[:cap][stat].std())
    keep_r = pad_rows(keep, p_r.shape[0], False)
    center = fk.slab_centroids(starts, p_r, band)
    return PreprocessInputs(band, k2_args, (mean_p, found_p, tau_p),
                            (starts, p_q, p_r, keep_r, tau_p, center), int(keep.sum()))


def check_k2_result(label: str, got, plain) -> float:
    """K2's found set and tau identical to the plain version's, its mean
    distance within 1e-5 relative; returns the largest |mean_d error|."""
    import torch

    (mean_k, found_k, tau_k), (mean_p, found_p, tau_p) = got, plain
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
    return float((mean_k - mean_p).abs().max())


def check_k3_result(label: str, S_k, S_p) -> float:
    """K3's neighbour counts identical to the plain version's, its moments
    within a summation-order bound; returns the largest |moment error|."""
    import torch

    if not torch.equal(S_k[:, 9], S_p[:, 9]):
        raise AssertionError(f"K3 {label}: neighbour counts differ")
    # summation-order bound: ~count * 2^-24 of the sum of |terms|, which the
    # trace, sqrt(count * trace) and count bound for every column
    trace = S_p[:, 3] + S_p[:, 6] + S_p[:, 8]
    tol = 1e-5 * (trace + torch.sqrt(S_p[:, 9] * trace) + S_p[:, 9]) + 1e-6
    if bool(((S_k - S_p).abs() > tol[:, None]).any()):
        raise AssertionError(f"K3 {label}: moments max err {float((S_k - S_p).abs().max())}")
    return float((S_k - S_p).abs().max())


def check_k2_k3(label: str, c, voxel_size: float, cap: int):
    """K2 and K3 against their plain versions on the cloud that
    ``preprocess_scale_fused(c, voxel_size, cap)`` hands them; returns
    ((K2 err, ms, plain ms, bound ms, bound by), (the same for K3))."""
    from pcr_tpu_torch.ops.kernels import feature_kernels as fk

    inp = preprocess_inputs(c, voxel_size, cap)
    band, k2_args, k3_args = inp.band, inp.k2_args, inp.k3_args
    starts, p_q, p_r = k2_args[:3]
    mean_p, found_p, tau_p = inp.k2_plain
    err2 = check_k2_result(label, fk.outlier_stats(*k2_args, q_tile=1024, band=band),
                           inp.k2_plain)
    ms2 = cuda_ms(lambda: fk.outlier_stats(*k2_args, q_tile=1024, band=band), 10)
    n_pad, nr_pad = p_q.shape[0], p_r.shape[0]
    lim2 = bound(4 * starts.shape[0] + 12 * n_pad + 12 * nr_pad + 9 * n_pad,
                 slab_work(starts, p_q, p_r, 1024, band, 2.0, tau=tau_p))
    plain2 = cuda_ms(lambda: fk.outlier_stats_reference(*k2_args, q_tile=1024, band=band), 3)
    print(f"K2 outlier_stats {label}: {cap} rows, band {band}, {int(found_p.sum())} found, "
          f"found/tau equal, max |mean_d err| {err2:.3e}, kernel {ms2:.4f} ms, "
          f"plain {plain2:.4f} ms")

    S_p = fk.survivor_moments_reference(*k3_args, q_tile=1024, band=band)
    err3 = check_k3_result(label, fk.survivor_moments(*k3_args, q_tile=1024, band=band), S_p)
    ms3 = cuda_ms(lambda: fk.survivor_moments(*k3_args, q_tile=1024, band=band), 10)
    lim3 = bound(16 * starts.shape[0] + 12 * n_pad + 13 * nr_pad + 44 * n_pad,
                 9.0 * n_pad * 2 * band + 19.0 * float(S_p[:, 9].sum()))
    plain3 = cuda_ms(lambda: fk.survivor_moments_reference(*k3_args, q_tile=1024,
                                                           band=band), 3)
    print(f"K3 survivor_moments {label}: {cap} rows, band {band}, {inp.survivors} "
          f"survivors, counts equal, max |moment err| {err3:.3e}, kernel {ms3:.4f} ms, "
          f"plain {plain3:.4f} ms")
    return (err2, ms2, plain2, *lim2), (err3, ms3, plain3, *lim3)


def record(name: str, source: str, replaces: str, results: list, timed: tuple) -> dict:
    """A kernel's entry of the JSON line: the worst error over every checked
    shape, and the times and bound of the main path's shape ``timed``
    (err, ms, plain ms, bound ms, bound by[, library ms])."""
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                max_abs_err=max(r[0] for r in results), ms=timed[1], plain_ms=timed[2],
                bound_ms=timed[3], bound_by=timed[4],
                library_ms=timed[5] if len(timed) > 5 else None)


def phase_kernels(dev, clouds, gt) -> list[dict]:
    """Each kernel against its plain version at every shape and band the
    main path gives it on the first pair (scan 1 into scan 0): K2/K3 at each
    pyramid scale, K1 at each scale's GICP band and final-metrics band, at
    the gate evaluation and at stage 3's information matrix (scan 0 into
    scan 1).  A kernel's time in the JSON record is that of
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
    print("K2/K3 ms by scale: " + "; ".join(
        f"{v:.1f} m ({cap} rows) {a[1]:.4f} / {b[1]:.4f}"
        for v, cap, a, b in zip(scales, caps, k2, k3)))

    src_pyr = multiscale.build_pyramid(src, len(scales), caps)
    tgt_pyr = multiscale.build_pyramid(tgt, len(scales), caps)
    k1, k1_labels = [], []
    for s, (v, cap, dist) in enumerate(zip(scales, caps, dists)):
        band = gicp._band_width(cap, 1024)
        k1_gicp_finest = check_k1(f"GICP scale {v:.1f} m", src_pyr[s], tgt_pyr[s], T,
                                  dist, band)
        k1.append(k1_gicp_finest)
        k1_labels.append(f"GICP {v:.1f} m ({cap} rows, band {band})")
        band_f = gicp._band_width(cap, 2048)
        if band_f != band:
            k1.append(check_k1(f"final metrics scale {v:.1f} m", src_pyr[s], tgt_pyr[s], T,
                               dist, band_f))
            k1_labels.append(f"final metrics {v:.1f} m (band {band_f})")
    k1.append(check_k1("gate", src, tgt, T, 2 * cfg.voxel_size, 2048))
    k1_labels.append("gate (band 2048)")
    # stage 3's information matrix of edge 0: scan 0 into scan 1 at the
    # inverted edge pose, within one voxel
    k1.append(check_k1("information matrix", tgt, src, torch.linalg.inv(T), cfg.voxel_size,
                       2048))
    k1_labels.append("stage-3 information matrix (band 2048)")
    print("K1 ms by shape: " + "; ".join(f"{name} {r[1]:.4f} (bound {r[3]:.4f})"
                                         for name, r in zip(k1_labels, k1)))

    return [
        record("nn1_band", "pcr_tpu_torch/csrc/band_nn.cu",
               "pcr_tpu/ops/pallas/nn_kernels.py:92", k1, k1_gicp_finest),
        record("outlier_stats", "pcr_tpu_torch/csrc/preprocess.cu",
               "pcr_tpu/ops/pallas/feature_kernels.py:479", k2, k2[-1]),
        record("survivor_moments", "pcr_tpu_torch/csrc/preprocess.cu",
               "pcr_tpu/ops/pallas/feature_kernels.py:580", k3, k3[-1]),
    ]


STAGE2_KERNELS = ("nn1_band", "outlier_stats", "survivor_moments", "gicp_move", "gicp_rows",
                  "gicp_update")
STAGE1_KERNELS = ("nn1_band", "moments", "spfh", "fpfh", "nn1_mutual", "gnc")
LM_KERNELS = ("block_thomas", "edge_blocks", "edge_assembly")
BRUTE_KERNELS = ("nn1",)


def _launch_counts() -> list:
    from pcr_tpu_torch.ops.kernels import feature_kernels as fk
    from pcr_tpu_torch.ops.kernels import gicp_kernels as k10
    from pcr_tpu_torch.ops.kernels import graph_kernels as gk
    from pcr_tpu_torch.ops.kernels import loop_kernels as lk
    from pcr_tpu_torch.ops.kernels import nn_kernels as nk

    return [nk.LAUNCHES, fk.LAUNCHES, lk.LAUNCHES, gk.LAUNCHES, k10.LAUNCHES]


def reset_launches() -> None:
    for counts in _launch_counts():
        for key in counts:
            counts[key] = 0


def read_launches() -> dict:
    return {k: v for counts in _launch_counts() for k, v in counts.items()}


def check_launched(launches: dict, names, what: str) -> None:
    for name in names:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched by {what}")


def check_lm_launches(launches: dict, what: str, circuit: bool = True) -> None:
    """K12's two launches once an LM iteration (and, on a circuit, K9's two
    solves)."""
    its = launches["edge_blocks"]
    if not (its > 0 and launches["edge_assembly"] == its
            and launches["block_thomas"] == (2 * its if circuit else 0)):
        raise AssertionError(f"{what}: K12 launched {its} / {launches['edge_assembly']} times, "
                             f"K9 {launches['block_thomas']} times")


def check_matching_launches(launches: dict, what: str, exact: bool) -> None:
    """K11 once a stage-1 pair (at least, where the retry ladder may match
    a retried pair again)."""
    k = launches["nn1_mutual"]
    if not (k == N_SCANS if exact else k >= N_SCANS):
        raise AssertionError(f"{what}: K11 launched {k} times for {N_SCANS} pairs")


LOOP_INPUTS: dict = {}   # (kernel, case) -> a path's first arguments, for phase 23


@contextlib.contextmanager
def watching(module, name: str, calls: list | None = None, keep=None):
    """While the block runs, append to ``calls`` at every call of
    ``module.name`` and keep its first call's arguments as
    LOOP_INPUTS[keep]."""
    original = getattr(module, name)

    def watched(*args, **kw):
        if calls is not None:
            calls.append(name)
        if keep is not None:
            LOOP_INPUTS.setdefault(keep, args)
        return original(*args, **kw)

    setattr(module, name, watched)
    try:
        yield
    finally:
        setattr(module, name, original)


@contextlib.contextmanager
def plain_loops():
    """While the block runs, the loop kernels' wrappers (K8, K9, K10 and the
    band sweep's slab starts, K12) are their plain versions (the code the
    port ran before them), on the card."""
    from pcr_tpu_torch.ops.kernels import gicp_kernels as k10
    from pcr_tpu_torch.ops.kernels import graph_kernels as gk
    from pcr_tpu_torch.ops.kernels import loop_kernels as lk
    from pcr_tpu_torch.ops.kernels import nn_kernels as nk

    wrappers = (lk.gnc, lk.block_thomas, gk.edge_blocks, gk.assemble_band, gk.assemble_dense,
                k10.gicp_move, nk.slab_starts, k10.gicp_rows, k10.gicp_update)
    lk.gnc, lk.block_thomas = lk.gnc_reference, lk.block_thomas_reference
    gk.edge_blocks = gk.edge_blocks_reference
    gk.assemble_band = lambda plan, *blocks: gk.assemble_band_reference(
        plan.n, plan.src.long(), plan.dst.long(), *blocks)
    gk.assemble_dense = lambda plan, *blocks: gk.assemble_dense_reference(
        plan.n, plan.src.long(), plan.dst.long(), *blocks)
    k10.gicp_move, nk.slab_starts = k10.gicp_move_reference, nk.slab_starts_reference
    k10.gicp_rows, k10.gicp_update = k10.gicp_rows_reference, k10.gicp_update_reference
    try:
        yield
    finally:
        (lk.gnc, lk.block_thomas, gk.edge_blocks, gk.assemble_band, gk.assemble_dense,
         k10.gicp_move, nk.slab_starts, k10.gicp_rows, k10.gicp_update) = wrappers


GICP_PAIRS = ("nclt", "facade")
FACADE_START_ERR = (0.05, 0.02)   # m along x, rad about z: the Facade pair's start off truth


def gicp_pair(kind: str, dev):
    """(source pyramid, target pyramid, start pose, ground truth) of a
    5-scale band M-GICP at the main path's capacities (``plan_scale_caps``):
    ``nclt``, the circuit's first pair (scan 1 into scan 0) from its
    FGR-error start; ``facade``, the Facade-scale circuit's first pair in
    the 90112 bucket, from its truth moved FACADE_START_ERR."""
    from pcr_tpu_torch.models import multiscale
    from pcr_tpu_torch.utils import cloud

    if kind == "nclt":
        scans, gt, init = make_circuit()
        cap, T_gt, T0 = CAPACITY, gt[0], init[0]
    else:
        scans, absolute = make_facade_circuit()
        cap, T_gt = FACADE_CAPACITY, np.linalg.inv(absolute[0]) @ absolute[1]
        E = np.eye(4)
        E[:3, :3], E[0, 3] = _rot_z(FACADE_START_ERR[1]), FACADE_START_ERR[0]
        T0 = E @ T_gt
    src, tgt = (cloud.from_numpy(scans[k], cap, device=dev) for k in (1, 0))
    caps = cloud.plan_scale_caps([src, tgt], multiscale.create_scales(5))
    pyrs = [multiscale.build_pyramid(c, 5, scale_capacities=caps) for c in (src, tgt)]
    return pyrs[0], pyrs[1], T0.astype(np.float32), T_gt


@contextlib.contextmanager
def keeping_k10(kept: dict):
    """While the block runs, keep in ``kept`` the arguments of K10's three
    launches in the first Gauss-Newton iteration at each number of sorted
    rows, ("k10", rows) -> {name: (args, keywords)}, cloned as they were at
    the call (the loop updates T and its state in place), and those of the
    first band sweep's slab starts at each shape, ("slab_starts", queries,
    band) -> (args, keywords)."""
    import torch

    from pcr_tpu_torch.ops.kernels import gicp_kernels as k10
    from pcr_tpu_torch.ops.kernels import nn_kernels as nk

    modules = {"gicp_move": k10, "gicp_rows": k10, "gicp_update": k10, "slab_starts": nk}
    wrappers = {name: getattr(module, name) for name, module in modules.items()}
    iteration = None

    def keep(name):
        def call(*args, **kw):
            nonlocal iteration
            if name == "slab_starts":
                kept.setdefault(("slab_starts", args[0].shape[0], kw["band"]), (args, kw))
                return wrappers[name](*args, **kw)
            if name == "gicp_move":
                key = ("k10", args[1].shape[0])
                iteration = None if key in kept else kept.setdefault(key, {})
            if iteration is not None and name not in iteration:
                iteration[name] = (tuple(a.clone() if torch.is_tensor(a) else a for a in args),
                                   kw)
            return wrappers[name](*args, **kw)
        return call

    for name, module in modules.items():
        setattr(module, name, keep(name))
    try:
        yield
    finally:
        for name, module in modules.items():
            setattr(module, name, wrappers[name])


def k10_inputs(src, tgt, max_dist: float, T, loss: str = "l1", q_tile: int = 1024) -> dict:
    """The arguments of K10's three launches in the first Gauss-Newton
    iteration of registration_gicp(src, tgt, max_dist, T) (``keeping_k10``):
    name -> (args, keywords)."""
    from pcr_tpu_torch.models import gicp

    kept = {}
    with keeping_k10(kept):
        gicp.registration_gicp(src, tgt, max_dist, T, loss=loss, max_iteration=1,
                               q_tile=q_tile)
    return next(v for k, v in kept.items() if k[0] == "k10")


K10_MOVE_ROW_BYTES = 25   # a sorted row moved: 12 + 1 read, 12 written
K10_ROWS_ROW_BYTES = 65   # a sorted row summed: q_sp, normal 12 + 12, mask 1, K1's 8, target 32
K10_ROW_OPS = 330         # FP32 operations of a valid row in gicp_rows, a reckoning
K10_PARTIAL_BYTES = 4 * 32  # a partial row of gicp_rows


def check_k10(label: str, inputs: dict, timed: bool = False) -> dict:
    """K10 on one iteration's arguments (``k10_inputs``) against its plain
    versions: gicp_move's starts bit-equal to those of the band sweep's
    slab_starts kernel and of the rule in PyTorch
    (nn_kernels.slab_starts_reference) on its q_sp, q_sp within MAX_K10_Q of
    the plain one; gicp_rows' partial rows summed, with the plain sums'
    counts exactly and its H, g and sum of d2 within MAX_K10_SUMS of the
    largest of each; gicp_update's T within MAX_K10_T of the plain update of
    the same sums and its state's fitness and rmse within MAX_K10_SUMS; two
    runs bit for bit.  With ``timed``, each launch's ms (CUDA events behind a
    device spin, median of 20) beside its plain version's (``plain_times``,
    median of 20) and its bound, and one iteration's chain with K1, through
    K10 and through the plain versions, each with its host wall; ``timed``
    adds (err, ms, plain ms, bound ms, bound by) under each launch's name."""
    import torch

    from pcr_tpu_torch.ops.kernels import gicp_kernels as k10
    from pcr_tpu_torch.ops.kernels import nn_kernels as nk

    margs, mkw = inputs["gicp_move"]
    rargs, rkw = inputs["gicp_rows"]
    uargs, _ = inputs["gicp_update"]
    _, pts, _, index, max_dist = margs
    slab = (index.r_sorted, index.ra_sorted, index.axis, max_dist)
    q_k, s_k = k10.gicp_move(*margs, **mkw)
    q_k2, s_k2 = k10.gicp_move(*margs, **mkw)
    q_p, _ = k10.gicp_move_reference(*margs, **mkw)
    s_rule = nk.slab_starts_reference(q_k, *slab, **mkw)
    s_only = nk.slab_starts(q_k, *slab, **mkw)
    q_err = float((q_k - q_p).abs().max())
    if not (torch.equal(s_k, s_rule) and torch.equal(s_only, s_rule) and torch.equal(q_k, q_k2)
            and torch.equal(s_k, s_k2)):
        raise AssertionError(f"K10 {label}: gicp_move's or slab_starts' starts differ from the "
                             f"rule's on its q_sp, or between two runs")
    if not q_err <= MAX_K10_Q:
        raise AssertionError(f"K10 {label}: gicp_move's q_sp {q_err} off the plain one")
    rows_k = k10.gicp_rows(*rargs, **rkw)
    if not torch.equal(rows_k, k10.gicp_rows(*rargs, **rkw)):
        raise AssertionError(f"K10 {label}: gicp_rows' sums differ between two runs")
    sums_k = rows_k.sum(dim=0, keepdim=True)
    sums_p = k10.gicp_rows_reference(*rargs, **rkw)
    if not torch.equal(sums_k[0, 27:29], sums_p[0, 27:29]):
        raise AssertionError(f"K10 {label}: counts {sums_k[0, 27:29].tolist()} against the plain "
                             f"{sums_p[0, 27:29].tolist()}")
    sums_err = max(float((sums_k[0, a:b] - sums_p[0, a:b]).abs().max()
                         / sums_p[0, a:b].abs().max().clamp(min=1e-30))
                   for a, b in ((0, 21), (21, 27), (29, 30)))
    _, T0, state0 = uargs[:3]
    rel = uargs[3:]
    T_k, st_k = T0.clone(), state0.clone()
    k10.gicp_update(sums_p, T_k, st_k, *rel)
    T_k2, st_k2 = T0.clone(), state0.clone()
    k10.gicp_update(rows_k, T_k2, st_k2, *rel)
    T_k3, st_k3 = T0.clone(), state0.clone()
    k10.gicp_update(rows_k, T_k3, st_k3, *rel)
    T_p, st_p = T0.clone(), state0.clone()
    k10.gicp_update_reference(sums_p, T_p, st_p, *rel)
    t_err = float((T_k - T_p).abs().max())
    st_err = float(((st_k[:2] - st_p[:2]).abs() / st_p[:2].abs().clamp(min=1e-30)).max())
    if not (sums_err <= MAX_K10_SUMS and t_err <= MAX_K10_T and st_err <= MAX_K10_SUMS
            and torch.equal(st_k[2:], st_p[2:]) and torch.isfinite(T_k2).all()
            and torch.equal(T_k2, T_k3) and torch.equal(st_k2, st_k3)):
        raise AssertionError(f"K10 {label}: sums {sums_err}, T {t_err}, state {st_err} "
                             f"({st_k.tolist()} against {st_p.tolist()}), or two updates differ")
    out = dict(q_err=q_err, sums_err=sums_err, T_err=t_err, state_err=st_err,
               rows=int(pts.shape[0]), band=mkw["band"], valid=int(sums_p[0, 27]))
    print(f"K10 {label}: {out['rows']} sorted rows ({out['valid']} valid), band {out['band']}: "
          f"starts bit-equal to the rule's, q_sp within {q_err:.3e}, sums within "
          f"{sums_err:.3e} (counts equal), T within {t_err:.3e}, state within {st_err:.3e}; "
          f"two runs bit for bit")
    if not timed:
        return out
    n, tiles, blocks = pts.shape[0], s_k.shape[0], rows_k.shape[0]
    T_u, st_u = T0.clone(), state0.clone()     # the update in place, rep after rep
    T_v, st_v = T0.clone(), state0.clone()
    launches = {
        "gicp_move": (q_err, lambda: k10.gicp_move(*margs, **mkw),
                      lambda: k10.gicp_move_reference(*margs, **mkw),
                      bound(K10_MOVE_ROW_BYTES * n + 4 * tiles + 48, 18 * n)),
        "gicp_rows": (sums_err, lambda: k10.gicp_rows(*rargs, **rkw),
                      lambda: k10.gicp_rows_reference(*rargs, **rkw),
                      bound(K10_ROWS_ROW_BYTES * n + K10_PARTIAL_BYTES * blocks,
                            K10_ROW_OPS * out["valid"])),
        "gicp_update": (t_err, lambda: k10.gicp_update(rows_k, T_u, st_u, *rel),
                        lambda: k10.gicp_update_reference(sums_p, T_v, st_v, *rel),
                        bound(K10_PARTIAL_BYTES * blocks + 2 * 64, 30 * blocks + 600)),
    }
    for name, (err, kernel, plain, lim) in launches.items():
        out[name] = (err, cuda_ms(kernel, 20), plain_times(plain, 20)[0], *lim)

    def chain(move, rows_fn, update):
        T_c, st_c = T0.clone(), state0.clone()

        def run():
            q, s = move(*margs, **mkw)
            d, r = nk.nn1_band(s, q, index.r_sorted, q_tile=mkw["q_tile"], band=mkw["band"])
            update(rows_fn(q, *rargs[1:3], d, r, *rargs[5:], **rkw), T_c, st_c, *rel)
        return run

    kernel_ms, kernel_wall = plain_times(chain(k10.gicp_move, k10.gicp_rows, k10.gicp_update),
                                         20)
    plain_ms, plain_wall = plain_times(chain(k10.gicp_move_reference, k10.gicp_rows_reference,
                                             k10.gicp_update_reference), 20)
    k1_ms = cuda_ms(lambda: nk.nn1_band(s_k, q_k, index.r_sorted, q_tile=mkw["q_tile"],
                                        band=mkw["band"]), 20)
    out.update(k1_ms=k1_ms, chain_ms=kernel_ms, chain_wall_ms=kernel_wall, plain_ms=plain_ms,
               plain_wall_ms=plain_wall)
    print(f"K10 {label} timed: " + "; ".join(
        f"{name} {out[name][1]:.4f} ms (plain {out[name][2]:.4f} ms, bound {out[name][3]:.6f} "
        f"ms, {out[name][4]})" for name in launches)
        + f"; K1 {k1_ms:.4f} ms; one iteration's chain K10 + K1 {kernel_ms:.4f} ms (host "
          f"{kernel_wall:.4f} ms), plain chain + K1 {plain_ms:.4f} ms (host {plain_wall:.4f} ms)")
    return out


def check_slab_starts(label: str, inputs, timed: bool = False) -> tuple:
    """The band sweep's slab_starts kernel on one band query's arguments
    (``keeping_k10``) against the rule in PyTorch
    (nn_kernels.slab_starts_reference): bit-equal, two runs bit for bit.
    Returns (0.0,), or with ``timed`` (0.0, ms, plain ms, bound ms, bound
    by)."""
    import torch

    from pcr_tpu_torch.ops.kernels import nn_kernels as nk

    args, kw = inputs
    s_k = nk.slab_starts(*args, **kw)
    s_p = nk.slab_starts_reference(*args, **kw)
    if not (torch.equal(s_k, s_p) and torch.equal(s_k, nk.slab_starts(*args, **kw))):
        raise AssertionError(f"slab_starts {label}: the kernel's starts differ from the rule's "
                             f"or between two runs")
    if not timed:
        return (0.0,)
    n = args[0].shape[0]
    ms = cuda_ms(lambda: nk.slab_starts(*args, **kw), 20)
    plain_ms, plain_wall = plain_times(lambda: nk.slab_starts_reference(*args, **kw), 20)
    lim = bound(12 * n + 4 * s_k.shape[0], 0)
    print(f"slab_starts {label} timed: {ms:.4f} ms, plain {plain_ms:.4f} ms (host "
          f"{plain_wall:.4f} ms), bound {lim[0]:.6f} ms ({lim[1]})")
    return (0.0, ms, plain_ms, *lim)


def iteration_device_ops(src, tgt, max_dist: float, T0) -> float:
    """Device operations (``device_ops``) a band GICP iteration of ``src``
    into ``tgt`` launches: the difference between 11 and 1 iterations with
    the convergence test off, over 10."""
    from pcr_tpu_torch.models import gicp

    def run(n):
        return lambda: gicp.registration_gicp(src, tgt, max_dist, T0, max_iteration=n,
                                              relative_fitness=0.0, relative_rmse=0.0)

    return (device_ops(run(11)) - device_ops(run(1))) / 10


def check_pose_files(rel_dir: Path, out: np.ndarray) -> None:
    """The circuit's pose_{k+1}_{k}.txt files hold the returned poses."""
    if not np.isfinite(out).all() or out.shape != (N_SCANS, 4, 4):
        raise AssertionError("non-finite or misshapen poses")
    files = [rel_dir / f"pose_{k + 1}_{k}.txt" for k in range(N_SCANS - 1)]
    files.append(rel_dir / f"pose_0_{N_SCANS - 1}.txt")
    for k, f in enumerate(files):
        if not np.allclose(np.loadtxt(f), out[k], atol=1e-8):
            raise AssertionError(f"{f.name} does not hold pair {k}'s pose")


def timed_runs(label: str, runs, fn):
    """Run ``fn(run)`` for each run name with the launch counts set to 0
    just before; prints wall, pairs/s and launches; returns the last run's
    (result, launches, wall seconds)."""
    import torch

    for run in runs:
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(run)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        print(f"{label} {run} run: {wall:.3f} s, {N_SCANS / wall:.3f} pairs/s, "
              f"launches {launches}")
    return out, launches, wall


def run_stage2(clouds, gt, init, label: str, runs, retry_failed: bool = False,
               batch_size: int = 1):
    """Stage 2 over the circuit from ``init``; every pair within 3 cm /
    0.2 deg, and K1-K3 launched by the last run.  Returns its (poses,
    metrics, launches, wall seconds)."""
    from pcr_tpu_torch import pipeline

    with tempfile.TemporaryDirectory() as tmp:
        def one(run):
            cfg = dataclasses.replace(stage2_config(str(Path(tmp) / run)),
                                      retry_failed=retry_failed, batch_size=batch_size)
            metrics = pipeline.PairMetrics()
            out = pipeline.run_stage2_mgicp(cfg, init_poses=init.copy(), clouds=clouds,
                                            n=N_SCANS, metrics=metrics)
            return cfg, metrics, out

        (cfg, metrics, out), launches, wall = timed_runs(label, runs, one)
        check_pose_files(Path(cfg.out_dir("relative_poses_FGR_GICP")), out)
    worst = 0.0, 0.0
    for k, row in enumerate(metrics.rows):
        e_t, e_r = pose_error(out[k], gt[k])
        e0_t, e0_r = pose_error(init[k], gt[k])
        worst = max(worst[0], e_t), max(worst[1], e_r)
        print(f"pair ({row['src']},{row['tgt']}): init {e0_t * 100:.2f} cm {e0_r:.3f} deg"
              f" -> {e_t * 100:.3f} cm {e_r:.4f} deg; iterations/scale "
              f"{row['scale_iterations']}; fitness {row['fitness']:.4f}; "
              f"gate fitness {row['gate_fitness']:.4f}; status {row['status']}")
        if not (e_t < MAX_T_ERR_M and e_r < MAX_R_ERR_DEG):
            raise AssertionError(f"pair {k} off ground truth: {e_t} m, {e_r} deg")
    print(f"{label}: worst pair error {worst[0] * 100:.3f} cm, {worst[1]:.4f} deg "
          f"(limits {MAX_T_ERR_M * 100:g} cm, {MAX_R_ERR_DEG} deg)")
    check_launched(launches, STAGE2_KERNELS, label)
    return out, metrics, launches, wall


def phase_slice(clouds, gt, init):
    """Stage 2 over the circuit twice from the real NCLT FGR errors; returns
    the warm run's (poses, launch counts, wall seconds)."""
    out, _, launches, wall = run_stage2(clouds, gt, init, "stage 2", ("cold", "warm"))
    return out, launches, wall


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


@dataclasses.dataclass
class FeatureInputs:
    """What ``fgr_features_sorted(compact(c, bucket), voxel_size, band=band)``
    hands K4, K5 and K6 (q_tile FEATURE_Q_TILE): K5 is fed the plain K4's
    normals and K6 the plain K5's output, so that each kernel is compared
    with its plain version on identical inputs."""
    band: int
    valid: int            # rows of the cloud (the first sorted rows; the rest are padding)
    k4_args: tuple        # (starts, p_q, p_r, center, voxel size)
    k4_plain: object      # (n_pad, 10) moments of the plain version
    k5_args: tuple        # (starts, p_q, normals_q, p_r, normals_r, voxel size)
    k5_plain: tuple       # (hist, tau) of the plain version
    k6_args: tuple        # (starts, p_q, p_r, tau, spfh in ref-row order)
    k6_plain: object      # (n_pad, 33) sums of the plain version


def feature_inputs(c, voxel_size: float, bucket: int, band: int) -> FeatureInputs:
    from pcr_tpu_torch.ops import preprocess
    from pcr_tpu_torch.ops.kernels import feature_kernels as fk
    from pcr_tpu_torch.utils import cloud
    from pcr_tpu_torch.utils.cloud import pad_rows

    qt = FEATURE_Q_TILE
    cc = cloud.compact(c, bucket)
    n = cc.capacity
    _, ms_, p_q, p_r, starts = preprocess.sort_and_tile(cc.points, cc.mask, qt, band)
    n_pad, nr_pad = p_q.shape[0], p_r.shape[0]
    k4 = (starts, p_q, p_r, fk.slab_centroids(starts, p_r, band), voxel_size)
    S_p = fk.moments_reference(*k4, q_tile=qt, band=band)
    normals, _ = preprocess.normals_from_moments(S_p[:n], ms_)
    k5 = (starts, p_q, pad_rows(normals, n_pad, 0.0).contiguous(), p_r,
          pad_rows(normals, nr_pad, 0.0).contiguous(), voxel_size)
    h_p, tau_p = fk.spfh_reference(*k5, q_tile=qt, band=band)
    k6 = (starts, p_q, p_r, tau_p, pad_rows(h_p[:n], nr_pad, 0.0).contiguous())
    return FeatureInputs(band, int(ms_.sum()), k4, S_p, k5, (h_p, tau_p), k6,
                         fk.fpfh_reference(*k6, q_tile=qt, band=band))


def check_k4_result(label: str, S_k, S_p) -> float:
    """K4's neighbour counts identical to the plain version's (same d2
    formula, same bisection), its moments within K3's summation-order bound;
    returns the largest |moment error|."""
    import torch

    if not torch.equal(S_k[:, 9], S_p[:, 9]):
        raise AssertionError(f"K4 {label}: neighbour counts differ")
    trace = S_p[:, 3] + S_p[:, 6] + S_p[:, 8]
    tol = 1e-5 * (trace + torch.sqrt(S_p[:, 9] * trace) + S_p[:, 9]) + 1e-6
    if bool(((S_k - S_p).abs() > tol[:, None]).any()):
        raise AssertionError(f"K4 {label}: moments max err {float((S_k - S_p).abs().max())}")
    return float((S_k - S_p).abs().max())


def check_k5_result(label: str, got, plain) -> float:
    """K5's tau bit-equal to the plain version's, hence the same kept pairs,
    and its histograms bit-equal too: the pair features are the same rounded
    operations in the same order, a bin count is an integer whatever the
    order of the pairs, and 100 / count is one division.  Returns the largest
    |histogram error| (0)."""
    import torch

    (h_k, tau_k), (h_p, tau_p) = got, plain
    if not torch.equal(tau_k, tau_p):
        raise AssertionError(f"K5 {label}: tau differs at {int((tau_k != tau_p).sum())} rows")
    if not torch.equal(h_k, h_p):
        raise AssertionError(f"K5 {label}: histograms differ in "
                             f"{int((h_k != h_p).any(-1).sum())} rows, max "
                             f"{float((h_k - h_p).abs().max())}")
    return float((h_k - h_p).abs().max())


def fpfh_serial(starts, q, r, tau, spfh_r, q_tile: int, band: int):
    """K6's sums in K6's own order: each feature over the kept pairs in
    ascending slab row, one rounded product and one rounded add a row (two
    eager torch operations, no fused multiply-add), w = 1 / max(d2, 1e-12)
    and d2 as the kernel rounds them.  K6 must equal this bit for bit."""
    import torch

    from pcr_tpu_torch.ops.kernels import common
    from pcr_tpu_torch.ops.kernels import feature_kernels as fk

    n_tiles = starts.shape[0]
    d2 = common.sqdist_tiles(q.view(n_tiles, q_tile, 3), common.slabs(starts, r, band))
    keep = fk.pair_keep(d2, tau.view(n_tiles, q_tile), starts, q_tile, band)
    w = torch.reciprocal(torch.clamp(d2, min=1e-12))
    slab_spfh = common.slabs(starts, spfh_r, band)
    acc = torch.zeros((n_tiles, q_tile, fk.FEATURE_DIM), dtype=torch.float32, device=q.device)
    for j in range(2 * band):
        acc = torch.where(keep[:, :, j, None], acc + w[:, :, j, None] * slab_spfh[:, None, j],
                          acc)
    return acc.reshape(n_tiles * q_tile, fk.FEATURE_DIM)


def check_k6_result(label: str, a_k, a_p) -> float:
    """K6's sums of <= 201 nonnegative terms in another order than the plain
    version's: within 2 * 201 * 2^-24 (2.4e-5) of it, relative; returns the
    largest |sum error|."""
    if bool(((a_k - a_p).abs() > 2.4e-5 * a_p.abs() + 1e-7).any()):
        rel = float(((a_k - a_p).abs() / a_p.abs().clamp(min=1e-30)).max())
        raise AssertionError(f"K6 {label}: sums differ, max relative {rel:.3e}")
    return float((a_k - a_p).abs().max())


def check_k4_k6(label: str, c, voxel_size: float, bucket: int, band: int):
    """K4, K5 and K6 against their plain versions on ``feature_inputs``'
    tensors, and K6 bit for bit against ``fpfh_serial``; returns one (err,
    ms, plain ms, bound ms, bound by) per kernel."""
    import torch

    from pcr_tpu_torch.ops.kernels import feature_kernels as fk

    qt = FEATURE_Q_TILE
    inp = feature_inputs(c, voxel_size, bucket, band)
    k4, k5, k6 = inp.k4_args, inp.k5_args, inp.k6_args
    starts, p_q, p_r = k6[:3]
    n_pad, nr_pad, n_tiles = p_q.shape[0], p_r.shape[0], starts.shape[0]
    S_p, (_, tau_p), a_p = inp.k4_plain, inp.k5_plain, inp.k6_plain

    S_k = fk.moments(*k4, q_tile=qt, band=band)
    err4 = check_k4_result(label, S_k, S_p)
    err4_cloud = float((S_k - S_p)[:inp.valid].abs().max())
    ms4 = cuda_ms(lambda: fk.moments(*k4, q_tile=qt, band=band), 10)
    plain4 = cuda_ms(lambda: fk.moments_reference(*k4, q_tile=qt, band=band), 3)
    lim4 = bound(16 * n_tiles + 12 * n_pad + 12 * nr_pad + 40 * n_pad,
                 9.0 * n_pad * 2 * band + 19.0 * float(S_p[:, 9].sum()))
    print(f"K4 moments {label}: {n_pad} rows, band {band}, counts equal, max |moment err| "
          f"{err4_cloud:.3e} over the cloud's {inp.valid} rows ({err4:.3e} with the sentinel "
          f"rows past it, whose terms are ~1e12), kernel {ms4:.4f} ms, plain {plain4:.4f} ms, "
          f"bound {lim4[0]:.4f} ms")

    err5 = check_k5_result(label, fk.spfh(*k5, q_tile=qt, band=band), inp.k5_plain)
    ms5 = cuda_ms(lambda: fk.spfh(*k5, q_tile=qt, band=band), 10)
    plain5 = cuda_ms(lambda: fk.spfh_reference(*k5, q_tile=qt, band=band), 3)
    lim5 = bound(4 * n_tiles + 24 * n_pad + 24 * nr_pad + 136 * n_pad,
                 slab_work(starts, p_q, p_r, qt, band, 70.0, tau=tau_p, exclude_self=True))
    print(f"K5 spfh {label}: {n_pad} rows, band {band}, tau and histograms equal, max |hist "
          f"err| {err5:.3e}, kernel {ms5:.4f} ms, plain {plain5:.4f} ms, "
          f"bound {lim5[0]:.4f} ms")

    a_k = fk.fpfh(*k6, q_tile=qt, band=band)
    err6 = check_k6_result(label, a_k, a_p)
    if not torch.equal(a_k, fpfh_serial(*k6, qt, band)):
        raise AssertionError(f"K6 {label}: sums differ from the ascending-row serial sums")
    ms6 = cuda_ms(lambda: fk.fpfh(*k6, q_tile=qt, band=band), 10)
    plain6 = cuda_ms(lambda: fk.fpfh_reference(*k6, q_tile=qt, band=band), 3)
    lim6 = bound(4 * n_tiles + 12 * n_pad + 12 * nr_pad + 4 * n_pad + 132 * nr_pad
                 + 132 * n_pad,
                 slab_work(starts, p_q, p_r, qt, band, 67.0, tau=tau_p, exclude_self=True))
    print(f"K6 fpfh {label}: {n_pad} rows, band {band}, sums bit-equal to the serial "
          f"ascending-row sums, max |sum err| against the plain version {err6:.3e} (max sum "
          f"{float(a_p.max()):.3e}), kernel {ms6:.4f} ms, plain {plain6:.4f} ms, "
          f"bound {lim6[0]:.4f} ms")
    return ((err4_cloud, ms4, plain4, *lim4), (err5, ms5, plain5, *lim5),
            (err6, ms6, plain6, *lim6))


def phase_feature_kernels(clouds) -> list[dict]:
    """K4-K6 at the stage-1 path's shape (scan 0 at its bucket, band 2048),
    at a smaller one (a 4096-row compaction of scan 0, band 1024) and at
    fgr_features_sorted's own default band 4096; the JSON record keeps the
    first shape's times."""
    from pcr_tpu_torch.utils import cloud

    c = clouds[0]
    bucket = cloud.bucket_capacity(c, 4096)
    main = check_k4_k6("scan 0", c, 0.1, bucket, FEATURE_BAND)
    small = check_k4_k6("4096 rows", c, 0.1, 4096, 1024)
    widest = check_k4_k6("scan 0, band 4096", c, 0.1, bucket, 4096)
    src = "pcr_tpu_torch/csrc/fpfh.cu"
    fk_py = "pcr_tpu/ops/pallas/feature_kernels.py"
    return [record(name, src, f"{fk_py}:{line}", [a, b, w], a)
            for name, line, a, b, w in zip(("moments", "spfh", "fpfh"), (158, 317, 402),
                                           main, small, widest)]


def stage1_config(output_root: str):
    """The reference's stage-1 defaults (banded features, band 2048)."""
    from pcr_tpu_torch import pipeline

    return pipeline.PipelineConfig(dataset="NCLT", batch_size=1, output_root=output_root)


def phase_stage1(clouds, gt, batch_size: int = 1, label: str = "stage 1"):
    """Stage 1 over the circuit, cold and warm; every pair within 0.5 m /
    5 deg.  Returns (poses, the warm run's launch counts and wall seconds)."""
    from pcr_tpu_torch import pipeline
    from pcr_tpu_torch.models import fgr
    from pcr_tpu_torch.ops.kernels import nn_kernels as nk

    chunks = []
    with tempfile.TemporaryDirectory() as tmp:
        def one(run):
            cfg = dataclasses.replace(stage1_config(str(Path(tmp) / run)),
                                      batch_size=batch_size)
            metrics = pipeline.PairMetrics()
            chunks.clear()
            with watching(fgr, "batched_registration_fgr", calls=chunks), \
                    watching(fgr, "fgr_from_correspondences",
                             keep=("gnc", f"NCLT stage 1, batch {batch_size}")), \
                    watching(nk, "nn1_mutual", keep=("nn1_mutual", "NCLT stage-1 pair")):
                out = pipeline.run_stage1_fgr(cfg, clouds=clouds, n=N_SCANS, metrics=metrics)
            return cfg, metrics, out

        (cfg, metrics, out), launches, wall = timed_runs(label, ("cold", "warm"), one)
        check_pose_files(Path(cfg.out_dir("relative_poses_FGR")), out)
    # K8 once a pair streamed, once a chunk batched
    want = len(chunks) if batch_size > 1 else N_SCANS
    print(f"{label}: K8 (gnc) launches {launches['gnc']}, "
          f"{'chunks' if batch_size > 1 else 'pairs'} {want}")
    if launches["gnc"] != want:
        raise AssertionError(f"{label}: K8 launched {launches['gnc']} times for {want} GNCs")
    print(f"{label}: K11 (nn1_mutual) launches {launches['nn1_mutual']}, pairs {N_SCANS}")
    check_matching_launches(launches, label, exact=True)
    worst = 0.0, 0.0
    for k, row in enumerate(metrics.rows):
        e_t, e_r = pose_error(out[k], gt[k])
        worst = max(worst[0], e_t), max(worst[1], e_r)
        print(f"FGR pair ({row['src']},{row['tgt']}): {e_t * 100:.2f} cm {e_r:.3f} deg; "
              f"fitness {row['fitness']:.4f}")
        if not (e_t < MAX_FGR_T_ERR_M and e_r < MAX_FGR_R_ERR_DEG):
            raise AssertionError(f"FGR pair {k} off ground truth: {e_t} m, {e_r} deg")
    print(f"{label}: worst pair error {worst[0] * 100:.2f} cm, {worst[1]:.3f} deg "
          f"(limits {MAX_FGR_T_ERR_M * 100:g} cm, {MAX_FGR_R_ERR_DEG} deg)")
    check_launched(launches, STAGE1_KERNELS, label)
    return out, launches, wall


def phase_stage1_split(clouds) -> None:
    """Warm stage-1 time split into features per scan and, per pair,
    matching, tuple test, GNC and evaluation (a synchronize after each);
    then the GNC of the first two pairs one after another beside one GNC
    over both, as the batched runner runs it."""
    import torch

    from pcr_tpu_torch import pipeline
    from pcr_tpu_torch.models import evaluate, fgr
    from pcr_tpu_torch.utils import cloud

    cfg = stage1_config("unused")

    def clock():
        torch.cuda.synchronize()
        return time.perf_counter()

    t0 = clock()
    feats = [pipeline._prep_features(c, cloud.bucket_capacity(c, cfg.bucket_granularity),
                                     cfg.voxel_size, cfg.stage1_band) for c in clouds]
    t_feat = clock() - t0
    split = np.zeros(4)
    gnc_inputs = []
    for s, t in pipeline.circuit_pairs(N_SCANS):
        B = max(feats[s][0].capacity, feats[t][0].capacity)
        src, fs, tgt, ft = pipeline._pad_pair(*feats[s], *feats[t], B)
        opts = fgr.default_options_capacity(B, cfg.voxel_size)
        t0 = clock()
        ci, cj, cm = fgr.match_features(fs, src.mask, ft, tgt.mask)
        t1 = clock()
        cm = fgr.tuple_test(src.points, tgt.points, ci, cj, cm, cfg.fgr_seed + s,
                            max_tuples=opts.maximum_tuple_count)
        t2 = clock()
        T = fgr.fgr_from_correspondences(src, tgt, ci, cj, cm, opts)
        t3 = clock()
        evaluate.evaluate_registration(src, tgt, opts.maximum_correspondence_distance, T)
        split += np.array([t1 - t0, t2 - t1, t3 - t2, clock() - t3])
        gnc_inputs.append((src, tgt, ci, cj, cm))
    ms = split / N_SCANS * 1e3
    print(f"stage-1 split: features {t_feat / N_SCANS * 1e3:.1f} ms/scan; per pair: matching "
          f"{ms[0]:.1f} ms, tuple test {ms[1]:.1f} ms, GNC {ms[2]:.1f} ms, evaluation "
          f"{ms[3]:.1f} ms ({ms.sum():.1f} ms/pair)")
    # the batched runner's GNC: the first two pairs padded to one capacity,
    # their GNCs one after another beside one GNC over the pair of them
    B = max(x[0].capacity for x in gnc_inputs[:2])
    opts = fgr.default_options_capacity(B, cfg.voxel_size)
    pad = [(cloud.pad_to(src, B), cloud.pad_to(tgt, B), torch.arange(B, device=ci.device),
            cloud.pad_rows(cj, B, 0), cloud.pad_rows(cm, B, False))
           for src, tgt, ci, cj, cm in gnc_inputs[:2]]
    loop, batch = [], []
    for _ in range(3):
        t0 = clock()
        T_loop = torch.stack([fgr.fgr_from_correspondences(*x, opts) for x in pad])
        t1 = clock()
        T_batch = fgr.fgr_from_correspondences(
            cloud.stack_clouds([x[0] for x in pad]), cloud.stack_clouds([x[1] for x in pad]),
            *(torch.stack([x[i] for x in pad]) for i in (2, 3, 4)), opts)
        loop.append(t1 - t0)
        batch.append(clock() - t1)
    print(f"GNC of a chunk of 2 pairs (capacity {B}): one after another "
          f"{statistics.median(loop) * 1e3:.1f} ms, batched {statistics.median(batch) * 1e3:.1f} "
          f"ms (median of 3); poses within {float((T_loop - T_batch).abs().max()):.2e}")


def check_k7(label: str, q, r, library: bool = True):
    """K7 against its plain version on (q, r): d2 bit-equal and rows equal;
    returns (max |d2 err|, ms, plain ms, bound ms, bound by, library ms)."""
    import torch

    from pcr_tpu_torch.ops.kernels import nn_kernels as nk

    d_k, i_k = nk.nn1(q, r)
    d_p, i_p = nk.nn1_reference(q, r)
    if not torch.equal(d_k, d_p):
        raise AssertionError(f"K7 {label}: d2 differs at {int((d_k != d_p).sum())} queries, "
                             f"max {float((d_k - d_p).abs().max())}")
    if not torch.equal(i_k, i_p):
        raise AssertionError(f"K7 {label}: rows differ at {int((i_k != i_p).sum())} queries")
    nq, nr = q.shape[0], r.shape[0]
    ms = cuda_ms(lambda: nk.nn1(q, r), 20)
    plain = cuda_ms(lambda: nk.nn1_reference(q, r), 3)
    lib = None
    if library:   # one PyTorch call, direct formula (no matmul expansion), then the minimum
        lib = cuda_ms(lambda: torch.cdist(
            q, r, compute_mode="donot_use_mm_for_euclid_dist").min(dim=1), 5)
    lim = bound(12 * nq + 12 * nr + 8 * nq, 9.0 * nq * nr)
    print(f"K7 nn1 {label}: {nq} q x {nr} refs, {nk.nn1_splits(nq, nr, nk.nn1_slots(0))} "
          f"ref splits, d2 bit-equal, rows equal, kernel {ms:.4f} ms, plain {plain:.4f} ms, "
          f"bound {lim[0]:.4f} ms, library (cdist + min) "
          f"{'not timed' if lib is None else f'{lib:.4f} ms'}")
    return 0.0, ms, plain, *lim, lib


def k7_tie_inputs(nq: int, nr: int, boundaries, seed: int = 0):
    """(q (nq, 3), r (nr, 3)) float32 arrays full of exact ties for K7:
    refs on a 0.5 m lattice with every 7th row repeating an earlier one,
    queries on a 0.25 m lattice (many equidistant from several refs), ten of
    them on ref rows; and for each row b of ``boundaries`` (1 <= b < nr) one
    query off the lattice whose two nearest refs, rows b - 1 and b, lie at
    equal distance (1 m either side along x): its first minimum is row b - 1
    across whatever group or split boundary falls at b.  Those queries are
    the last ones, in the order of the sorted, distinct boundaries."""
    rng = np.random.default_rng(seed)
    r = rng.integers(-6, 7, size=(nr, 3)).astype(np.float32) * 0.5
    dup = np.arange(7, nr, 7)
    r[dup] = r[dup // 2]
    q = rng.integers(-12, 13, size=(nq, 3)).astype(np.float32) * 0.25
    q[:min(nq, 10)] = r[rng.integers(0, nr, size=min(nq, 10))]
    ties = tie_rows(nr, boundaries)
    if len(ties) + 10 > nq:
        raise ValueError(f"{nq} queries cannot hold {len(ties)} boundary ties")
    for i, b in enumerate(ties):
        c = np.float32(100.0 + 10.0 * i)
        r[b - 1] = (c + 1.0, c, c)
        r[b] = (c - 1.0, c, c)
        q[nq - len(ties) + i] = (c, c, c)
    return q, r


def k7_tie_bounds(nr: int, splits: int) -> list[int]:
    """The rows K7's tie checks place ties at when the refs run in
    ``splits`` ranges: across the first group boundary, inside the third
    group, across the first two range boundaries and at the last row."""
    from pcr_tpu_torch.ops.kernels import nn_kernels as nk

    per_split = nk.nn1_split_rows(nr, splits)
    return [nk.NN1_GROUP, 2 * nk.NN1_GROUP + 3, per_split, 2 * per_split, nr - 1]


def tie_rows(nr: int, boundaries) -> list[int]:
    """The boundary rows ``k7_tie_inputs`` places a tie at: distinct, sorted,
    1 <= b < nr, no two adjacent (each tie owns rows b - 1 and b)."""
    out: list[int] = []
    for b in sorted(set(int(b) for b in boundaries)):
        if 1 <= b < nr and (not out or b > out[-1] + 1):
            out.append(b)
    return out


def phase_k7(dev, clouds, gt) -> dict:
    """K7 at the shapes the exact paths give it on the first pair: the
    finest-scale brute GICP (pyramid capacity squared), the gate's
    32768-row clouds, and an odd 1000 x 3001 cut of them.  The JSON record
    keeps the finest GICP shape's times."""
    import torch

    from pcr_tpu_torch.models import multiscale
    from pcr_tpu_torch.utils import cloud, se3
    from pcr_tpu_torch.utils.cloud import PAD_COORD

    scales = multiscale.create_scales(5)
    caps = cloud.plan_scale_caps(clouds, scales)
    T = torch.as_tensor(gt[0], dtype=torch.float32, device=dev)

    def qr(src, tgt):
        q = se3.transform_points(T, src.points).contiguous()
        return q, torch.where(tgt.mask[:, None], tgt.points, PAD_COORD).contiguous()

    fine = (multiscale.build_pyramid(clouds[1], 5, caps)[-1],
            multiscale.build_pyramid(clouds[0], 5, caps)[-1])
    gicp_rec = check_k7("finest brute GICP", *qr(*fine))
    q, r = qr(clouds[1], clouds[0])
    gate_rec = check_k7("gate", q, r)
    odd_rec = check_k7("odd shape", q[:1000].contiguous(), r[:3001].contiguous(), library=False)
    for nq, nr in K7_TIE_SHAPES:
        check_k7_ties(dev, nq, nr)
    return record("nn1", "pcr_tpu_torch/csrc/nn1.cu", "pcr_tpu/ops/pallas/nn_kernels.py:192",
                  [gicp_rec, gate_rec, odd_rec], gicp_rec)


# K7's tie cases: fewer refs than a group, both counts off every multiple,
# the finest GICP's shape
K7_TIE_SHAPES = ((37, 5), (1000, 3001), (4099, 21504), (21504, 21504))


def check_k7_ties(dev, nq: int, nr: int) -> None:
    """K7 on ``k7_tie_inputs`` (duplicated refs, lattice ties, equal nearest
    refs straddling a group boundary, a boundary of the ref ranges the
    wrapper splits into, and the last row): d2 bit-equal and rows equal to
    the plain version, each boundary tie at its first row."""
    import torch

    from pcr_tpu_torch.ops.kernels import nn_kernels as nk

    splits = nk.nn1_splits(nq, nr, nk.nn1_slots(0))
    bounds = k7_tie_bounds(nr, splits)
    q, r = (torch.as_tensor(x, device=dev) for x in k7_tie_inputs(nq, nr, bounds))
    d_k, i_k = nk.nn1(q, r)
    d_p, i_p = nk.nn1_reference(q, r)
    ties = tie_rows(nr, bounds)
    if not (torch.equal(d_k, d_p) and torch.equal(i_k, i_p)
            and i_k[nq - len(ties):].tolist() == [b - 1 for b in ties]):
        raise AssertionError(f"K7 ties {nq} x {nr}: d2 differs at {int((d_k != d_p).sum())}, "
                             f"rows at {int((i_k != i_p).sum())} queries")
    print(f"K7 nn1 ties {nq} q x {nr} refs ({splits} ref splits of "
          f"{nk.nn1_split_rows(nr, splits)} rows): d2 "
          f"bit-equal, rows equal, boundary ties at rows {ties} resolved to the first")


def phase_brute(clouds, gt, init):
    """Exact-correspondence M-GICP over the circuit: per pair, the pyramids
    of stage 2 and registration_gicp(corr_method="brute") and (the hash
    grid) corr_method="grid" warm-started over the 5 scales from the real
    NCLT FGR errors, each held to ground truth, brute to the band GICP and
    grid to brute on the same pyramids; then the gate's exact evaluation
    beside the band one, and the ms of one Gauss-Newton iteration of each
    method at pair 0's finest scale.  Returns the launch counts of the
    run."""
    import torch

    from pcr_tpu_torch.models import evaluate, gicp, multiscale
    from pcr_tpu_torch.pipeline import circuit_pairs
    from pcr_tpu_torch.utils import cloud

    cfg = stage2_config("unused")
    scales = multiscale.create_scales(cfg.mgicp_scales)
    dists = multiscale.max_correspondence_distances(scales)
    caps = cloud.plan_scale_caps(clouds, scales)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pyrs = [multiscale.build_pyramid(c, cfg.mgicp_scales, caps) for c in clouds]
    worst = {m: [0.0, 0.0, 0.0, 0.0] for m in ("brute", "grid")}

    def nn1_scales(k, s, t, method="brute"):
        T, its = init[k].astype(np.float32), []
        for i, dist in enumerate(dists):
            res = gicp.registration_gicp(pyrs[s][i], pyrs[t][i], dist, T, corr_method=method,
                                         max_iteration=cfg.mgicp_iterations)
            T = res.transformation
            its.append(int(res.iterations))
        return T.double().cpu().numpy(), its

    def held(name, k, T, ref, ref_name):
        e_t, e_r = pose_error(T, gt[k])
        d_t, d_r = pose_error(T, ref)
        if not (e_t < MAX_T_ERR_M and e_r < MAX_R_ERR_DEG):
            raise AssertionError(f"{name} pair {k} off ground truth: {e_t} m, {e_r} deg")
        if not (d_t < MAX_BRUTE_BAND_T_M and d_r < MAX_BRUTE_BAND_R_DEG):
            raise AssertionError(f"{name} pair {k} off the {ref_name} result: {d_t} m, {d_r} deg")
        worst[name] = [max(a, b) for a, b in zip(worst[name], (e_t, e_r, d_t, d_r))]
        return (f"{e_t * 100:.3f} cm {e_r:.4f} deg from ground truth, {d_t * 1000:.3f} mm "
                f"{d_r:.4f} deg from {ref_name}")

    for k, (s, t) in enumerate(circuit_pairs(N_SCANS)):
        brute, its = nn1_scales(k, s, t)
        grid, its_g = nn1_scales(k, s, t, "grid")
        band = multiscale.multiscale_gicp_pyramids(
            pyrs[s], pyrs[t], init[k].astype(np.float32)).transformation.double().cpu().numpy()
        gate = [evaluate.evaluate_registration(clouds[s], clouds[t], 2 * cfg.voxel_size, brute,
                                               method=m) for m in ("exact", "band")]
        print(f"brute pair ({s},{t}): "
              f"{held('brute', k, brute, band, 'band')}"
              f"; iterations/scale {its}; gate exact n_corr {float(gate[0][2]):.0f} fitness "
              f"{float(gate[0][0]):.6f}, band n_corr {float(gate[1][2]):.0f} fitness "
              f"{float(gate[1][0]):.6f}")
        print(f"grid pair ({s},{t}): "
              f"{held('grid', k, grid, brute, 'brute')}"
              f"; iterations/scale {its_g} (brute {its})")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    for name, ref in (("brute", "band"), ("grid", "brute")):
        w = worst[name]
        print(f"{name} GICP: worst {w[0] * 100:.3f} cm {w[1]:.4f} deg from ground truth "
              f"(limits {MAX_T_ERR_M * 100:g} cm, {MAX_R_ERR_DEG} deg), {w[2] * 1000:.3f} mm "
              f"{w[3]:.4f} deg from {ref} (limits {MAX_BRUTE_BAND_T_M * 1000:g} mm, "
              f"{MAX_BRUTE_BAND_R_DEG} deg)")
    print(f"brute and grid GICP: {wall:.3f} s for {N_SCANS} pairs (pyramids, brute, grid and "
          f"band GICP, both gate evaluations); launches {launches}")
    check_launched(launches, BRUTE_KERNELS, "the brute GICP")
    gn_iteration_ms(pyrs[1][-1], pyrs[0][-1], dists[-1], gt[0])
    # K7's d2 and rows are bit-equal to its plain version's, so the brute
    # GICP on the plain version lands on the same poses, bit for bit
    from pcr_tpu_torch.ops.kernels import nn_kernels as nk

    kernel = nk.nn1
    nk.nn1 = nk.nn1_reference
    try:
        plain = nn1_scales(0, *circuit_pairs(N_SCANS)[0])[0]
    finally:
        nk.nn1 = kernel
    first = nn1_scales(0, *circuit_pairs(N_SCANS)[0])[0]
    if not np.array_equal(plain, first):
        raise AssertionError(f"brute pair 0 on K7's plain version moved by "
                             f"{float(np.abs(plain - first).max())}")
    print("brute pair 0 on K7's plain version: the same pose, bit for bit")
    return launches


GN_TIMED_ITERATIONS = 10


def gn_iteration_ms(src, tgt, max_dist: float, T) -> None:
    """Milliseconds of one Gauss-Newton iteration of the grid, band (K1) and
    brute (K7) GICP on one pair's finest scale: registration_gicp with the
    convergence test off (0 thresholds: every call runs its whole budget),
    at 1 + GN_TIMED_ITERATIONS iterations less at 1, over
    GN_TIMED_ITERATIONS (CUDA events, median of 5).  The per-iteration host
    read of the convergence flag is part of the loop and is counted."""
    from pcr_tpu_torch.models import gicp

    def run(method, iterations):
        return lambda: gicp.registration_gicp(src, tgt, max_dist, T, corr_method=method,
                                              max_iteration=iterations, relative_fitness=0.0,
                                              relative_rmse=0.0)

    ms = {}
    for method in ("grid", "band", "brute"):
        ms[method] = (cuda_ms(run(method, 1 + GN_TIMED_ITERATIONS), 5)
                      - cuda_ms(run(method, 1), 5)) / GN_TIMED_ITERATIONS
    print(f"GICP ms a Gauss-Newton iteration at the finest scale ({src.capacity} x "
          f"{tgt.capacity} rows, {int(src.mask.sum())} x {int(tgt.mask.sum())} valid, "
          f"max_dist {max_dist:g} m): grid {ms['grid']:.4f}, band (K1) {ms['band']:.4f}, "
          f"brute (K7) {ms['brute']:.4f}")


def phase_stage1_selection(clouds, gt) -> None:
    """Stage 1 over the circuit on the selection features (one exact k=200
    selection per scan, gathered normals and FPFH); every pair within
    0.5 m / 5 deg."""
    from pcr_tpu_torch import pipeline

    with tempfile.TemporaryDirectory() as tmp:
        def one(run):
            cfg = dataclasses.replace(stage1_config(str(Path(tmp) / run)),
                                      stage1_features="selection")
            metrics = pipeline.PairMetrics()
            out = pipeline.run_stage1_fgr(cfg, clouds=clouds, n=N_SCANS, metrics=metrics)
            return cfg, metrics, out

        (cfg, metrics, out), _, _ = timed_runs("stage 1 (selection)", ("one",), one)
        check_pose_files(Path(cfg.out_dir("relative_poses_FGR")), out)
    worst = 0.0, 0.0
    for k, row in enumerate(metrics.rows):
        e_t, e_r = pose_error(out[k], gt[k])
        worst = max(worst[0], e_t), max(worst[1], e_r)
        print(f"selection FGR pair ({row['src']},{row['tgt']}): {e_t * 100:.2f} cm "
              f"{e_r:.3f} deg; fitness {row['fitness']:.4f}")
        if not (e_t < MAX_FGR_T_ERR_M and e_r < MAX_FGR_R_ERR_DEG):
            raise AssertionError(f"selection FGR pair {k} off ground truth: {e_t} m, {e_r} deg")
    print(f"stage 1 (selection): worst pair error {worst[0] * 100:.2f} cm, {worst[1]:.3f} deg "
          f"(limits {MAX_FGR_T_ERR_M * 100:g} cm, {MAX_FGR_R_ERR_DEG} deg)")


def phase_retry(clouds, gt, init, base: np.ndarray) -> None:
    """Stage 2 with the reference's retry ladder on, pair RETRY_PAIR thrown
    RETRY_OFFSET_M off: that pair must be retried and land within 3 cm /
    0.2 deg; the other pairs must be the poses of the unthrown run."""
    seeded = thrown_off(init, RETRY_PAIR, RETRY_OFFSET_M)
    out, metrics, _, _ = run_stage2(clouds, gt, seeded, "retry ladder", ("one",),
                                    retry_failed=True)
    status = metrics.rows[RETRY_PAIR]["status"]
    if not status.startswith("retried"):
        raise AssertionError(f"pair {RETRY_PAIR} was not rescued by the ladder: {status}")
    others = [k for k in range(N_SCANS) if k != RETRY_PAIR]
    moved = float(np.abs(out[others] - base[others]).max())
    if moved > 1e-4:
        raise AssertionError(f"the ladder moved the other pairs by {moved}")
    print(f"retry ladder: pair {RETRY_PAIR} thrown {RETRY_OFFSET_M:g} m off -> {status}; "
          f"other pairs within {moved:.3e} of the unthrown run")


def phase_batched(clouds, gt, init, rel1, rel2, wall1: float, wall2: float):
    """The staged runners' batched branches at the default batch_size=2,
    cold and warm: stage 1 (chunks of 2 pairs, one GNC over each chunk)
    within 0.5 m / 5 deg and K1, K4-K6 launched; stage 2 from the real NCLT
    FGR errors (the streamed branch, ladder on) within 3 cm / 0.2 deg and
    K1-K3 launched.  Prints both warm walls beside the streamed ones (stage 1
    and phase 4's stage 2) and the largest pose difference from them.
    Returns the launch counts of both warm runs and their poses and walls."""
    out1, launches1, b1 = phase_stage1(clouds, gt, batch_size=2, label="stage 1 (batch 2)")
    out2, _, launches2, b2 = run_stage2(clouds, gt, init, "stage 2 (batch 2)",
                                        ("cold", "warm"), retry_failed=True, batch_size=2)
    print(f"batched runners (batch_size 2): stage 1 warm {b1:.3f} s (streamed {wall1:.3f} s), "
          f"poses within {float(np.abs(out1 - rel1).max()):.3e} of the streamed; stage 2 warm "
          f"{b2:.3f} s (streamed {wall2:.3f} s), poses within "
          f"{float(np.abs(out2 - rel2).max()):.3e} of the streamed")
    return launches1, launches2, dict(rel1=out1, rel2=out2, wall1=b1, wall2=b2)


STAGE3_METHODS = ("LUM", "SLERP", "SLERP_LUM", "pose_graph")
MAX_STAGE3_ATE_M = 0.05       # aligned ATE of each stage-3 trajectory against ground truth
MAX_PG_CARD_CPU = 1e-4        # the card's 8-node pose graph against the same graph on the CPU
MAX_CLOSED_FORM_FILE = 1e-6   # closed forms against outputs/NCLT_poses.npz
MAIN_KERNELS = STAGE2_KERNELS + ("moments", "spfh", "fpfh", "nn1_mutual", "gnc") + LM_KERNELS


def synced(fn):
    """(fn(), seconds) with the card drained before and after."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_stage3(clouds, gt, rel2) -> dict:
    """Stage 3 (all four methods) on the circuit's stage-2 poses, the
    information matrices by K1 on the card: each trajectory within
    MAX_STAGE3_ATE_M of ground truth (aligned ATE, each against the ground
    truth chained in its own convention), the pose graph's closure below the
    standard chain's, and the card's pose graph against the same graph
    solved on the CPU.  Runs cold and warm; prints each method's seconds.
    Returns the warm run's launch counts and wall seconds."""
    from pcr_tpu_torch import pipeline
    from pcr_tpu_torch.models import evaluate
    from pcr_tpu_torch.models.global_refine import closed_form, pose_graph
    from pcr_tpu_torch.ops.kernels import graph_kernels as gk
    from pcr_tpu_torch.ops.kernels import loop_kernels as lk
    from pcr_tpu_torch.utils import se3

    with tempfile.TemporaryDirectory() as tmp:
        def one(run):
            cfg = stage2_config(str(Path(tmp) / run))
            with watching(lk, "block_thomas",
                          keep=("block_thomas", f"{N_SCANS}-node circuit, m = {N_SCANS - 1}")), \
                    watching(gk, "edge_blocks", keep=("edge_blocks", f"{N_SCANS}-node circuit")):
                results = pipeline.run_stage3_global(cfg, relative_poses=rel2, clouds=clouds,
                                                     n=N_SCANS, methods=STAGE3_METHODS)
            with open(Path(cfg.out_dir("metrics")) / "stage3_consistency.json") as fh:
                return cfg, results, json.load(fh)

        (cfg, results, record), launches, wall = timed_runs("stage 3", ("cold", "warm"), one)
    check_launched(launches, ("nn1_band", "block_thomas"), "stage 3")
    check_lm_launches(launches, "stage 3")
    print(f"stage 3: the four methods over {N_SCANS} scans; pose graph "
          f"{record['pose_graph']['optimizer']}")
    split = {name: synced(lambda f=f: f(rel2))[1] for name, f in (
        ("LUM", closed_form.refine_lum), ("SLERP", closed_form.refine_slerp),
        ("SLERP_LUM", closed_form.refine_slerp_lum))}
    infos, split["information matrices"] = synced(
        lambda: pipeline.information_matrices(cfg, clouds, rel2))
    graph = pose_graph.build_circuit_graph(se3.relative_to_absolute_standard(rel2), rel2,
                                           infos, device=infos.device)
    out, split["pose-graph LM"] = synced(lambda: pose_graph.global_optimization(
        graph, max_correspondence_distance=2 * cfg.voxel_size))
    print("stage-3 split: " + "; ".join(f"{k} {v * 1e3:.1f} ms" for k, v in split.items()))
    cpu = pose_graph.global_optimization(
        pose_graph.PoseGraph(*(x.cpu() for x in graph)),
        max_correspondence_distance=2 * cfg.voxel_size)
    d_cpu = float((out.nodes.cpu() - cpu.nodes).abs().max())
    if not d_cpu < MAX_PG_CARD_CPU:
        raise AssertionError(f"stage-3 pose graph on the card is {d_cpu} off the CPU's")
    truth = {"reference": se3.relative_to_absolute(gt),
             "standard": se3.relative_to_absolute_standard(gt)}
    for name, poses in results.items():
        conv = record[name]["convention"]
        ate = evaluate.aligned_ate(poses, truth[conv])
        print(f"stage 3 {name} ({conv}): aligned ATE rmse {ate['rmse_m'] * 100:.3f} cm, max "
              f"{ate['max_m'] * 100:.3f} cm; closure edge {record[name]['dt_closure_edge_m'] * 1e3:.3f}"
              f" mm, dR max {record[name]['dR_max']:.6f}")
        if not (np.isfinite(poses).all() and poses.shape == (N_SCANS, 4, 4)
                and ate["max_m"] < MAX_STAGE3_ATE_M):
            raise AssertionError(f"stage 3 {name} off ground truth: {ate}")
    if not (record["pose_graph"]["dt_closure_edge_m"]
            < record["raw_chain_standard"]["dt_closure_edge_m"]):
        raise AssertionError("the pose graph did not distribute the circuit's closure")
    print(f"stage 3: pose graph on the card within {d_cpu:.2e} of the CPU's (limit "
          f"{MAX_PG_CARD_CPU:g})")
    return launches, wall


def phase_stage3_nclt(dev) -> None:
    """Stage 3 on the 901-pose NCLT circuit of outputs/NCLT_poses.npz: the
    closed forms on the host, held to the file's trajectories; the pose
    graph on the card with identity information matrices, timed, with its
    iterations, ms an iteration and the share of one block-Thomas solve
    pair (timed alone at the same shape), K9 launched twice an LM
    iteration; then the circuit with the information of
    tests/test_torch_pose_graph.py::test_global_optimization_at_n901_matches
    through K9 and on the plain Thomas loops, held at that test's bounds."""
    import torch

    from pcr_tpu_torch.models import evaluate
    from pcr_tpu_torch.models.global_refine import closed_form, pose_graph
    from pcr_tpu_torch.ops.kernels import graph_kernels as gk
    from pcr_tpu_torch.ops.kernels import loop_kernels as lk
    from pcr_tpu_torch.utils import se3

    z = np.load(ROOT / "outputs" / "NCLT_poses.npz")
    rel = z["relative_FGR_GICP"]
    n = len(rel)
    for name, key in (("refine_lum", "absolute_LUM"), ("refine_slerp", "absolute_SLERP"),
                      ("refine_slerp_lum", "absolute_SLERP_LUM")):
        t0 = time.perf_counter()
        poses = getattr(closed_form, name)(rel)
        sec = time.perf_counter() - t0
        err = float(np.abs(poses - z[key]).max())
        print(f"NCLT {name}: {sec * 1e3:.1f} ms on the host, {err:.2e} from {key}")
        if not err < MAX_CLOSED_FORM_FILE:
            raise AssertionError(f"NCLT {name} is {err} off the file's {key}")
    graph = nclt_graph(rel, dev, np.eye(6, dtype=np.float32))
    reset_launches()
    with watching(lk, "block_thomas", keep=("block_thomas", f"NCLT circuit, m = {n - 1}")), \
            watching(gk, "edge_blocks", keep=("edge_blocks", f"NCLT circuit, n = {n}")):
        (out, info), wall = synced(lambda: pose_graph.global_optimization(
            graph, max_correspondence_distance=0.2, return_info=True))
    launches = read_launches()
    its = info["pass1_iterations"] + info["pass2_iterations"]
    check_lm_launches(launches, "NCLT pose graph")
    if launches["edge_blocks"] != its:
        raise AssertionError(f"NCLT pose graph: K12 launched {launches['edge_blocks']} times "
                             f"in {its} LM iterations")
    l = torch.ones(n, device=dev)
    diag, off, b = pose_graph._build_tridiag(graph, graph.nodes, l)
    D, U, rhs = diag[1:], off[1 : n - 1], b[1:]
    thomas = statistics.median(
        synced(lambda: pose_graph._block_thomas_solve(D, U, rhs))[1] for _ in range(5))
    thomas_plain = statistics.median(
        synced(lambda: lk.block_thomas_reference(D, U, rhs))[1] for _ in range(3))
    plan = gk.assembly_plan(n, graph.edge_src, graph.edge_dst)
    blocks = statistics.median(
        synced(lambda: pose_graph._build_tridiag(graph, graph.nodes, l, plan=plan))[1]
        for _ in range(5))
    with plain_loops():
        blocks_plain = statistics.median(
            synced(lambda: pose_graph._build_tridiag(graph, graph.nodes, l, plan=plan))[1]
            for _ in range(3))
    ms_it = wall / its * 1e3
    print(f"NCLT pose graph (n={n}, identity information, card): {wall:.3f} s, iterations "
          f"{info['pass1_iterations']} + {info['pass2_iterations']}, {ms_it:.1f} ms/iteration, "
          f"K9 launches {launches['block_thomas']}, K12 launches {launches['edge_blocks']} + "
          f"{launches['edge_assembly']}; one block-Thomas solve "
          f"{thomas * 1e3:.2f} ms (two an iteration: {2 * thomas * 1e3 / ms_it:.0%} of it; "
          f"the plain loops {thomas_plain * 1e3:.1f} ms), Hessian blocks and bands (K12) "
          f"{blocks * 1e3:.2f} ms ({blocks * 1e3 / ms_it:.0%} of an iteration; the plain "
          f"jvp blocks and index_add_ {blocks_plain * 1e3:.1f} ms); {info}")
    c = evaluate.circuit_edge_consistency(out.nodes.double().cpu().numpy(), rel,
                                          convention="standard")
    # both passes stop at the 100-iteration cap on this graph, at costs that
    # float32 rounding decides (tools/pose_graph_rounding.py): K9 is held to
    # the plain loops on the test's own graph, which converges
    pose_graph_pair("test_global_optimization_at_n901_matches's information", nclt_graph(
        rel, dev, np.diag([2e6, 2e6, 2e6, 2e4, 2e4, 2e4]).astype(np.float32)), rel)
    raw = evaluate.circuit_edge_consistency(se3.relative_to_absolute_standard(rel), rel,
                                            convention="standard")
    print(f"NCLT pose graph: closure edge {raw['dt_closure_edge_m']:.3f} -> "
          f"{c['dt_closure_edge_m']:.4f} m, dt max {c['dt_max_m']:.4f} m, dR max "
          f"{c['dR_max']:.5f}")
    if not (torch.isfinite(out.nodes).all() and info["pruned_edges"] == 0
            and c["dt_closure_edge_m"] < raw["dt_closure_edge_m"] / 10):
        raise AssertionError(f"NCLT pose graph did not close the circuit: {info}, {c}")


def nclt_graph(rel, dev, info):
    """The NCLT circuit graph: nodes on the standard chain of ``rel``, every
    edge carrying the information matrix ``info``."""
    from pcr_tpu_torch.models.global_refine import pose_graph
    from pcr_tpu_torch.utils import se3

    return pose_graph.build_circuit_graph(se3.relative_to_absolute_standard(rel), rel,
                                          np.tile(info, (len(rel), 1, 1)), device=dev)


def pose_graph_pair(label: str, graph, rel) -> None:
    """The n=901 pose graph through K9 and K12 against the same on the plain
    loops (the jvp blocks, index_add_ and the Thomas loops), both on the
    card, at test_global_optimization_at_n901_matches's bounds (its
    docstring: a step solves a system of condition ~n^2 in float32): the
    same pruning and re-seeding, mu within 1e-6, the same edge
    mask, final costs within 1% and the consistency summaries within 1e-4
    relative plus 1e-4."""
    import torch

    from pcr_tpu_torch.models import evaluate
    from pcr_tpu_torch.models.global_refine import pose_graph

    def one(plain: bool):
        (out, info), wall = synced(lambda: pose_graph.global_optimization(
            graph, max_correspondence_distance=0.2, return_info=True))
        c = evaluate.circuit_edge_consistency(out.nodes.double().cpu().numpy(), rel,
                                              convention="standard")
        print(f"NCLT pose graph ({label}) "
              f"{'on the plain loops' if plain else 'through K9 and K12'}: "
              f"{wall:.3f} s, iterations {info['pass1_iterations']} + "
              f"{info['pass2_iterations']}; {info}")
        return out, info, c

    out, info, c = one(plain=False)
    with plain_loops():
        out_p, info_p, c_p = one(plain=True)
    for key in ("pruned_edges", "reseeded_from_chain"):
        if info[key] != info_p[key]:
            raise AssertionError(f"NCLT pose graph: {key} {info[key]} against {info_p[key]}")
    held = [("mu", 1e-6), ("pass1_final_cost", 1e-2), ("pass2_final_cost", 1e-2)]
    bad = [key for key, rtol in held if not abs(info[key] - info_p[key]) <= rtol * abs(info_p[key])]
    bad += [key for key, value in c_p.items() if isinstance(value, float)
            and not abs(c[key] - value) <= 1e-4 * abs(value) + 1e-4]
    if not info["pass1_line_process_min"] > 0.25:
        bad.append("pass1_line_process_min")
    if not torch.equal(out.edge_mask, out_p.edge_mask):
        bad.append("edge_mask")
    print(f"NCLT pose graph ({label}), K9 and K12 against the plain loops: final costs "
          f"{info['pass1_final_cost']:.6g} / {info_p['pass1_final_cost']:.6g} and "
          f"{info['pass2_final_cost']:.6g} / {info_p['pass2_final_cost']:.6g}, pruned "
          f"{info['pruned_edges']} / {info_p['pruned_edges']}; consistency "
          + ", ".join(f"{k} {c[k]:.6g} / {v:.6g}" for k, v in c_p.items()
                      if isinstance(v, float)))
    if bad:
        raise AssertionError(f"NCLT pose graph ({label}) through K9 and K12 differs from the "
                             f"plain loops: {bad}")


def phase_full(clouds, rel1, rel2, staged_s: float):
    """pipeline.run_full (stages 1 -> 3 in one window, the main path) on the
    default PipelineConfig (batch_size 2, retry ladder on): its stage-1 and
    stage-2 poses equal the staged runners', its stage-3 poses are finite,
    and K1-K6 are each launched.  Prints its wall beside the staged runners'
    sum.  Returns the run's (launch counts, result, wall seconds)."""
    from pcr_tpu_torch import pipeline

    with tempfile.TemporaryDirectory() as tmp:
        cfg = pipeline.PipelineConfig(dataset="NCLT", output_root=tmp)
        metrics = pipeline.PairMetrics()
        reset_launches()
        out, wall = synced(lambda: pipeline.run_full(cfg, clouds=clouds, n=N_SCANS,
                                                     metrics=metrics, methods=STAGE3_METHODS))
        launches = read_launches()
        check_pose_files(Path(cfg.out_dir("relative_poses_FGR")), out["stage1"])
        check_pose_files(Path(cfg.out_dir("relative_poses_FGR_GICP")), out["stage2"])
    d1 = float(np.abs(out["stage1"] - rel1).max())
    d2 = float(np.abs(out["stage2"] - rel2).max())
    gates = [r["gate_fitness"] for r in metrics.rows if r["stage"] == "mgicp"]
    print(f"run_full: {wall:.3f} s for {N_SCANS} pairs, stages 1 -> 3 (staged runners' sum "
          f"{staged_s:.3f} s); stage 1 within {d1:.2e} and stage 2 within {d2:.2e} of the "
          f"staged runners; gate fitness {[round(g, 4) for g in gates]}; launches {launches}")
    if not (d1 < 1e-5 and d2 < 1e-5 and len(gates) == N_SCANS):
        raise AssertionError(f"run_full differs from the staged runners: {d1}, {d2}")
    for name, poses in out["stage3"].items():
        if not (np.isfinite(poses).all() and poses.shape == (N_SCANS, 4, 4)):
            raise AssertionError(f"run_full stage 3 {name} is not finite")
    check_launched(launches, MAIN_KERNELS, "run_full")
    check_matching_launches(launches, "run_full", exact=False)
    check_lm_launches(launches, "run_full")
    return launches, out, wall


MAX_ENTRY_DIFF = 1e-6     # the CLI's and LazyClouds' poses against run_full's on the same points
DATA_PLANE_SCANS = 901    # NCLT's circuit


def write_scans(root: Path, scans) -> Path:
    """The scans as binary PCD files s{i}.pcd in the NCLT layout under
    ``root``; returns their directory."""
    from pcr_tpu_torch.utils import pcd

    d = root / "nuvens" / "nuvens_pre_processadas" / "NCLT"
    d.mkdir(parents=True)
    for i, s in enumerate(scans):
        pcd.write_pcd(str(d / f"s{i}.pcd"), s)
    return d


@contextlib.contextmanager
def reference_root(path: Path):
    """The port's reference root pointed at ``path`` for the block."""
    from pcr_tpu_torch.utils import poses_io

    saved = poses_io.REFERENCE_ROOT
    poses_io.REFERENCE_ROOT = str(path)
    try:
        yield
    finally:
        poses_io.REFERENCE_ROOT = saved


def run_cli(argv) -> dict:
    """pcr_tpu_torch.__main__.main(argv) in this process; its JSON summary."""
    from pcr_tpu_torch import __main__ as cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    if rc != 0:
        raise AssertionError(f"python -m pcr_tpu_torch {' '.join(argv)} returned {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def same_clouds(a, b) -> bool:
    """The clouds' points and masks equal, tensor for tensor."""
    import torch

    return len(a) == len(b) and all(torch.equal(getattr(x, k), getattr(y, k))
                                    for x, y in zip(a, b) for k in ("points", "mask"))


def phase_entry_points(clouds, scans, gt, full_out, full_wall: float) -> tuple[dict, dict]:
    """The entry points a user calls, on the circuit's scans written as PCD
    files (see phase 18 in the module docstring).  Returns the launch counts
    of the CLI's ``full`` run and of gicp_loss_log, and the ``pair`` result."""
    import torch

    from pcr_tpu_torch import native, pipeline
    from pcr_tpu_torch.models import evaluate, gicp, multiscale
    from pcr_tpu_torch.utils import cloud, poses_io, se3

    if not native.available():
        raise AssertionError("the native PCD reader did not build")
    print(f"native PCD reader: {native.library_path()}")
    with tempfile.TemporaryDirectory() as tmp, reference_root(Path(tmp) / "reference"):
        write_scans(Path(tmp) / "reference", scans)
        out_root = Path(tmp) / "out"
        reset_launches()
        kept = {}
        with keeping_k10(kept):
            summary, wall = synced(lambda: run_cli(["full", "--dataset", "NCLT", "--n",
                                                    str(N_SCANS), "--output-root",
                                                    str(out_root)]))
        launches = read_launches()
        for key, args in kept.items():
            case = (f"main path, {key[1]} rows" if key[0] == "k10"
                    else f"main path, {key[1]} queries, band {key[2]}")
            LOOP_INPUTS[("gicp" if key[0] == "k10" else key[0], case)] = args
        check_launched(launches, MAIN_KERNELS, "python -m pcr_tpu_torch full")
        check_matching_launches(launches, "python -m pcr_tpu_torch full", exact=False)
        check_lm_launches(launches, "python -m pcr_tpu_torch full")
        rel_dir = out_root / "relative_poses_FGR_GICP" / "NCLT"
        d1 = float(np.abs(poses_io.load_relative_circuit(
            str(out_root / "relative_poses_FGR" / "NCLT"), N_SCANS) - full_out["stage1"]).max())
        d2 = float(np.abs(poses_io.load_relative_circuit(str(rel_dir), N_SCANS)
                          - full_out["stage2"]).max())
        print(f"CLI full: {wall:.3f} s (loading {N_SCANS} PCD files included; phase 10's "
              f"run_full {full_wall:.3f} s); stage 1 within {d1:.3e}, stage 2 within {d2:.3e} "
              f"of phase 10 (limit {MAX_ENTRY_DIFF:g}); launches {launches}; summary "
              f"{ {k: v for k, v in summary.items() if k != 'config'} }")
        if not (d1 < MAX_ENTRY_DIFF and d2 < MAX_ENTRY_DIFF
                and summary["methods"] == sorted(STAGE3_METHODS)):
            raise AssertionError(f"the CLI's poses differ from run_full's: {d1}, {d2}")

        lazy = cloud.load_dataset_lazy("NCLT", range(N_SCANS))
        if not same_clouds([lazy[i] for i in range(N_SCANS)], clouds):
            raise AssertionError("LazyClouds' uploads differ from the in-memory clouds")
        cfg = pipeline.PipelineConfig(dataset="NCLT", output_root=str(Path(tmp) / "lazy"))
        out, wall_lazy = synced(lambda: pipeline.run_full(cfg, clouds=lazy, n=N_SCANS))
        dl = max(float(np.abs(out[k] - full_out[k]).max()) for k in ("stage1", "stage2"))
        print(f"run_full over LazyClouds: {wall_lazy:.3f} s, within {dl:.3e} of phase 10")
        if not dl < MAX_ENTRY_DIFF:
            raise AssertionError(f"run_full over LazyClouds is {dl} off the eager run")

        env = dict(os.environ, PCR_REFERENCE_ROOT=str(Path(tmp) / "reference"))
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "pcr_tpu_torch", "pair", "--dataset",
                               "NCLT", "--src", "1", "--tgt", "0", "--output-root",
                               str(Path(tmp) / "pair")], cwd=ROOT, env=env,
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"python -m pcr_tpu_torch pair failed:\n{proc.stderr[-4000:]}")
        pair = json.loads(proc.stdout.strip().splitlines()[-1])
        e_t, e_r = pose_error(np.asarray(pair["T"]), gt[0])
        print(f"python -m pcr_tpu_torch pair --src 1 --tgt 0: {e_t * 100:.3f} cm, {e_r:.4f} deg "
              f"(limits {MAX_T_ERR_M * 100:g} cm, {MAX_R_ERR_DEG} deg); its seconds "
              f"{pair['seconds']}, process {time.perf_counter() - t0:.1f} s")
        if not (e_t < MAX_T_ERR_M and e_r < MAX_R_ERR_DEG):
            raise AssertionError(f"pair (1,0) through the module entry is off: {e_t}, {e_r}")

        s3_root = Path(tmp) / "stage3"
        s3 = run_cli(["stage3", "--dataset", "NCLT", "--n", str(N_SCANS), "--relative",
                      str(rel_dir), "--output-root", str(s3_root)])
        truth = {"reference": se3.relative_to_absolute(gt),
                 "standard": se3.relative_to_absolute_standard(gt)}
        for name in s3["methods"]:
            poses = poses_io.load_absolute_poses(
                str(s3_root / f"absolute_poses_{name}" / "NCLT"), N_SCANS)
            ate = evaluate.aligned_ate(poses, truth["standard" if name == "pose_graph"
                                                    else "reference"])
            print(f"CLI stage3 {name}: aligned ATE max {ate['max_m'] * 100:.3f} cm")
            if not (np.isfinite(poses).all() and ate["max_m"] < MAX_STAGE3_ATE_M):
                raise AssertionError(f"CLI stage3 {name} off ground truth: {ate}")
        if s3["methods"] != sorted(STAGE3_METHODS):
            raise AssertionError(f"CLI stage3 ran {s3['methods']}")
        report = run_cli(["report", "--dataset", "NCLT", "--n", str(N_SCANS), "--output-root",
                          str(s3_root)])
        names = sorted(Path(p).name for p in report["artifacts"])
        if not (names == sorted(f"traj_{m}.ply" for m in STAGE3_METHODS)
                and all(Path(p).stat().st_size > 0 for p in report["artifacts"])):
            raise AssertionError(f"CLI report wrote {names}")
        print(f"CLI report: {names}")

    scales = multiscale.create_scales(5)
    caps = cloud.plan_scale_caps(clouds, scales)
    src = multiscale.build_pyramid(clouds[1], n_scales=5, scale_capacities=caps)[-1]
    tgt = multiscale.build_pyramid(clouds[0], n_scales=5, scale_capacities=caps)[-1]
    launches_log = {}
    for method in ("brute", "grid"):
        reset_launches()
        (res, log), wall_log = synced(lambda: gicp.gicp_loss_log(
            src, tgt, multiscale.max_correspondence_distances(scales)[-1], full_out["stage2"][0],
            corr_method=method))
        launches_log[method] = read_launches()
        e_t, e_r = pose_error(res.transformation.double().cpu().numpy(), gt[0])
        rmse = log["inlier_rmse"].cpu().numpy()
        print(f"gicp_loss_log ({method}{', K7' if method == 'brute' else ''}) on pair 0's "
              f"finest scale ({src.capacity} x {tgt.capacity} rows): {wall_log * 1e3:.1f} ms "
              f"for {len(rmse)} iterations, inlier rmse {rmse[0]:.5f} -> {rmse[-1]:.5f} m, "
              f"{e_t * 100:.3f} cm {e_r:.4f} deg; launches {launches_log[method]}")
        k7_ok = method != "brute" or launches_log[method]["nn1"] == len(rmse) + 1
        if not (k7_ok and np.isfinite(rmse).all() and e_t < MAX_T_ERR_M
                and e_r < MAX_R_ERR_DEG):
            raise AssertionError(f"gicp_loss_log ({method}) on the card failed its checks")
    check_band_knn(clouds[0])
    torch.cuda.synchronize()
    return launches, launches_log["brute"], pair


BAND_KNN_KS = (30, 200)
MAX_BAND_KNN_REL = 1e-6
MIN_BAND_KNN_RECALL = 0.9999


def check_band_knn(c) -> None:
    """knn(method="band") (pcr_tpu's band self-kNN, knn_exact in the port:
    ROADMAP F7) with exclude_self on one NCLT-scale scan at k = 30 and 200,
    against knn_exact on the card: every distance within MAX_BAND_KNN_REL
    relative, index recall at least MIN_BAND_KNN_RECALL, both walls."""
    import torch

    from pcr_tpu_torch.ops import knn

    m = c.mask
    for k in BAND_KNN_KS:
        (d_b, i_b), wall_b = synced(lambda: knn.knn(c.points, c.points, c.mask, k,
                                                    exclude_self=True, method="band"))
        (d_e, i_e), wall_e = synced(lambda: knn.knn_exact(c.points, c.points, c.mask, k,
                                                          exclude_self=True))
        d_b, d_e, i_b, i_e = d_b[m], d_e[m], i_b[m], i_e[m]
        rel = ((d_b - d_e).abs() / d_e.clamp(min=1e-12)).max().item()
        recall = (i_b[:, :, None] == i_e[:, None, :]).any(dim=2).float().mean().item()
        print(f"knn(method='band') k={k} exclude_self on scan 0 ({int(m.sum())} of "
              f"{c.capacity} rows valid): largest relative distance difference to knn_exact "
              f"{rel:.3e}; index recall {recall:.6f}; band {wall_b * 1e3:.1f} ms, exact "
              f"{wall_e * 1e3:.1f} ms")
        if not (bool(torch.isfinite(d_b).all()) and rel <= MAX_BAND_KNN_REL
                and recall >= MIN_BAND_KNN_RECALL):
            raise AssertionError(f"knn(method='band') k={k} differs from knn_exact: {rel} "
                                 f"relative, recall {recall}")


def phase_data_plane(scans) -> None:
    """The data plane at NCLT scale (see phase 19 in the module docstring)."""
    import torch

    from pcr_tpu_torch import native
    from pcr_tpu_torch.models import multiscale
    from pcr_tpu_torch.utils import cloud, pcd, poses_io

    n = DATA_PLANE_SCANS
    with tempfile.TemporaryDirectory() as tmp, reference_root(Path(tmp)):
        d = write_scans(Path(tmp), scans)
        for i in range(N_SCANS, n):
            os.symlink(d / f"s{i % N_SCANS}.pcd", d / f"s{i}.pcd")
        paths = [poses_io.reference_cloud_path("NCLT", i) for i in range(n)]
        t0 = time.perf_counter()
        pts, mask, _, counts = native.read_pcd_batch_padded(paths, CAPACITY, cloud.PAD_COORD)
        t_parse = time.perf_counter() - t0
        del pts, mask
        t0 = time.perf_counter()
        host = cloud.load_dataset_host("NCLT", range(n))
        t_host = time.perf_counter() - t0
        t0 = time.perf_counter()
        for i in range(N_SCANS):
            pcd.read_pcd(d / f"s{i}.pcd")
        t_py = time.perf_counter() - t0
        t0 = time.perf_counter()
        caps = cloud.plan_scale_caps(host, multiscale.create_scales(5))
        t_caps = time.perf_counter() - t0
        print(f"data plane ({n} scans, {int(counts.sum())} points): native threaded parse "
              f"{t_parse:.3f} s; load_dataset_host (parse + pin) {t_host:.3f} s, pinned "
              f"{host[0].points.is_pinned()}; Python parser {t_py:.3f} s for {N_SCANS} files "
              f"({t_py / N_SCANS * n:.1f} s at {n}); plan_scale_caps {t_caps:.3f} s -> {caps}")
        if not (host[0].points.is_pinned() and counts.tolist()
                == [len(scans[i % N_SCANS]) for i in range(n)]):
            raise AssertionError("load_dataset_host's clouds are not pinned or miscounted")
        lazy = cloud.LazyClouds(host)
        lazy_caps, t_lazy = synced(lambda: cloud.plan_scale_caps(lazy, multiscale.create_scales(5)))
        print(f"plan_scale_caps through a LazyClouds on the card: {t_lazy:.3f} s -> {lazy_caps}")
        if lazy_caps != caps or lazy._cache:
            raise AssertionError("the card's caps over a LazyClouds differ from the host's, "
                                 "or it filled the LRU")
        _, t_up = synced(lambda: [lazy[i] for i in range(n)])
        want = cloud.from_numpy(scans[(n - 1) % N_SCANS], CAPACITY)
        if not same_clouds([lazy[n - 1]], [want]):
            raise AssertionError("a LazyClouds upload differs from the in-memory cloud")
        eager, t_eager = synced(lambda: cloud.load_dataset("NCLT", range(n)))
        mib = sum(c.points.nbytes + c.mask.nbytes for c in eager) / 2**20
        print(f"LazyClouds prefix upload: {t_up / n * 1e3:.4f} ms a scan over {n}; eager "
              f"load_dataset {t_eager:.3f} s, {mib:.1f} MiB on the card")
        del eager, lazy, host
        torch.cuda.empty_cache()


MAX_MESH_STAGE1 = 1e-5    # stage 1 on a mesh: the GNC batched over a rank's block, not the chunk
MAX_MESH_STAGE2 = 1e-6    # stage 2 on a mesh: each pair runs the streamed loop's operations
MAX_MESH_PAIR = 1e-5      # run_pair on a point mesh of one rank against phase 18's pair
MAX_MESH_PG = 5e-4        # the edge-sharded pose graph against the single-device solve
MAX_MESH_2D = 5e-5        # stage 2 on a (pairs, points) mesh against the batched poses
MESH_RANK_LIMIT_S = 600   # phase 21's ranks, spawn to exit


def mesh_runners(clouds, mesh, root: str, init, label: str) -> dict:
    """run_stage1_fgr and run_stage2_mgicp (retry ladder on) with ``mesh`` at
    batch_size 2: stage 2 from ``init`` and again from the mesh's stage-1
    poses.  Returns the poses, walls and launch counts."""
    from pcr_tpu_torch import pipeline

    cfg1 = dataclasses.replace(stage1_config(f"{root}/stage1"), batch_size=2)
    reset_launches()
    rel1, wall1 = synced(lambda: pipeline.run_stage1_fgr(cfg1, clouds=clouds, n=N_SCANS,
                                                         mesh=mesh))
    launches1 = read_launches()

    def stage2(init_poses, name):
        cfg = dataclasses.replace(stage2_config(f"{root}/{name}"), retry_failed=True,
                                  batch_size=2)
        metrics = pipeline.PairMetrics()
        out = pipeline.run_stage2_mgicp(cfg, init_poses=init_poses.copy(), clouds=clouds,
                                        n=N_SCANS, mesh=mesh, metrics=metrics)
        return out, [r["status"] for r in metrics.rows]

    reset_launches()
    (rel2, status2), wall2 = synced(lambda: stage2(init, "stage2"))
    launches2 = read_launches()
    (rel12, _), wall12 = synced(lambda: stage2(rel1, "stage12"))
    print(f"{label}: stage 1 {wall1:.3f} s, stage 2 {wall2:.3f} s, stage 1 -> 2 "
          f"{wall1 + wall12:.3f} s; launches stage 1 {launches1}, stage 2 {launches2}; "
          f"stage-2 statuses {status2}", flush=True)
    return dict(rel1=rel1, rel2=rel2, rel12=rel12, wall1=wall1, wall2=wall2, wall12=wall12,
                launches1=launches1, launches2=launches2)


def circuit_graph(clouds, rel):
    """Stage 3's pose graph of the circuit (K1 information matrices), as
    run_stage3_global builds it."""
    from pcr_tpu_torch import pipeline
    from pcr_tpu_torch.models.global_refine import pose_graph
    from pcr_tpu_torch.utils import se3

    infos = pipeline.information_matrices(stage2_config(""), clouds, rel)
    return pose_graph.build_circuit_graph(se3.relative_to_absolute_standard(rel), rel, infos,
                                          device=infos.device)


def phase_mesh_one_rank(clouds, scans, init, batched: dict, pair: dict) -> dict:
    """Phase 20 (module docstring): the mesh branches in a world of one rank
    over NCCL in this process.  Returns what phase 21 is held to."""
    import torch.distributed as dist

    from pcr_tpu_torch import pipeline
    from pcr_tpu_torch.models.global_refine import pose_graph
    from pcr_tpu_torch.parallel import distributed_pg
    from pcr_tpu_torch.parallel import mesh as mesh_mod
    from pcr_tpu_torch.utils import poses_io

    mesh = mesh_mod.make_pair_mesh(1)
    print(f"mesh, one rank: {mesh}, backend {dist.get_backend()}, world "
          f"{dist.get_world_size()}")
    with tempfile.TemporaryDirectory() as tmp:
        got = mesh_runners(clouds, mesh, tmp, init, "mesh runners (pairs=1)")
        d1 = float(np.abs(got["rel1"] - batched["rel1"]).max())
        d2 = float(np.abs(got["rel2"] - batched["rel2"]).max())
        print(f"mesh runners against phase 11's batched runners: stage 1 within {d1:.3e} "
              f"(limit {MAX_MESH_STAGE1:g}; batched {batched['wall1']:.3f} s), stage 2 within "
              f"{d2:.3e} (limit {MAX_MESH_STAGE2:g}; batched {batched['wall2']:.3f} s)")
        if not (d1 < MAX_MESH_STAGE1 and d2 < MAX_MESH_STAGE2):
            raise AssertionError(f"the mesh runners differ from the batched ones: {d1}, {d2}")
        check_launched(got["launches1"], STAGE1_KERNELS, "stage 1 on a mesh")
        check_launched(got["launches2"], STAGE2_KERNELS, "stage 2 on a mesh")

        with reference_root(Path(tmp) / "reference"):
            write_scans(Path(tmp) / "reference", scans)
            cfg = pipeline.PipelineConfig(dataset="NCLT", output_root=f"{tmp}/pair")
            reset_launches()
            out, wall_pair = synced(lambda: pipeline.run_pair(
                cfg, 1, 0, point_mesh=mesh_mod.make_point_mesh(1)))
            launches_pair = read_launches()
            dp = float(np.abs(np.asarray(out["T"]) - np.asarray(pair["T"])).max())
            print(f"run_pair(point_mesh=1 rank): {wall_pair:.3f} s (phase 18's pair: "
                  f"{pair['seconds']} s in its process), within {dp:.3e} of phase 18's pair "
                  f"(limit {MAX_MESH_PAIR:g}); point_mesh {out['point_mesh']}; launches "
                  f"{launches_pair}")
            if not (dp < MAX_MESH_PAIR and out["point_mesh"] == 1):
                raise AssertionError(f"run_pair on a point mesh is {dp} off phase 18's pair")

            reset_launches()
            summary, wall_cli = synced(lambda: run_cli(
                ["full", "--dataset", "NCLT", "--n", str(N_SCANS), "--devices", "1",
                 "--batch-size", "2", "--output-root", f"{tmp}/cli"]))
            launches_cli = read_launches()
            dc = max(float(np.abs(poses_io.load_relative_circuit(
                f"{tmp}/cli/{stage}/NCLT", N_SCANS) - got[key]).max())
                for stage, key in (("relative_poses_FGR", "rel1"),
                                   ("relative_poses_FGR_GICP", "rel12")))
            print(f"CLI full --devices 1 --batch-size 2: {wall_cli:.3f} s (stages 1 -> 3, "
                  f"loading included), pose files within {dc:.3e} of the mesh runners "
                  f"(limit {MAX_ENTRY_DIFF:g}); mesh {summary['mesh']}; launches {launches_cli}")
            if not (dc < MAX_ENTRY_DIFF and summary["mesh"] == {"pairs": 1}
                    and summary["methods"] == sorted(STAGE3_METHODS)):
                raise AssertionError(f"the CLI's full --devices 1 differs: {dc}, {summary}")
            check_launched(launches_cli, MAIN_KERNELS, "CLI full --devices 1")

    graph = circuit_graph(clouds, got["rel12"])
    voxel = stage2_config("").voxel_size
    single, wall_single = synced(lambda: pose_graph.global_optimization(
        graph, max_correspondence_distance=2 * voxel))
    shared, wall_dist = synced(lambda: distributed_pg.distributed_global_optimization(
        mesh, graph, max_correspondence_distance=2 * voxel))
    dg = float((shared.nodes - single.nodes).abs().max())
    print(f"distributed_global_optimization (1 rank): {wall_dist:.3f} s, global_optimization "
          f"{wall_single:.3f} s; nodes within {dg:.3e} (limit {MAX_MESH_PG:g})")
    if not dg < MAX_MESH_PG:
        raise AssertionError(f"the distributed pose graph is {dg} off the single-device one")
    dist.destroy_process_group()
    return dict(rel1=got["rel1"], rel12=got["rel12"], wall1=got["wall1"],
                wall12=got["wall12"], pg_nodes=shared.nodes.cpu().numpy(),
                graph={k: v.cpu().numpy() for k, v in graph._asdict().items()})


def mesh_rank(rank: int, world: int, tmp: str) -> None:
    """One of phase 21's ranks: a gloo group of ``world`` on this card."""
    import pickle
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(f"{tmp}/store", world), rank=rank,
                            world_size=world, timeout=timedelta(seconds=300))
    from pcr_tpu_torch import pipeline
    from pcr_tpu_torch.models import multiscale
    from pcr_tpu_torch.models.global_refine import pose_graph
    from pcr_tpu_torch.parallel import distributed_pg, point_sharding
    from pcr_tpu_torch.parallel import mesh as mesh_mod
    from pcr_tpu_torch.utils import cloud

    with open(f"{tmp}/inputs.pkl", "rb") as fh:
        x = pickle.load(fh)
    clouds = [cloud.from_numpy(sc, CAPACITY) for sc in x["scans"]]
    pairs = mesh_mod.make_pair_mesh(world)
    got = mesh_runners(clouds, pairs, f"{tmp}/pairs", x["init"],
                       f"rank {rank}: mesh runners (pairs={world})")
    cfg = dataclasses.replace(stage2_config(f"{tmp}/points"), retry_failed=True, batch_size=2)
    reset_launches()
    mesh_2d = mesh_mod.make_2d_mesh(1, world)
    metrics = pipeline.PairMetrics()
    rel2_2d, wall_2d = synced(lambda: pipeline.run_stage2_mgicp(
        cfg, init_poses=x["init"].copy(), clouds=clouds, n=N_SCANS, mesh=mesh_2d,
        metrics=metrics))
    launches_2d = read_launches()
    # the same pairs through sharded_mgicp_2d (pyramids per pair, no retries)
    circuit = pipeline.circuit_pairs(N_SCANS)
    res_2d, wall_fn = synced(lambda: point_sharding.sharded_mgicp_2d(
        mesh_2d, cloud.stack_clouds([clouds[s] for s, _ in circuit]),
        cloud.stack_clouds([clouds[t] for _, t in circuit]), x["init"].astype(np.float32),
        n_scales=cfg.mgicp_scales, iterations=cfg.mgicp_iterations,
        scale_capacities=cloud.plan_scale_caps(clouds, multiscale.create_scales(
            cfg.mgicp_scales))))
    ok = [r["status"] == "ok" for r in metrics.rows]
    d_fn = float(np.abs(res_2d.transformation.double().cpu().numpy()[ok] - rel2_2d[ok]).max())
    graph = pose_graph.PoseGraph(*(torch.as_tensor(x["graph"][k], device=clouds[0].device)
                                   for k in pose_graph.PoseGraph._fields))
    shared, wall_pg = synced(lambda: distributed_pg.distributed_global_optimization(
        pairs, graph, max_correspondence_distance=2 * cfg.voxel_size))
    print(f"rank {rank}: stage 2 on (pairs=1, points={world}) {wall_2d:.3f} s, launches "
          f"{launches_2d}; sharded_mgicp_2d {wall_fn:.3f} s, within {d_fn:.3e} of it on its "
          f"{sum(ok)} pairs that were not retried; distributed_global_optimization "
          f"{wall_pg:.3f} s", flush=True)
    if rank == 0:
        with open(f"{tmp}/out.pkl", "wb") as fh:
            pickle.dump(dict(got, rel2_2d=rel2_2d, wall_2d=wall_2d, wall_pg=wall_pg, d_fn=d_fn,
                             pg_nodes=shared.nodes.cpu().numpy()), fh)
    dist.destroy_process_group()


def phase_mesh_two_ranks(scans, gt, init, batched: dict, one: dict) -> None:
    """Phase 21 (module docstring): two ranks sharing this card over gloo."""
    import multiprocessing as mp
    import pickle

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        with open(f"{tmp}/inputs.pkl", "wb") as fh:
            pickle.dump(dict(scans=scans, init=init, graph=one["graph"]), fh)
        t0 = time.perf_counter()
        procs = [ctx.Process(target=mesh_rank, args=(r, 2, tmp)) for r in range(2)]
        for p in procs:
            p.start()
        try:
            while any(p.is_alive() for p in procs):
                codes = [p.exitcode for p in procs]
                if any(c not in (None, 0) for c in codes):
                    raise AssertionError(f"a mesh rank failed: exit codes {codes}")
                if time.perf_counter() - t0 > MESH_RANK_LIMIT_S:
                    raise AssertionError(f"the mesh ranks overran {MESH_RANK_LIMIT_S} s")
                time.sleep(0.2)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join(30)
        codes = [p.exitcode for p in procs]
        if codes != [0, 0]:
            raise AssertionError(f"mesh ranks exit codes {codes}")
        with open(f"{tmp}/out.pkl", "rb") as fh:
            got = pickle.load(fh)
    ranks_s = time.perf_counter() - t0
    d1 = float(np.abs(got["rel1"] - one["rel1"]).max())
    d12 = float(np.abs(got["rel12"] - one["rel12"]).max())
    d2d = float(np.abs(got["rel2_2d"] - batched["rel2"]).max())
    dg = float(np.abs(got["pg_nodes"] - one["pg_nodes"]).max())
    errors = [pose_error(got["rel2_2d"][k], gt[k]) for k in range(N_SCANS)]
    worst = max(e for e, _ in errors), max(r for _, r in errors)
    print(f"mesh, two ranks on one card (gloo): the ranks' processes {ranks_s:.1f} s; stage 1 "
          f"{got['wall1']:.3f} s (1 rank {one['wall1']:.3f} s) within {d1:.3e}, stage 1 -> 2 "
          f"{got['wall1'] + got['wall12']:.3f} s (1 rank {one['wall1'] + one['wall12']:.3f} s) "
          f"within {d12:.3e} of phase 20 (limit {MAX_MESH_STAGE1:g}); stage 2 on (pairs=1, "
          f"points=2) {got['wall_2d']:.3f} s (batched {batched['wall2']:.3f} s) within "
          f"{d2d:.3e} of phase 11 (limit {MAX_MESH_2D:g}), worst pair {worst[0] * 100:.3f} cm "
          f"{worst[1]:.4f} deg; sharded_mgicp_2d within {got['d_fn']:.3e} of that stage 2 "
          f"(limit {MAX_MESH_STAGE2:g}); distributed pose graph {got['wall_pg']:.3f} s within "
          f"{dg:.3e} of phase 20 (limit {MAX_MESH_PG:g})")
    if not (d1 < MAX_MESH_STAGE1 and d12 < MAX_MESH_STAGE1 and d2d < MAX_MESH_2D
            and worst[0] < MAX_T_ERR_M and worst[1] < MAX_R_ERR_DEG and dg < MAX_MESH_PG
            and got["d_fn"] < MAX_MESH_STAGE2):
        raise AssertionError(f"two mesh ranks differ: {d1}, {d12}, {d2d}, {worst}, {dg}, "
                             f"{got['d_fn']}")


# ---------------------------------------------------------------------------
# Phase 22: the k-connectivity graph builder at Facade scale
# ---------------------------------------------------------------------------

FACADE_SCANS = 7
FACADE_CAPACITY = 90112          # pcr_tpu's Facade bucket
FACADE_POINTS = (44728, 84141)   # the real Facade scans' fewest and most valid points
FACADE_STEPS_M = (0.5, 1.5)      # neighbour to neighbour
FACADE_CALL = dict(voxel_size=0.1, k=2, n_scales=3, iterations=100)  # facade_k2_report.py
FACADE_BATCH = 2
MAX_NODE_ERR_M = 0.08            # an optimised node against ground truth (pcr_tpu's test)
# the serial builder against the batched one (pcr_tpu's own bounds)
MAX_BUILDERS_EDGE = 5e-4
MAX_BUILDERS_NODE = 5e-3
BUILDERS_INFO_RTOL, BUILDERS_INFO_ATOL = 0.05, 50.0


def make_facade_circuit(seed: int = SEED):
    """(scans as (n_i, 3) float32 arrays in their sensor frames, absolute
    poses (FACADE_SCANS, 4, 4) sensor -> world).  The path turns by up to
    8.6 deg a step, neighbours 0.5-1.5 m apart; scan k keeps about
    FACADE_POINTS spread linearly over the scans, drawn from the scene of
    ``_world`` with weight 1/r^2 (1-30 m; the weights scaled until the
    expected count is the target, points near the sensor kept with
    probability 1), with 1 cm noise."""
    rng = np.random.default_rng(seed + 22)
    steps = rng.permutation(np.linspace(*FACADE_STEPS_M, FACADE_SCANS - 1))
    yaw, p = 0.0, np.zeros(3)
    absolute = [np.eye(4)]
    for step in steps:
        yaw += rng.uniform(-0.15, 0.15)
        p = p + [step * math.cos(yaw), step * math.sin(yaw), rng.uniform(-0.05, 0.05)]
        A = np.eye(4)
        A[:3, :3], A[:3, 3] = _rot_z(yaw), p
        absolute.append(A)
    world = _world(rng, np.mean([A[:3, 3] for A in absolute], axis=0))
    scans = []
    for A, target in zip(absolute, np.linspace(*FACADE_POINTS, FACADE_SCANS)):
        r = np.linalg.norm(world - A[:3, 3], axis=1)
        w = np.where((r > 1.0) & (r < 30.0), 1.0 / np.maximum(r, 2.0) ** 2, 0.0)
        lo, hi = target / w.sum(), target / w.sum() * 1e4
        for _ in range(60):                   # bisection on log(scale)
            mid = math.sqrt(lo * hi)
            lo, hi = (mid, hi) if np.minimum(1.0, mid * w).sum() < target else (lo, mid)
        pts = world[rng.random(len(world)) < np.minimum(1.0, hi * w)]
        pts = pts + rng.normal(0.0, NOISE_M, pts.shape)
        scans.append(((pts - A[:3, 3]) @ A[:3, :3]).astype(np.float32))
    return scans, np.stack(absolute)


@contextlib.contextmanager
def ladder_seeds(seeds: list):
    """Record the tuple-test seed of every ``fgr.registro_fgr`` call while
    the block runs: the builders call it for serial attempts only, so the
    seeds say which pairs took the retry ladder."""
    from pcr_tpu_torch.models import fgr

    original = fgr.registro_fgr

    def recorded(*args, seed: int = 0, **kw):
        seeds.append(seed)
        return original(*args, seed=seed, **kw)

    fgr.registro_fgr = recorded
    try:
        yield
    finally:
        fgr.registro_fgr = original


def phase_graph_builder(dev) -> None:
    """Phase 22 (module docstring): full_registration_batched and
    full_registration over the Facade-scale circuit, global_optimization of
    the batched graph, the two graphs edge by edge."""
    import torch

    from pcr_tpu_torch.models import evaluate, fgr, graph_builder
    from pcr_tpu_torch.models.global_refine import pose_graph
    from pcr_tpu_torch.ops.kernels import graph_kernels as gk
    from pcr_tpu_torch.ops.kernels import nn_kernels as nk
    from pcr_tpu_torch.utils import cloud

    scans, absolute = make_facade_circuit()
    clouds = [cloud.from_numpy(sc, FACADE_CAPACITY, device=dev) for sc in scans]
    n = len(clouds)
    steps = [float(np.linalg.norm(absolute[k + 1, :3, 3] - absolute[k, :3, 3]))
             for k in range(n - 1)]
    print(f"graph builder: {n} scans in a {FACADE_CAPACITY} bucket, valid points "
          f"{[len(sc) for sc in scans]}, steps {[round(x, 3) for x in steps]} m; "
          f"{gpu_line()}")
    def batched(log):
        return graph_builder.full_registration_batched(clouds, log=log,
                                                       batch_size=FACADE_BATCH, **FACADE_CALL)

    def serial(log):
        return graph_builder.full_registration(clouds, log=log, **FACADE_CALL)

    # the batched builder first in this process and again after the serial
    # one, so both builders' walls are read warm
    graphs, retried = {}, {}
    for name, build in (("batched cold", batched), ("serial", serial),
                        ("batched", batched)):
        log, seeds = [], []
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        with ladder_seeds(seeds), watching(fgr, "fgr_from_correspondences",
                                           keep=("gnc", f"Facade graph builder, batch "
                                                        f"{FACADE_BATCH}")), \
                watching(nk, "nn1_mutual", keep=("nn1_mutual", "Facade graph builder")):
            graph, wall = synced(lambda: build(log.append))
        launches = read_launches()
        pairs = list(zip(graph.edge_src.tolist(), graph.edge_dst.tolist()))
        # the serial builder's ladder starts at seed + 101, the batched
        # builder's (after its batched first attempt) at the pair's seed
        first = 101 if name == "serial" else 0
        retried[name] = {(s, t) for s, t in pairs if s * n + t + first in seeds}
        graphs[name] = graph
        print(f"{name} builder: {wall:.3f} s, {len(pairs)} edges, {len(pairs) / wall:.3f} "
              f"edges/s, {len(retried[name])} retried {sorted(retried[name])}, peak "
              f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; launches {launches}")
        T = graph.edge_T.double().cpu().numpy()
        for e, (s, t) in enumerate(pairs):
            e_t, e_r = pose_error(T[e], np.linalg.inv(absolute[t]) @ absolute[s])
            print(f"  {log[e]}: {e_t * 100:.3f} cm {e_r:.4f} deg from ground truth")
            if t == s + 1 and not (e_t < MAX_T_ERR_M and e_r < MAX_R_ERR_DEG):
                raise AssertionError(f"{name} odometry edge {s}->{t} off ground truth: "
                                     f"{e_t} m, {e_r} deg")
        print(f"  {log[-1]}")
        check_launched(launches, STAGE2_KERNELS + ("gnc",), f"the {name} builder")

    truth = np.stack([np.linalg.inv(absolute[0]) @ A for A in absolute])

    def optimise():
        return pose_graph.global_optimization(
            graphs["batched"], max_correspondence_distance=0.2, edge_prune_threshold=0.25,
            return_info=True)

    reset_launches()
    with watching(gk, "edge_blocks", keep=("edge_blocks", "Facade k-graph")):
        (out, info), wall_opt = synced(optimise)
    launches = read_launches()
    check_lm_launches(launches, "global_optimization of the k-graph", circuit=False)
    if launches["edge_blocks"] != info["pass1_iterations"] + info["pass2_iterations"]:
        raise AssertionError(f"K12 launched {launches['edge_blocks']} times in {info}")
    # the same graph again: the fixed-order assembly gives the same bits (F8)
    out2, info2 = optimise()
    same = (torch.equal(out.nodes, out2.nodes) and torch.equal(out.edge_mask, out2.edge_mask)
            and info == info2)
    print(f"global_optimization run twice: {'bit for bit' if same else 'DIFFERENT'} (nodes "
          f"within {float((out.nodes - out2.nodes).abs().max()):.3e}); K12 launches "
          f"{launches['edge_blocks']} + {launches['edge_assembly']} in "
          f"{info['pass1_iterations'] + info['pass2_iterations']} LM iterations")
    if not same:
        raise AssertionError("global_optimization of the k-graph differs between two runs")
    nodes = out.nodes.double().cpu().numpy()
    errs = [pose_error(nodes[i], truth[i]) for i in range(n)]
    ate = evaluate.aligned_ate(nodes, truth)
    print(f"global_optimization of the batched graph: {wall_opt:.3f} s, {info}; node errors "
          + ", ".join(f"{e_t * 100:.3f} cm {e_r:.4f} deg" for e_t, e_r in errs)
          + f"; aligned ATE rmse {ate['rmse_m'] * 100:.3f} cm, max {ate['max_m'] * 100:.3f} cm")
    worst = max(e_t for e_t, _ in errs)
    if not worst < MAX_NODE_ERR_M:
        raise AssertionError(f"an optimised node is {worst} m off ground truth")

    ser, bat = graphs["serial"], graphs["batched"]
    if not all(torch.equal(a, b) for a, b in zip(graphs["batched cold"], bat)):
        raise AssertionError("the batched builder's two runs differ")
    skip = retried["serial"] | retried["batched"]
    keep = [e for e, st in enumerate(zip(bat.edge_src.tolist(), bat.edge_dst.tolist()))
            if st not in skip]
    dT = float((ser.edge_T - bat.edge_T)[keep].abs().max())
    I_s, I_b = ser.edge_info[keep], bat.edge_info[keep]
    info_ok = bool(torch.all((I_s - I_b).abs()
                             <= BUILDERS_INFO_ATOL + BUILDERS_INFO_RTOL * I_b.abs()))
    odometry_retried = any(t == s + 1 for s, t in skip)
    dN = None if odometry_retried else float((ser.nodes - bat.nodes).abs().max())
    print(f"serial against batched on the {len(keep)} edges neither retried: edge_T within "
          f"{dT:.3e} (limit {MAX_BUILDERS_EDGE:g}), information matrices "
          f"{'within' if info_ok else 'outside'} rtol {BUILDERS_INFO_RTOL:g} / atol "
          f"{BUILDERS_INFO_ATOL:g}, nodes "
          + ("not compared (an odometry pair was retried)" if dN is None
             else f"within {dN:.3e} (limit {MAX_BUILDERS_NODE:g})"))
    if not (torch.equal(ser.edge_src, bat.edge_src) and torch.equal(ser.edge_dst, bat.edge_dst)
            and dT <= MAX_BUILDERS_EDGE and info_ok
            and (dN is None or dN <= MAX_BUILDERS_NODE)):
        raise AssertionError(f"the serial and batched graphs differ: {dT}, {info_ok}, {dN}")


MAX_GNC_T = 1e-4          # K8's normalised poses against its plain version's
MAX_GNC_MM = 5.0          # ... and the poses they denormalise to, mm
MAX_GNC_DEG = 0.02        # ... and deg
MAX_THOMAS_RATIO = 10.0   # K9's refined relative residual against the plain solve's
MIN_THOMAS_RESIDUAL = 1e-6
GNC_ROW_OPS = 70          # FP32 operations of a kept row in a GNC step (csrc/loops.cu)
GNC_STEP_OPS = 400        # about, of a pair's 6x6 solve, exp and compose a step
PLAIN_LOOP_REPS = 2
MAX_K10_Q = 1e-4       # m: gicp_move's q_sp against transform_points (another rounding order)
MAX_K10_SUMS = 1e-4    # of the largest entry: H, g and sum d2 summed in other orders
MAX_K10_T = 1e-6       # gicp_update's T against the plain update of the same sums


def device_ops(fn) -> int:
    """Device operations (kernels, copies, fills) the profiler records while
    ``fn`` runs."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.profiler.kineto_results.events()
               if str(e.device_type()).endswith("CUDA")
               and not (hasattr(e, "is_user_annotation") and e.is_user_annotation()))


def plain_times(fn, reps: int) -> tuple[float, float]:
    """(CUDA-event ms, host-clock ms), medians of ``fn()`` over ``reps``
    runs after one: the plain loops are bound by the host's launches, so
    the two read nearly alike."""
    import torch

    fn()
    events, host = [], []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        events.append(a.elapsed_time(b))
    return statistics.median(events), statistics.median(host)


def check_k8(label: str, args):
    """K8 on a path's fgr_from_correspondences arguments against its plain
    version: the normalised poses within MAX_GNC_T (300 float32 steps from
    the same start, sums in other orders, to the same fixed point; the
    plain version's own bound against pcr_tpu), the poses they denormalise
    to within MAX_GNC_MM / MAX_GNC_DEG (that bound at scenes of up to
    50 m), two kernel runs bit for bit.  Returns (err, ms, plain ms, bound
    ms, bound by, None)."""
    import torch

    from pcr_tpu_torch.models import fgr
    from pcr_tpu_torch.ops.kernels import loop_kernels as lk

    src, tgt, ci, cj, cm, opts = args
    inp = fgr.gnc_inputs(src, tgt, ci, cj, cm, opts)
    kargs = (inp.p, inp.q, inp.w, inp.mu0, inp.delta, inp.enough, opts.iteration_number,
             opts.division_factor, opts.decrease_mu)
    T_k, T_k2 = lk.gnc(*kargs), lk.gnc(*kargs)
    T_p = lk.gnc_reference(*kargs)
    torch.cuda.synchronize()
    if not torch.equal(T_k, T_k2):
        raise AssertionError(f"K8 {label}: two runs differ by {float((T_k - T_k2).abs().max())}")
    err = float((T_k - T_p).abs().max())
    P_k, P_p = (fgr.gnc_pose(T, inp).reshape(-1, 4, 4).double().cpu().numpy()
                for T in (T_k, T_p))
    diffs = [pose_error(a, b) for a, b in zip(P_k, P_p)]
    d_mm, d_deg = max(d[0] for d in diffs) * 1e3, max(d[1] for d in diffs)
    n_pairs, n = P_k.shape[0], inp.w.shape[-1]
    kept = int((inp.w != 0).sum())
    ms = cuda_ms(lambda: lk.gnc(*kargs), 10)
    plain_ms, plain_wall = plain_times(lambda: lk.gnc_reference(*kargs), PLAIN_LOOP_REPS)
    steps = opts.iteration_number
    # every weight is read, p and q only on kept rows; delta, enough and T
    n_bytes = 4 * inp.w.numel() + 24 * kept + 4 * n_pairs + n_pairs * (1 + 64)
    lim = bound(n_bytes, steps * (GNC_ROW_OPS * kept + GNC_STEP_OPS * n_pairs))
    print(f"K8 gnc {label}: {n_pairs} pair(s) x {n} rows ({kept} kept), "
          f"{'absolute' if opts.use_absolute_scale else 'relative'} scale, {steps} steps; "
          f"normalised poses within {err:.3e} of the plain version (limit {MAX_GNC_T:g}), "
          f"poses {d_mm:.4f} mm / {d_deg:.6f} deg apart (limits {MAX_GNC_MM:g} mm, "
          f"{MAX_GNC_DEG:g} deg), two runs bit for bit; kernel {ms:.4f} ms "
          f"({ms * 1e3 / max(steps, 1):.2f} us a step), plain {plain_ms:.1f} ms (host "
          f"{plain_wall:.1f} ms), bound {lim[0]:.6f} ms ({lim[1]})")
    if not (err <= MAX_GNC_T and d_mm <= MAX_GNC_MM and d_deg <= MAX_GNC_DEG):
        raise AssertionError(f"K8 {label}: {err}, {d_mm} mm, {d_deg} deg from the plain version")
    return err, ms, plain_ms, *lim, None


def thomas_ops(m: int) -> int:
    """FP32 operations of a block-Thomas solve as csrc/loops.cu does it:
    S and r from the previous step (j > 0), the 6x13 elimination, the seven
    back substitutions, the backward sweep's 6x6 products."""
    elim = sum(1 + (5 - k) * (1 + 2 * (12 - k)) for k in range(6))
    back = 7 * sum(2 * (5 - k) + 1 for k in range(6))
    return m * (elim + back) + (m - 1) * (36 * 12 + 6 * 12 + 6 * 12)


def dense_tridiagonal(D, U):
    """The (6m, 6m) matrix of the block-tridiagonal system (D, U)."""
    import torch

    m = D.shape[0]
    A = D.new_zeros((m, 6, m, 6))
    j = torch.arange(m, device=D.device)
    A[j, :, j, :] = D
    A[j[:-1], :, j[1:], :] = U
    A[j[1:], :, j[:-1], :] = U.transpose(1, 2)
    return A.reshape(6 * m, 6 * m)


def check_k9(label: str, args, library: bool):
    """K9 on a path's block_thomas arguments against its plain version, by
    the relative residual |A x - b| / |b| (float64) of the refined solve
    (the LM's two solves, models/global_refine/pose_graph._solve_tridiag):
    within MAX_THOMAS_RATIO of the plain one's, or under MIN_THOMAS_RESIDUAL
    (16 float32 roundings).  x itself is not held: the NCLT system's
    condition is ~n^2 (pose_graph.py).  Two kernel runs bit for bit.
    Returns (residual, ms, plain ms, bound ms, bound by, library ms)."""
    import torch

    from pcr_tpu_torch.models.global_refine import pose_graph
    from pcr_tpu_torch.ops.kernels import loop_kernels as lk

    D, U, rhs = args
    m = D.shape[0]
    x_k, x_k2 = lk.block_thomas(D, U, rhs), lk.block_thomas(D, U, rhs)
    x_p = lk.block_thomas_reference(D, U, rhs)
    torch.cuda.synchronize()
    if not torch.equal(x_k, x_k2):
        raise AssertionError(f"K9 {label}: two runs differ by {float((x_k - x_k2).abs().max())}")

    def residual(solve):
        x = solve(D, U, rhs)
        x = x + solve(D, U, rhs - pose_graph._band_matvec(D, U, x))
        b = rhs.double()
        return float(torch.linalg.norm(pose_graph._band_matvec(D.double(), U.double(),
                                                               x.double()) - b)
                     / torch.linalg.norm(b))

    r_k, r_p = residual(lk.block_thomas), residual(lk.block_thomas_reference)
    dx = float((x_k - x_p).abs().max() / x_p.abs().max())
    ms = cuda_ms(lambda: lk.block_thomas(D, U, rhs), 20)
    plain_ms, plain_wall = plain_times(lambda: lk.block_thomas_reference(D, U, rhs), 3)
    lib_ms = None
    if library:
        A, b = dense_tridiagonal(D, U), rhs.reshape(-1)
        lib_ms = cuda_ms(lambda: torch.linalg.solve(A, b), 5)
    lim = bound(4 * (D.numel() + U.numel() + 2 * rhs.numel()), thomas_ops(m))
    limit = max(MAX_THOMAS_RATIO * r_p, MIN_THOMAS_RESIDUAL)
    print(f"K9 block_thomas {label}: refined relative residual {r_k:.3e}, plain {r_p:.3e} "
          f"(limit {limit:.3e}); x within {dx:.3e} of the plain x (relative, not held); two "
          f"runs bit for bit; kernel {ms:.4f} ms ({ms * 1e3 / m:.3f} us a step), plain "
          f"{plain_ms:.1f} ms (host {plain_wall:.1f} ms)"
          + (f", dense torch.linalg.solve of the (6m)^2 system {lib_ms:.3f} ms"
             if lib_ms is not None else "") + f", bound {lim[0]:.6f} ms ({lim[1]})")
    if not r_k <= limit:
        raise AssertionError(f"K9 {label}: residual {r_k} against the plain solve's {r_p}")
    return r_k, ms, plain_ms, *lim, lib_ms


# ---------------------------------------------------------------------------
# K11 (mutual 1-NN) and K12 (the pose graph's edge blocks and assembly)
# ---------------------------------------------------------------------------

UNIT_ROUNDOFF = 2.0 ** -24
# Two expanded d2 = (|a|^2 + |b|^2) - 2 a.b of nonnegative 33-dim features,
# summed in different orders, may each be off by (33 + 33 + 33 + 2) u of
# (|a|^2 + |b|^2) (the dot product's gamma_33 doubled, either norm's
# gamma_33, two roundings): a pick that differs from the plain version's is
# right to rounding when its exact d2 is within twice that of the plain
# pick's.
MUTUAL_ROUND_UNITS = 2 * 101
MUTUAL_PAIR_OPS = 2 * 33 + 5   # FP32 operations a pair: the dot, d2, two compares
# K12's blocks against the plain version's (float32 evaluations of the same
# function through other orders of operations; the poses lie up to ~1 km
# from the origin): H within this share of the edge's largest H entry; b
# within 6 |LJ|max (rho + this share of |r|max), rho = 16 roundings of the
# edge's largest translation, the residual's own float32 noise.
EDGE_BLOCK_REL = 1e-4
EDGE_RESIDUAL_ROUNDINGS = 16
# FP32 operations of an edge in csrc/pose_graph.cu, a reckoning: 12 forward
# passes of ~700 (two composes, an inverse, the logs, in dual numbers), then
# LJ (864), the three H (1296) and the two b (144).
EDGE_BLOCK_OPS = 12 * 700 + 864 + 1296 + 144


def k_graph(n: int, k: int, dev, seed: int = 0):
    """A seeded pose graph of n nodes round a loop, edges (i, i+1), ...,
    (i, i+k) (mod n) from every node i, so every node is the source of k
    edges and the target of k: the odometry edges certain, the others
    uncertain; nodes a few metres apart with 0.2 rad of rotation, edges 1 cm
    / 0.01 rad off the truth, nodes 2 cm / 0.02 rad off it; information
    matrices SPD (A A^T 100 + 1000 I)."""
    import torch

    from pcr_tpu_torch.models.global_refine import pose_graph
    from pcr_tpu_torch.utils import se3

    rng = np.random.default_rng(seed)
    xi = np.concatenate([rng.normal(0, 0.2, (n, 3)), rng.normal(0, 5.0, (n, 3))], axis=1)
    truth = se3.se3_exp(torch.as_tensor(xi, dtype=torch.float64)).numpy()
    src = np.repeat(np.arange(n), k)
    dst = (src + np.tile(np.arange(1, k + 1), n)) % n
    edge_T = np.stack([np.linalg.inv(truth[t]) @ truth[s] for s, t in zip(src, dst)])
    edge_T = se3.se3_exp(torch.as_tensor(rng.normal(0, 0.01, (len(src), 6)))).numpy() @ edge_T
    A = rng.normal(0, 1, (len(src), 6, 6))
    info = A @ A.transpose(0, 2, 1) * 100 + np.eye(6) * 1000
    nodes = truth @ se3.se3_exp(torch.as_tensor(rng.normal(0, 0.02, (n, 6)))).numpy()

    def f32(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev)

    return pose_graph.PoseGraph(
        nodes=f32(nodes), edge_src=torch.as_tensor(src, device=dev),
        edge_dst=torch.as_tensor(dst, device=dev), edge_T=f32(edge_T), edge_info=f32(info),
        uncertain=torch.as_tensor(dst != (src + 1) % n, device=dev),
        edge_mask=torch.ones(len(src), dtype=torch.bool, device=dev))


def k11_tie_inputs(na: int, nb: int, seed: int = 0):
    """(a, a_mask, b, b_mask) numpy inputs full of exact ties: features in
    {0, 1, 2} (every product, sum and norm of the expanded d2 exact in
    float32, so the kernel and the plain version compute the same d2 and
    must tie alike), a tenth of the rows all zero, rows duplicated across
    every 128-row kernel tile and 2048-row plain tile boundary, masked runs
    across those boundaries, and the last b rows masked (columns no valid
    a-row reaches)."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 3, (na, 33)).astype(np.float32)
    b = rng.integers(0, 3, (nb, 33)).astype(np.float32)
    a[::10], b[::10] = 0.0, 0.0
    a_mask, b_mask = np.ones(na, bool), np.ones(nb, bool)
    for x, mask in ((a, a_mask), (b, b_mask)):
        n = len(x)
        for edge in list(range(128, n, 128)) + list(range(2048, n, 2048)):
            m = min(2, n - edge)
            x[edge: edge + m] = x[edge - m: edge]      # a tie straddling the boundary
            if edge % 512 == 0:
                mask[max(edge - 3, 0): edge + 3] = False
    b_mask[-min(5, nb - 1):] = False
    m = min(20, nb, na - na // 2)
    a[na // 2: na // 2 + m] = b[:m]                       # exact d2 = 0 matches
    return a, a_mask, b, b_mask


def mutual_rounding(a, a_mask, b, b_mask, pick_k, pick_p) -> tuple[int, float]:
    """(rows whose kernel pick differs from the plain pick, the largest
    |exact d2 of the kernel's pick - exact d2 of the plain pick| over
    MUTUAL_ROUND_UNITS u of (|a|^2 + |b|^2)), exact d2 in float64; a row of
    ``a`` picks a row of ``b``."""
    import torch

    rows = torch.nonzero(pick_k.long() != pick_p.long()).flatten()
    if rows.numel() == 0:
        return 0, 0.0
    q = a[rows].double()
    rk, rp = b[pick_k[rows].long()].double(), b[pick_p[rows].long()].double()
    dk, dp = ((q - rk) ** 2).sum(-1), ((q - rp) ** 2).sum(-1)
    scale = (q * q).sum(-1) + torch.maximum((rk * rk).sum(-1), (rp * rp).sum(-1))
    # a pick may differ only between two valid pairs: where the plain pick is
    # no valid pair (every partner masked) the kernel must pick it too
    valid = a_mask[rows] & b_mask[pick_p[rows].long()] & b_mask[pick_k[rows].long()]
    ratio = (dk - dp).abs() / (MUTUAL_ROUND_UNITS * UNIT_ROUNDOFF * scale)
    return int(rows.numel()), float(torch.where(valid, ratio, float("inf")).max())


def check_k11_ties(na: int, nb: int, dev) -> None:
    """K11 on k11_tie_inputs(na, nb): ij and ji equal to the plain version's."""
    import torch

    from pcr_tpu_torch.ops.kernels import nn_kernels as nk

    a, am, b, bm = (torch.as_tensor(x, device=dev) for x in k11_tie_inputs(na, nb, na + nb))
    ij_k, ji_k = nk.nn1_mutual(a, am, b, bm)
    ij_p, ji_p = nk.nn1_mutual_reference(a, am, b, bm)
    torch.cuda.synchronize()
    if not (torch.equal(ij_k.long(), ij_p) and torch.equal(ji_k.long(), ji_p)):
        raise AssertionError(f"K11 ties {na} x {nb}: {int((ij_k.long() != ij_p).sum())} rows "
                             f"and {int((ji_k.long() != ji_p).sum())} columns differ")


def check_k11(label: str, args, library: bool):
    """K11 on a path's nn1_mutual arguments against its plain version: two
    kernel runs bit for bit; every row (a -> b) and column (b -> a) whose
    pick differs from the plain pick within the expanded form's rounding
    (mutual_rounding), the count printed; exact ties at the same shape
    (k11_tie_inputs) resolved alike.  Returns (worst rounding ratio, ms,
    plain ms, bound ms, bound by, library ms: torch.cdist, whose large
    shapes use the same expanded formula, and its minimum on both axes)."""
    import torch

    from pcr_tpu_torch.ops.kernels import nn_kernels as nk

    a, am, b, bm = args
    na, nb = a.shape[0], b.shape[0]
    ij_k, ji_k = nk.nn1_mutual(a, am, b, bm)
    ij_k2, ji_k2 = nk.nn1_mutual(a, am, b, bm)
    ij_p, ji_p = nk.nn1_mutual_reference(a, am, b, bm)
    torch.cuda.synchronize()
    if not (torch.equal(ij_k, ij_k2) and torch.equal(ji_k, ji_k2)):
        raise AssertionError(f"K11 {label}: two runs differ")
    rows, worst_r = mutual_rounding(a, am, b, bm, ij_k, ij_p)
    cols, worst_c = mutual_rounding(b, bm, a, am, ji_k, ji_p)
    worst = max(worst_r, worst_c)
    check_k11_ties(na, nb, a.device)
    ms = cuda_ms(lambda: nk.nn1_mutual(a, am, b, bm), 10)
    plain = cuda_ms(lambda: nk.nn1_mutual_reference(a, am, b, bm), 3)
    lib = None
    if library:
        def cdist_min():
            d = torch.cdist(a, b)
            return d.min(dim=1), d.min(dim=0)
        lib = cuda_ms(cdist_min, 3)
    lim = bound(4 * 33 * (na + nb) + 9 * (na + nb), MUTUAL_PAIR_OPS * na * nb)
    print(f"K11 nn1_mutual {label}: {na} x {nb} rows of 33 ({int(am.sum())} / {int(bm.sum())} "
          f"valid), two runs bit for bit; picks differing from the plain version's: {rows} "
          f"rows, {cols} columns, each within {worst:.3f} of the rounding bound "
          f"({MUTUAL_ROUND_UNITS} u of |a|^2 + |b|^2); exact ties at this shape equal; kernel "
          f"{ms:.4f} ms, plain {plain:.4f} ms, bound {lim[0]:.4f} ms ({lim[1]}), library "
          f"(cdist + min on both axes) {'not timed' if lib is None else f'{lib:.4f} ms'}")
    if not worst <= 1.0:
        raise AssertionError(f"K11 {label}: a differing pick is {worst} of the rounding bound")
    return worst, ms, plain, *lim, lib


def edge_block_errors(args, blocks) -> float:
    """The largest error of K12's blocks against the plain version's on the
    same arguments, over its bound (EDGE_BLOCK_REL, module constants)."""
    import torch

    from pcr_tpu_torch.ops.kernels import graph_kernels as gk
    from pcr_tpu_torch.utils import se3

    nodes, src, dst, edge_T, info, w = args
    plain = gk.edge_blocks_reference(*args)
    Tinv = se3.invert(edge_T)
    r = gk.edge_residual(nodes[src], nodes[dst], Tinv)
    Ji, Jj = gk.edge_jacobians(nodes[src], nodes[dst], Tinv)
    LJ = (w[:, None, None] * info) @ torch.cat([Ji, Jj], dim=-1)
    t_max = torch.stack([nodes[src][:, :3, 3].abs().amax(-1), nodes[dst][:, :3, 3].abs().amax(-1),
                         edge_T[:, :3, 3].abs().amax(-1)]).amax(0)
    rho = EDGE_RESIDUAL_ROUNDINGS * 2.0 ** -23 * (1.0 + t_max)
    h_scale = torch.stack([x.abs().flatten(1).amax(1) for x in plain[:3]]).amax(0)
    b_scale = 6 * LJ.abs().flatten(1).amax(1) * (rho + EDGE_BLOCK_REL * r.abs().amax(1))
    worst = 0.0
    for k, p, name in zip(blocks, plain, gk.BLOCKS_PER_EDGE):
        err = (k - p).abs().flatten(1).amax(1)
        lim = EDGE_BLOCK_REL * h_scale if name[0] == "H" else b_scale
        if not bool(torch.isfinite(k).all()):
            return float("inf")
        worst = max(worst, float((err / torch.clamp(lim, min=1e-30)).max()))
    return worst


def check_k12(label: str, args, library: bool):
    """K12 on a path's edge_blocks arguments: the blocks within their bound
    of the plain version's (edge_block_errors), two runs bit for bit; the
    assembly of the kernel's own blocks (the circuit's bands, or the dense
    system of any other graph) bit-equal to the CPU's plain index_add_ /
    index_put_ assembly of the same blocks, twice.  Returns two records'
    results: (blocks: worst ratio, ms, plain ms, bound ms, bound by, None),
    (assembly: 0, ms, plain ms on the card, bound ms, bound by, library ms:
    one index_add_ of every edge's packed terms, circuits only)."""
    import torch

    from pcr_tpu_torch.models.global_refine import pose_graph
    from pcr_tpu_torch.ops.kernels import graph_kernels as gk

    nodes, src, dst, edge_T, info, w = args
    n, E = nodes.shape[0], src.shape[0]
    dense = not pose_graph.is_circuit_graph(pose_graph.PoseGraph(nodes, src, dst, edge_T, info,
                                                                 None, None))
    blocks = gk.edge_blocks(*args)
    blocks2 = gk.edge_blocks(*args)
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(blocks, blocks2)):
        raise AssertionError(f"K12 {label}: two runs of the blocks differ")
    worst = edge_block_errors(args, blocks)
    plan = gk.assembly_plan(n, src, dst, dense=dense)
    assemble = gk.assemble_dense if dense else gk.assemble_band
    reference = gk.assemble_dense_reference if dense else gk.assemble_band_reference
    got, got2 = assemble(plan, *blocks), assemble(plan, *blocks)
    cpu = reference(n, src.cpu(), dst.cpu(), *(x.cpu() for x in blocks))
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(got, got2)):
        raise AssertionError(f"K12 {label}: two assemblies differ")
    if not all(torch.equal(x.cpu(), y) for x, y in zip(got, cpu)):
        raise AssertionError(f"K12 {label}: the assembly differs from the CPU's index_add_ by "
                             + ", ".join(f"{float((x.cpu() - y).abs().max()):.3e}"
                                         for x, y in zip(got, cpu)))
    ms = cuda_ms(lambda: gk.edge_blocks(*args), 20)
    plain_ms, plain_wall = plain_times(lambda: gk.edge_blocks_reference(*args), 3)
    ms_a = cuda_ms(lambda: assemble(plan, *blocks), 20)
    plain_a = cuda_ms(lambda: reference(n, src, dst, *blocks), 5)
    lib = None
    if library and not dense:
        rows = torch.cat([src, dst])
        Hii, Hjj, Hij, bi, bj = blocks
        adj = (dst == src + 1)[:, None, None]
        packed = torch.cat([torch.cat([Hii.flatten(1), torch.where(adj, Hij, 0.0).flatten(1), bi],
                                      1),
                            torch.cat([Hjj.flatten(1), torch.zeros_like(Hij).flatten(1), bj], 1)])
        lib = cuda_ms(lambda: nodes.new_zeros((n, 78)).index_add_(0, rows, packed), 20)
    in_bytes = 64 * n + 8 * E + (64 + 144 + 4) * E
    lim_b = bound(in_bytes + 480 * E, EDGE_BLOCK_OPS * E)
    terms = (36 * n * n + 6 * n) if dense else 78 * n
    adds = (4 * 36 + 12) * E if dense else (2 * 36 + 36 + 12) * E
    lim_a = bound(480 * E + 4 * (n + 1) + 8 * E + 4 * terms, adds)
    print(f"K12 edge_blocks {label}: {n} nodes, {E} edges ({'dense' if dense else 'bands'}); "
          f"blocks within {worst:.3f} of their bound of the plain version's, two runs bit for "
          f"bit; the assembly of the kernel's blocks bit-equal to the CPU's index_add_, twice; "
          f"blocks kernel {ms:.4f} ms, plain {plain_ms:.3f} ms (host {plain_wall:.3f} ms), bound "
          f"{lim_b[0]:.6f} ms ({lim_b[1]}); assembly kernel {ms_a:.4f} ms, plain (index_add_ "
          f"on the card) {plain_a:.4f} ms, bound {lim_a[0]:.6f} ms ({lim_a[1]})"
          + (f", one index_add_ {lib:.4f} ms" if lib is not None else ""))
    if not worst <= 1.0:
        raise AssertionError(f"K12 {label}: blocks {worst} of their bound from the plain ones")
    return (worst, ms, plain_ms, *lim_b, None), (0.0, ms_a, plain_a, *lim_a, lib)


def phase_k10(dev) -> list[dict]:
    """Phase 23's K10 part (module docstring): K10 on the first Gauss-Newton
    iteration of each scale of the CLI's ``full`` run (phase 18), timed at
    its finest scale, and on the Facade-scale pair's finest scale, timed;
    the device operations an iteration on the NCLT pair's finest scale; the
    band sweep's slab_starts on each shape the same run gave it, timed at
    its largest.  The JSON record keeps the times at the main path's finest
    scale."""
    from pcr_tpu_torch.models import multiscale

    k10 = {case: args for (name, case), args in LOOP_INPUTS.items() if name == "gicp"}
    starts = {case: args for (name, case), args in LOOP_INPUTS.items() if name == "slab_starts"}
    if not (k10 and starts):
        raise AssertionError(f"phase 23 lacks K10's inputs: {sorted(LOOP_INPUTS)}")
    finest = max(k10, key=lambda case: k10[case]["gicp_move"][0][1].shape[0])
    got = {case: check_k10(case, args, timed=case == finest) for case, args in k10.items()}
    dist = multiscale.max_correspondence_distances(multiscale.create_scales(5))[-1]
    src, tgt, T0, _ = gicp_pair("facade", dev)
    check_k10("Facade pair, finest scale", k10_inputs(src[-1], tgt[-1], dist, T0), timed=True)
    src, tgt, T0, _ = gicp_pair("nclt", dev)
    ops = iteration_device_ops(src[-1], tgt[-1], dist, T0)
    print(f"K10: {ops:g} device operations a band GICP iteration at the NCLT pair's finest "
          f"scale ({src[-1].capacity} rows)")
    if not ops <= 5:
        raise AssertionError(f"a band GICP iteration launched {ops} device operations")
    largest = max(starts, key=lambda case: starts[case][0][0].shape[0])
    checked = {case: check_slab_starts(case, args, timed=case == largest)
               for case, args in starts.items()}
    print(f"slab_starts bit-equal to the rule's on {len(checked)} shapes of the main path")
    return [record(name, "pcr_tpu_torch/csrc/gicp.cu", "pcr_tpu/models/gicp.py:442",
                   [(r[err],) for r in got.values()], got[finest][name])
            for name, err in (("gicp_move", "q_err"), ("gicp_rows", "sums_err"),
                              ("gicp_update", "T_err"))] + [
        record("slab_starts", "pcr_tpu_torch/csrc/band_nn.cu",
               "pcr_tpu/ops/band_nn.py:105", list(checked.values()), checked[largest])]


KNN_PAIR_OPS = 8          # FP32 operations of a (query, ref) d2 in K13 (pcr::sqdist)
KNN_F64_ROWS = 256        # query rows held to the float64 k smallest in check_k13
NCLT_BUCKET = 24576       # the benchmark's NCLT capacity


def check_k13(label: str, args, timed: bool = False):
    """K13 on knn_exact's arguments (query, ref, mask, k, exclude_self)
    against its plain version: d2 and indices equal (both keep each row's k
    smallest (d2, index) keys by the same rounded d2), two runs bit for bit,
    KNN_F64_ROWS rows' d2 within FP32 rounding of the float64 k smallest.
    Returns (0, ms, plain ms, bound ms, bound by, library ms: knn_tiled, the
    tiled torch.topk path the card ran before K13) when ``timed``, else
    (0,).  The bound counts every query against every valid ref, as a
    brute-force selection does, and the output written once."""
    import torch

    from pcr_tpu_torch.ops import knn
    from pcr_tpu_torch.ops.kernels import common
    from pcr_tpu_torch.ops.kernels import nn_kernels as nk

    q, r, m, k, excl = args
    nq, nr, nv = q.shape[0], r.shape[0], int(m.sum())
    d_k, i_k = nk.knn_select(q, r, m, k, exclude_self=excl)
    d_k2, i_k2 = nk.knn_select(q, r, m, k, exclude_self=excl)
    d_p, i_p = nk.knn_select_reference(q, r, m, k, exclude_self=excl)
    torch.cuda.synchronize()
    if not (torch.equal(d_k, d_k2) and torch.equal(i_k, i_k2)):
        raise AssertionError(f"K13 {label}: two runs differ")
    if not torch.equal(d_k, d_p):
        raise AssertionError(f"K13 {label}: d2 differs from the plain version's in "
                             f"{int((d_k != d_p).any(dim=1).sum())} rows")
    if not torch.equal(i_k, i_p):
        raise AssertionError(f"K13 {label}: indices differ from the plain version's in "
                             f"{int((i_k != i_p).any(dim=1).sum())} rows")
    rows = torch.linspace(0, nq - 1, min(KNN_F64_ROWS, nq), device=q.device).long()
    d64 = ((q[rows, None, :].double() - r[None, :, :].double()) ** 2).sum(-1)
    d64 = torch.where(m[None, :], d64, torch.inf)
    if excl and nq == nr:
        d64[torch.arange(len(rows), device=q.device), rows] = torch.inf
    d64 = torch.sort(d64, dim=1).values[:, :k]
    real = torch.isfinite(d64)
    f64 = float(((d_k[rows].double() - d64).abs() / d64.clamp(min=1e-30))[real].max()) \
        if bool(real.any()) else 0.0
    if not (torch.equal(real, d_k[rows] < common.BIG) and f64 <= 1e-6):
        raise AssertionError(f"K13 {label}: d2 {f64} relative from the float64 k smallest")
    line = (f"K13 knn_select {label}: {nq} q x {nr} refs ({nv} valid), k = {k}"
            f"{', exclude_self' if excl else ''}: d2 and indices equal to the plain version's, "
            f"two runs bit for bit, d2 within {f64:.2e} of the float64 k smallest")
    if not timed:
        print(line)
        return (0.0,)
    ms = cuda_ms(lambda: nk.knn_select(q, r, m, k, exclude_self=excl), 10)
    plain = cuda_ms(lambda: nk.knn_select_reference(q, r, m, k, exclude_self=excl), 1)
    lib = cuda_ms(lambda: knn.knn_tiled(q, r, m, k, exclude_self=excl), 3)
    lim = bound(12 * (nq + nr) + nr + 12 * nq * k, KNN_PAIR_OPS * nq * nv)
    print(line + f"; kernel {ms:.4f} ms, plain {plain:.1f} ms, bound {lim[0]:.4f} ms "
          f"({lim[1]}: every query against every valid ref), former tiled torch.topk path "
          f"{lib:.2f} ms")
    return 0.0, ms, plain, *lim, lib


def phase_k13(dev) -> dict:
    """Phase 24 (module docstring).  The JSON record keeps the times at the
    largest Facade scan's shape (the selection features' k = 200 call)."""
    from pcr_tpu_torch.models import multiscale
    from pcr_tpu_torch.ops import knn
    from pcr_tpu_torch.utils import cloud

    facade, _ = make_facade_circuit()
    nclt = cloud.from_numpy(make_circuit()[0][0], NCLT_BUCKET, device=dev)
    got = {}
    for i in (0, FACADE_SCANS - 1):
        c = cloud.from_numpy(facade[i], FACADE_CAPACITY, device=dev)
        got[f"Facade scan {i}"] = check_k13(f"Facade scan {i}, selection features",
                                            (c.points, c.points, c.mask, 200, True),
                                            timed=True)
    half = FACADE_CAPACITY // 2
    got["sharded refs"] = check_k13(f"Facade scan {FACADE_SCANS - 1} against its first half",
                                    (c.points, c.points[:half], c.mask[:half], 200, False))
    got["NCLT"] = check_k13("NCLT scan 0, selection features",
                            (nclt.points, nclt.points, nclt.mask, 200, True), timed=True)
    got["viz"] = check_k13("NCLT scan 0, viz's k = 1",
                           (nclt.points, nclt.points, nclt.mask, 1, True))
    calls = []
    original = knn.knn_exact

    def kept(query, ref, ref_mask, k, *, exclude_self=False, **kw):
        calls.append((query, ref, ref_mask, k, exclude_self))
        return original(query, ref, ref_mask, k, exclude_self=exclude_self, **kw)

    knn.knn_exact = kept
    try:
        multiscale.build_pyramid(nclt, 5, fused=False)
    finally:
        knn.knn_exact = original
    if sorted({a[3] for a in calls}) != [20, 30] or len(calls) != 10:
        raise AssertionError(f"the unfused pyramid made {len(calls)} knn_exact calls, k "
                             f"{sorted({a[3] for a in calls})}")
    for n, args in enumerate(calls):
        got[f"pyramid {n}"] = check_k13(f"unfused pyramid, scale {n // 2}", args,
                                        timed=n >= len(calls) - 2)
    return record("knn_select", "pcr_tpu_torch/csrc/knn.cu", "pcr_tpu/ops/knn.py:170",
                  list(got.values()), got[f"Facade scan {FACADE_SCANS - 1}"])


def phase_voxel_counts(dev) -> dict:
    """Phase 25 (module docstring).  The JSON record keeps the times at 32
    scans, a seq32 unit's planner call."""
    import torch

    from pcr_tpu_torch.models import multiscale
    from pcr_tpu_torch.ops.kernels import feature_kernels
    from pcr_tpu_torch.utils import cloud

    scans = make_circuit()[0]
    rng = np.random.default_rng(SEED)
    scans = scans + [scans[i % N_SCANS] + rng.uniform(-50, 50, 3).astype(np.float32)
                     for i in range(N_SCANS, 128)]
    scales = multiscale.create_scales(5)
    got = {}
    for n in (2, 32, 128):
        on_card = [cloud.from_numpy(s, CAPACITY, device=dev) for s in scans[:n]]
        on_host = [cloud.from_numpy(s, CAPACITY, device="cpu") for s in scans[:n]]
        table = cloud._card_counts(on_card, scales)
        if not np.array_equal(table, cloud._card_counts(on_card, scales)):
            raise AssertionError(f"voxel_counts at {n} scans differs from itself")
        if not np.array_equal(table, cloud._host_counts(on_card, scales)):
            raise AssertionError(f"voxel_counts at {n} scans differs from native.count_voxels")
        caps = cloud.plan_scale_caps(on_card, scales)
        if caps != cloud.plan_scale_caps(on_host, scales):
            raise AssertionError(f"the card's caps at {n} scans differ from the host route's")
        if n == 128:
            lazy = cloud.LazyClouds(on_host, device=dev)
            if cloud.plan_scale_caps(lazy, scales) != caps or lazy._cache:
                raise AssertionError("the caps over a LazyClouds differ or it filled the LRU")
        points, masks = [c.points for c in on_card], [c.mask for c in on_card]
        ms = cuda_ms(lambda: feature_kernels.voxel_counts(points, masks, scales), 10)
        card = statistics.median(synced(lambda: cloud.plan_scale_caps(on_card, scales))[1]
                                 for _ in range(5)) * 1e3
        host = statistics.median(synced(lambda: cloud._host_counts(on_card, scales))[1]
                                 for _ in range(3)) * 1e3
        bound_ms, by = bound(n * CAPACITY * 13, 0)   # points and mask read once
        print(f"voxel_counts at {n} scans x {len(scales)} scales: kernel {ms:.4f} ms "
              f"({len(feature_kernels.voxel_chunks(n, CAPACITY, len(scales)))} launches), "
              f"planner on the card {card:.3f} ms, host route on the same clouds "
              f"{host:.3f} ms, bound {bound_ms:.5f} ms ({by}); caps {caps}")
        got[n] = (0.0, ms, host, bound_ms, by)
    return record("voxel_counts", "pcr_tpu_torch/csrc/voxel_counts.cu",
                  "none (pcr_tpu/utils/cloud.py plan_scale_caps counts on the host)",
                  list(got.values()), got[32])


def phase_loop_kernels(dev) -> list[dict]:
    """Phase 23 (module docstring): K8, K9, K11, K12 and K10 (``phase_k10``)
    against their plain versions on the arguments the earlier phases gave
    them.  The JSON record
    keeps K8's and K11's times at the main path's shape (one NCLT stage-1
    pair: the CLI's ``full`` streams stage 1, one launch a pair) and K9's
    and K12's at NCLT's n = 901."""
    gnc = {case: check_k8(case, args) for (name, case), args in LOOP_INPUTS.items()
           if name == "gnc"}
    thomas = {case: check_k9(case, args, library=case.startswith("NCLT"))
              for (name, case), args in LOOP_INPUTS.items() if name == "block_thomas"}
    mutual = {case: check_k11(case, args, library=case.startswith("NCLT"))
              for (name, case), args in LOOP_INPUTS.items() if name == "nn1_mutual"}
    edges = {case: check_k12(case, args, library=case.startswith("NCLT"))
             for (name, case), args in LOOP_INPUTS.items() if name == "edge_blocks"}
    if len(gnc) != 3 or len(thomas) != 2 or len(mutual) != 2 or len(edges) != 3:
        raise AssertionError(f"phase 23 lacks inputs: {sorted(LOOP_INPUTS)}")
    nclt_edges = next(r for case, r in edges.items() if case.startswith("NCLT"))
    return phase_k10(dev) + [
            record("gnc", "pcr_tpu_torch/csrc/loops.cu", "pcr_tpu/models/fgr.py:166",
                   list(gnc.values()), gnc["NCLT stage 1, batch 1"]),
            record("block_thomas", "pcr_tpu_torch/csrc/loops.cu",
                   "pcr_tpu/models/global_refine/pose_graph.py:173", list(thomas.values()),
                   next(r for case, r in thomas.items() if case.startswith("NCLT"))),
            record("nn1_mutual", "pcr_tpu_torch/csrc/mutual_nn.cu", "pcr_tpu/ops/knn.py:305",
                   list(mutual.values()), mutual["NCLT stage-1 pair"]),
            record("edge_blocks", "pcr_tpu_torch/csrc/pose_graph.cu",
                   "pcr_tpu/models/global_refine/pose_graph.py:100",
                   [r[0] for r in edges.values()], nclt_edges[0]),
            record("edge_assembly", "pcr_tpu_torch/csrc/pose_graph.cu",
                   "pcr_tpu/models/global_refine/pose_graph.py:243",
                   [r[1] for r in edges.values()], nclt_edges[1])]


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
    base, launches2, wall2 = phase_slice(clouds, gt, init)
    phase_split(clouds, init)
    records += phase_feature_kernels(clouds)
    rel1, launches1, wall1 = phase_stage1(clouds, gt)
    # the retry ladder on, as run_full's default configuration has it
    rel12, _, _, wall12 = run_stage2(clouds, gt, rel1, "stage 1 -> 2", ("seeded by stage 1",),
                                     retry_failed=True)
    launches3, wall3 = phase_stage3(clouds, gt, rel12)
    launches_full, full_out, full_wall = phase_full(clouds, rel1, rel12,
                                                    wall1 + wall12 + wall3)
    launches_b1, launches_b2, batched = phase_batched(clouds, gt, init, rel1, base, wall1,
                                                      wall2)
    phase_stage3_nclt(dev)
    phase_stage1_split(clouds)
    records.append(phase_k7(dev, clouds, gt))
    launches7 = phase_brute(clouds, gt, init)
    phase_stage1_selection(clouds, gt)
    phase_retry(clouds, gt, init, base)
    launches_main, launches_log, pair = phase_entry_points(clouds, scans, gt, full_out,
                                                           full_wall)
    phase_data_plane(scans)
    one = phase_mesh_one_rank(clouds, scans, init, batched, pair)
    phase_mesh_two_ranks(scans, gt, init, batched, one)
    phase_graph_builder(dev)
    records += phase_loop_kernels(dev)
    records.append(phase_k13(dev))
    records.append(phase_voxel_counts(dev))
    print(f"launches by path: stage 2 {launches2}; stage 1 {launches1}; stage 3 {launches3}; "
          f"stage 1 batched {launches_b1}; stage 2 batched {launches_b2}; "
          f"brute GICP {launches7}; gicp_loss_log {launches_log}; run_full {launches_full}; "
          f"python -m pcr_tpu_torch full (the main path) {launches_main}")
    for rec in records:
        rec["launches"] = (launches7 if rec["name"] in BRUTE_KERNELS
                           else launches_main)[rec["name"]]
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
