"""Seeded synthetic scans for the benchmark (numpy, host).

A frozen copy of the scene and circuit generators of ``chip_smoke.py``
(``_world``, ``make_circuit``, ``make_facade_circuit``) and of the PCD
writer of ``pcr_tpu_torch/utils/pcd.py`` (``write_pcd``, binary xyz only).
The benchmark owns these copies, so a later change to the program cannot
change the yardstick.  Two changes from the originals:

* ``make_circuit`` takes the number of scans, and the world grows with the
  path at the original's point density: its radius is the original 36 m
  plus the path's reach from the scene's centre, its ground samples and
  objects scale with the area, and objects are placed over the grown disc.
* The scene (layout and dense samples) is drawn from the configuration's
  ``scene_seed``; the run's ``--seed`` draws which scene points each scan
  keeps and their 1 cm noise.  Every seed then gives scans of the same
  sizes over the same geometry, so the work per unit does not change with
  the seed.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np

DATA = Path(__file__).resolve().parent / "data"
BASE_RADIUS_M = 36.0        # chip_smoke._world's ground disc
BASE_SPREAD_M = 25.0        # ... and the half-width of its object placement


def _rot_z(a: float) -> np.ndarray:
    c, s = math.cos(a), math.sin(a)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def _cylinder(rng, m: int, x: float, y: float, radius: float, z0: float, height: float):
    a = rng.uniform(0, 2 * np.pi, m)
    return np.stack([x + radius * np.cos(a), y + radius * np.sin(a),
                     z0 + rng.uniform(0, height, m)], 1)


def _sphere(rng, m: int, c, radius: float):
    v = rng.normal(size=(m, 3))
    return np.asarray(c) + radius * v / np.linalg.norm(v, axis=1, keepdims=True)


def world(rng: np.random.Generator, center: np.ndarray, reach: float = 0.0) -> np.ndarray:
    """Dense point samples of chip_smoke's scene (undulating ground with
    mounds, walls in three directions, yawed boxes, trees and poles), grown
    by ``reach`` metres of radius at the same density."""
    radius = BASE_RADIUS_M + reach
    grow = (radius / BASE_RADIUS_M) ** 2          # area
    spread = BASE_SPREAD_M + reach
    parts = []
    n = int(900_000 * grow)
    r = radius * np.sqrt(rng.random(n))
    th = rng.uniform(0, 2 * np.pi, n)
    x, y = center[0] + r * np.cos(th), center[1] + r * np.sin(th)
    z = (0.12 * np.sin(0.31 * x) * np.cos(0.27 * y) + 0.05 * np.sin(1.3 * x + 0.7 * y)
         - 1.8)
    for kx, ky, ph, a in rng.uniform([-3.0, -3.0, 0.0, 0.06], [3.0, 3.0, 2 * np.pi, 0.2],
                                     (12, 4)):
        z += a * np.sin(kx * (x - center[0]) + ky * (y - center[1]) + ph)
    for mx, my, mh, mw in rng.uniform([-spread, -spread, 0.3, 1.0], [spread, spread, 1.2, 3.0],
                                      (int(round(24 * grow)), 4)):
        z += mh * np.exp(-((x - center[0] - mx) ** 2 + (y - center[1] - my) ** 2)
                         / (2 * mw * mw))
    parts.append(np.stack([x, y, z], 1))
    walls = [(-20, 14, 0.0, 45, 5), (-16, -18, np.pi / 2, 32, 4),
             (22, -12, 2.2, 30, 6), (8, 20, -0.4, 20, 3)]
    for ax, ay, ang, length, height in walls:
        m = int(2000 * length * height / 10)
        s = rng.uniform(0, length, m)
        h = rng.uniform(0, height, m)
        d = np.array([math.cos(ang), math.sin(ang)])
        parts.append(np.stack([center[0] + ax + s * d[0], center[1] + ay + s * d[1],
                               h - 1.8], 1))
    boxes = [(6, 4, 0.3, 2.0, 1.5, 1.2), (-5, 7, 1.0, 3.0, 1.0, 2.0),
             (3, -7, -0.6, 1.5, 1.5, 2.5), (-9, -4, 0.1, 2.5, 2.0, 1.0),
             (12, 2, 0.8, 1.0, 3.0, 1.8), (-2, -12, 0.5, 4.0, 1.2, 1.5)]
    boxes += [tuple(b) for b in rng.uniform([-spread, -spread, -np.pi, 1.5, 1.5, 0.8],
                                            [spread, spread, np.pi, 4.5, 2.0, 1.6],
                                            (int(round(14 * grow)), 6))]
    for bx, by, yaw, sx, sy, sz in boxes:
        m = int(600 * (2 * (sx + sy) * sz + sx * sy))
        u = rng.random((m, 3)) * [sx, sy, sz]
        face = rng.integers(0, 5, m)
        u[face == 0, 0] = 0.0
        u[face == 1, 0] = sx
        u[face == 2, 1] = 0.0
        u[face == 3, 1] = sy
        u[face == 4, 2] = sz
        local = u - [sx / 2, sy / 2, 0.0]
        parts.append(local @ _rot_z(yaw).T + [center[0] + bx, center[1] + by, -1.8])
    for tx, ty, tr, th_, cr in rng.uniform([-spread, -spread, 0.15, 2.0, 1.0],
                                          [spread, spread, 0.4, 4.0, 2.5],
                                          (int(round(40 * grow)), 5)):
        parts.append(_cylinder(rng, int(3000 * th_ * tr), center[0] + tx, center[1] + ty,
                               tr, -1.8, th_))
        parts.append(_sphere(rng, int(1500 * cr * cr), [center[0] + tx, center[1] + ty,
                                                         th_ - 1.8 + 0.8 * cr], cr))
    for px, py, ph in rng.uniform([-spread, -spread, 3.0], [spread, spread, 7.0],
                                  (int(round(20 * grow)), 3)):
        parts.append(_cylinder(rng, int(400 * ph), center[0] + px, center[1] + py, 0.1,
                               -1.8, ph))
    return np.concatenate(parts)


def _sample(world_pts, A, target, rng, noise_m, capacity=None, exact_target=False):
    """One scan seen from absolute pose A: scene points 1-30 m away kept with
    probability ~ 1/r^2 scaled to ``target`` points, plus Gaussian noise, in
    the sensor frame (float32)."""
    r = np.linalg.norm(world_pts - A[:3, 3], axis=1)
    w = np.where((r > 1.0) & (r < 30.0), 1.0 / np.maximum(r, 2.0) ** 2, 0.0)
    if exact_target:                  # make_facade_circuit's bisection on the scale
        lo, hi = target / w.sum(), target / w.sum() * 1e4
        for _ in range(60):
            mid = math.sqrt(lo * hi)
            lo, hi = (mid, hi) if np.minimum(1.0, mid * w).sum() < target else (lo, mid)
        p = np.minimum(1.0, hi * w)
    else:
        p = np.minimum(1.0, w * (target / w.sum()))
    pts = world_pts[rng.random(len(world_pts)) < p]
    if capacity is not None:
        pts = pts[:capacity]
    pts = pts + rng.normal(0.0, noise_m, pts.shape)
    return ((pts - A[:3, 3]) @ A[:3, :3]).astype(np.float32)


def nclt_relative() -> np.ndarray:
    """NCLT's 901 refined relative poses (``relative_FGR_GICP`` of the
    reference's outputs, pose_{k+1}_{k}), a copy kept with the benchmark."""
    return np.load(DATA / "nclt_relative_fgr_gicp.npy")


def make_circuit(n_scans: int, seed: int, scene_seed: int, *, capacity: int,
                 target_points: int, noise_m: float, side_step_m: float):
    """(scans, ground-truth relative poses (n, 4, 4) pose_{k+1}_{k}, absolute
    poses (n, 4, 4)) of an out-and-back circuit: the way out follows NCLT's
    first n/2 - 1 refined relative motions, the way back passes the same
    places ``side_step_m`` to the left in reverse order, so every pair, the
    closing one included, is 0.45-1.5 m apart."""
    if n_scans < 4 or n_scans % 2:
        raise ValueError(f"a circuit needs an even number of scans >= 4, got {n_scans}")
    rel_ref = nclt_relative()
    forward = [np.eye(4)]
    for k in range(n_scans // 2 - 1):
        forward.append(forward[-1] @ rel_ref[k])
    side = np.eye(4)
    side[1, 3] = side_step_m
    absolute = np.stack(forward + [A @ side for A in reversed(forward)])
    gt = np.stack([np.linalg.inv(absolute[k]) @ absolute[(k + 1) % n_scans]
                   for k in range(n_scans)])
    center = absolute[:, :3, 3].mean(axis=0)
    reach = float(np.max(np.linalg.norm(absolute[:, :2, 3] - center[:2], axis=1)))
    world_pts = world(np.random.default_rng(scene_seed), center, reach)
    rng = np.random.default_rng(seed)
    scans = [_sample(world_pts, A, target_points, rng, noise_m, capacity) for A in absolute]
    return scans, gt, absolute


def make_kgraph_path(n_scans: int, seed: int, scene_seed: int, *, points: tuple,
                     steps_m: tuple, noise_m: float):
    """(scans, absolute poses (n, 4, 4) sensor -> world) of chip_smoke's
    Facade-scale path: steps of ``steps_m`` in a seeded order, a turn of up
    to 8.6 deg a step; scan k keeps about ``points`` spread linearly over
    the scans (the scale bisected so the expected count is the target)."""
    layout = np.random.default_rng(scene_seed)
    steps = layout.permutation(np.linspace(*steps_m, n_scans - 1))
    yaw, p = 0.0, np.zeros(3)
    absolute = [np.eye(4)]
    for step in steps:
        yaw += layout.uniform(-0.15, 0.15)
        p = p + [step * math.cos(yaw), step * math.sin(yaw), layout.uniform(-0.05, 0.05)]
        A = np.eye(4)
        A[:3, :3], A[:3, 3] = _rot_z(yaw), p
        absolute.append(A)
    absolute = np.stack(absolute)
    world_pts = world(layout, absolute[:, :3, 3].mean(axis=0))
    rng = np.random.default_rng(seed)
    scans = [_sample(world_pts, A, target, rng, noise_m, exact_target=True)
             for A, target in zip(absolute, np.linspace(*points, n_scans))]
    return scans, absolute


def write_pcd(path, points: np.ndarray) -> None:
    """Binary PCD v0.7 with FIELDS x y z (float32), as the program's
    ``utils/pcd.write_pcd`` writes it without colours."""
    points = np.ascontiguousarray(points, dtype="<f4")
    n = points.shape[0]
    header = ("# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\n"
              "FIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n"
              f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\nDATA binary\n")
    with open(path, "wb") as fh:
        fh.write(header.encode("ascii"))
        fh.write(points.tobytes())
