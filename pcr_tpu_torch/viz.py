"""Headless visualization and reporting artifacts (port of pcr_tpu/viz.py on
port Clouds).

The reference drives an interactive OpenGL window (``o3d.visualization``);
here the equivalent artifacts are exported instead:
  * merged registered clouds -> PLY (colors per scan), replacing
    ``apply_poses_in_clouds`` (1_...py:74-90);
  * trajectory line sets -> PLY edges, replacing
    ``criar_trejetoria_com_linhas`` (3_...py:104-126) /
    ``draw_circuit_lines`` (3_...py:44-54);
  * the reference's matplotlib reports: pose-error curves
    (1_...py:166-172, 3_...py:376-386), RMSE/fitness per pair
    (plot_RMSE_line / plot_fitness_line, ALL_FUNCTIONS.py:869-893),
    per-pair timing bars (plot_bar_time, ALL_FUNCTIONS.py:924-929).

Matplotlib (Agg backend) and Pillow are imported only inside the functions
that plot, so the module imports where neither is installed.  Clouds may lie
on any device: their rows are read to the host.  Every function writes a
file and returns its path.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .utils import se3
from .utils.cloud import Cloud


def _np(x) -> np.ndarray:
    """A tensor (any device) or array as a host numpy array."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _valid_points(c: Cloud) -> np.ndarray:
    return _np(c.points)[_np(c.mask)]


def _ensure_dir(path):
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    return path


def write_ply(path, points: np.ndarray, colors: np.ndarray | None = None,
              edges: np.ndarray | None = None) -> str:
    """Minimal binary-less PLY writer (ascii; readable by Meshlab/CloudCompare)."""
    points = _np(points)
    n = len(points)
    has_color = colors is not None
    lines = ["ply", "format ascii 1.0", f"element vertex {n}",
             "property float x", "property float y", "property float z"]
    if has_color:
        lines += ["property uchar red", "property uchar green", "property uchar blue"]
    if edges is not None:
        lines += [f"element edge {len(edges)}", "property int vertex1", "property int vertex2"]
    lines += ["end_header"]
    with open(_ensure_dir(path), "w") as fh:
        fh.write("\n".join(lines) + "\n")
        if has_color:
            c8 = np.clip(_np(colors) * 255, 0, 255).astype(np.uint8)
            for p, c in zip(points, c8):
                fh.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} {c[0]} {c[1]} {c[2]}\n")
        else:
            for p in points:
                fh.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
        if edges is not None:
            for a, b in _np(edges):
                fh.write(f"{int(a)} {int(b)}\n")
    return path


def export_registered_clouds(path, clouds: list[Cloud], poses: np.ndarray,
                             max_points_per_cloud: int = 20000, seed: int = 0) -> str:
    """Apply absolute poses and merge into one colored PLY
    (headless ``apply_poses_in_clouds``)."""
    rng = np.random.default_rng(seed)
    all_pts, all_cols = [], []
    for i, (c, T) in enumerate(zip(clouds, _np(poses))):
        pts = _valid_points(c)
        if len(pts) > max_points_per_cloud:
            pts = pts[rng.choice(len(pts), max_points_per_cloud, replace=False)]
        pts = pts @ T[:3, :3].T + T[:3, 3]
        color = rng.uniform(0.15, 0.95, size=3)
        all_pts.append(pts)
        all_cols.append(np.tile(color, (len(pts), 1)))
    return write_ply(path, np.concatenate(all_pts), np.concatenate(all_cols))


def export_trajectory(path, poses: np.ndarray, closed: bool = True) -> str:
    """Trajectory polyline as PLY edges (``criar_trejetoria_com_linhas``)."""
    t = _np(poses)[:, :3, 3]
    n = len(t)
    edges = [[i, i + 1] for i in range(n - 1)]
    if closed:
        edges.append([n - 1, 0])
    return write_ply(path, t, edges=_np(edges))


# ---------------------------------------------------------------------------
# Animated reconstruction (ALL_FUNCTIONS.py:674-789), headless:
# pose-interpolated frame sequences exported as PLY-per-frame and/or GIF.
# ---------------------------------------------------------------------------

def _subsample(pts, cap, rng):
    if len(pts) > cap:
        return pts[rng.choice(len(pts), cap, replace=False)]
    return pts


def animate_pair(out_dir, source: Cloud, target: Cloud, T, n_frames: int = 30,
                 max_points: int = 20000, seed: int = 0) -> list[str]:
    """Registration animation for one pair (``animacao_registro_par``,
    ALL_FUNCTIONS.py:674-697): the source slides from identity to its
    registered pose T over n_frames; the target stays fixed.  Writes
    frame_000.ply ... frame_{n-1}.ply (source red, target gray)."""
    rng = np.random.default_rng(seed)
    src = _subsample(_valid_points(source), max_points, rng)
    tgt = _subsample(_valid_points(target), max_points, rng)
    T = _np(T).astype(np.float64)
    eye = np.eye(4)
    paths = []
    for f in range(n_frames):
        t = f / max(n_frames - 1, 1)
        Tf = _np(se3.interpolate(eye, T, t))
        pts = np.concatenate([src @ Tf[:3, :3].T + Tf[:3, 3], tgt])
        cols = np.concatenate([
            np.tile([0.85, 0.2, 0.2], (len(src), 1)),
            np.tile([0.6, 0.6, 0.6], (len(tgt), 1)),
        ])
        paths.append(write_ply(
            os.path.join(out_dir, f"frame_{f:03d}.ply"), pts, cols))
    return paths


def animate_reconstruction(out_dir, clouds: list[Cloud], poses,
                           frames_per_cloud: int = 8, max_points: int = 5000,
                           seed: int = 0, gif: bool = True,
                           ply_frames: bool = False) -> list[str]:
    """Animated circuit reconstruction (``animacao_reconstrucao_*``,
    ALL_FUNCTIONS.py:740-789): clouds join the scene one at a time, each
    interpolating from identity to its absolute pose while earlier clouds
    stay registered.  Exports an XY-view GIF (and optionally PLY frames)."""
    rng = np.random.default_rng(seed)
    poses = _np(poses).astype(np.float64)
    pts_list = [_subsample(_valid_points(c), max_points, rng) for c in clouds]
    colors = [rng.uniform(0.15, 0.95, size=3) for _ in clouds]
    eye = np.eye(4)
    frames = []  # (points, colors) per frame
    placed_pts, placed_cols = [], []
    for i, (pts, T) in enumerate(zip(pts_list, poses)):
        for f in range(frames_per_cloud):
            t = (f + 1) / frames_per_cloud
            Tf = _np(se3.interpolate(eye, T, t))
            moving = pts @ Tf[:3, :3].T + Tf[:3, 3]
            frame_pts = placed_pts + [moving]
            frame_cols = placed_cols + [np.tile(colors[i], (len(moving), 1))]
            frames.append((np.concatenate(frame_pts), np.concatenate(frame_cols)))
        placed_pts.append(pts @ poses[i][:3, :3].T + poses[i][:3, 3])
        placed_cols.append(np.tile(colors[i], (len(pts), 1)))
    paths = []
    if ply_frames:
        for f, (p, c) in enumerate(frames):
            paths.append(write_ply(os.path.join(out_dir, f"frame_{f:03d}.ply"), p, c))
    if gif:
        paths.append(_frames_to_gif(
            os.path.join(out_dir, "reconstruction.gif"), frames))
    return paths


def _frames_to_gif(path, frames, fps: int = 10) -> str:
    """Render (points, colors) frames as an XY-scatter GIF via matplotlib."""
    plt = _plt()
    from matplotlib.animation import PillowWriter

    all_pts = np.concatenate([p for p, _ in frames])
    lo, hi = all_pts[:, :2].min(axis=0), all_pts[:, :2].max(axis=0)
    pad = 0.05 * (hi - lo + 1e-6)
    fig, ax = plt.subplots(figsize=(6, 6))
    writer = PillowWriter(fps=fps)
    with writer.saving(fig, _ensure_dir(path), dpi=80):
        for pts, cols in frames:
            ax.clear()
            ax.scatter(pts[:, 0], pts[:, 1], s=0.5, c=np.clip(cols, 0, 1))
            ax.set_xlim(lo[0] - pad[0], hi[0] + pad[0])
            ax.set_ylim(lo[1] - pad[1], hi[1] + pad[1])
            ax.set_aspect("equal")
            ax.set_xticks([]); ax.set_yticks([])
            writer.grab_frame()
    plt.close(fig)
    return path


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_pose_errors(path, error_series: dict[str, np.ndarray],
                     ylabel: str = "Error (m)") -> str:
    """Per-pose error curves for any number of methods (3_...py:376-386)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(10, 5))
    for label, values in error_series.items():
        ax.plot(_np(values), label=label)
    ax.set_xlabel("Absolute poses")
    ax.set_ylabel(ylabel)
    ax.grid(True)
    ax.legend()
    fig.savefig(_ensure_dir(path), dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_pair_metric(path, series: dict[str, np.ndarray], ylabel: str) -> str:
    """Per-pair RMSE/fitness comparison lines, labeled i-(i+1) with the final
    wraparound pair (plot_RMSE_line / plot_fitness_line)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(12, 5))
    n = len(next(iter(series.values())))
    labels = [f"{i}-{i + 1}" for i in range(n - 1)] + [f"{n - 1}-0"]
    for name, values in series.items():
        ax.plot(range(n), _np(values), label=name)
    step = max(n // 20, 1)
    ax.set_xticks(range(0, n, step), labels[::step], rotation=45, fontsize=7)
    ax.set_xlabel("Pairs")
    ax.set_ylabel(ylabel)
    ax.grid(True)
    ax.legend()
    fig.savefig(_ensure_dir(path), dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_time_bars(path, seconds: np.ndarray, labels: list[str] | None = None) -> str:
    """Per-item timing bars (plot_bar_time, 3_...py:14-18)."""
    plt = _plt()
    seconds = _np(seconds)
    fig, ax = plt.subplots(figsize=(10, 4))
    ax.bar(range(len(seconds)), seconds)
    if labels:
        ax.set_xticks(range(len(seconds)), labels, rotation=45, fontsize=7)
    ax.set_ylabel("Time (s)")
    fig.savefig(_ensure_dir(path), dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path


def report_circuit(out_dir: str, clouds, results: dict[str, np.ndarray],
                   reference: np.ndarray | None = None) -> list[str]:
    """One-call report: trajectories + error curves for each method."""
    paths = []
    for name, poses in results.items():
        paths.append(export_trajectory(os.path.join(out_dir, f"traj_{name}.ply"), poses))
    if reference is not None:
        errs = {}
        for name, poses in results.items():
            _, dt = se3.pose_errors(_np(poses), _np(reference))
            errs[name] = _np(dt)
        paths.append(plot_pose_errors(os.path.join(out_dir, "pose_errors.png"), errs))
    return paths


def plot_rmse_vs_iterations(path, loss_log, per_scale: bool = False) -> str:
    """Inlier-RMSE-vs-iteration curves from ``models.gicp.gicp_loss_log``.

    ``loss_log``: one log dict, or a list of per-scale log dicts with
    ``per_scale=True`` — matching the reference's ``plot_rmse_vs_iteracoes``
    (ALL_FUNCTIONS.py:843-848) and ``plot_RMSE_vs_iteracoes_por_escala``
    (ALL_FUNCTIONS.py:853-866)."""
    plt = _plt()
    logs = list(loss_log) if per_scale else [loss_log]
    fig, axes = plt.subplots(nrows=1, ncols=len(logs), figsize=(4 * len(logs), 4),
                             squeeze=False)
    for s, log in enumerate(logs):
        ax = axes[0][s]
        rmse = _np(log["inlier_rmse"])
        ax.plot(np.arange(len(rmse)), rmse)
        ax.set_title(("Scale Index: %d " % s if per_scale else "")
                     + "Inlier RMSE vs Iteration", fontsize=9)
        ax.set_xlabel("Iteration")
        ax.grid(True)
    fig.savefig(_ensure_dir(path), dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_pair_metric_bars(path, series: dict[str, np.ndarray], ylabel: str) -> str:
    """Grouped per-pair bars, one group color per algorithm (the reference's
    ``plot_RMSE_BAR`` / ``plot_fitness_BAR``, ALL_FUNCTIONS.py:897-920)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(12, 5))
    n = len(next(iter(series.values())))
    labels = [f"{i}-{i + 1}" for i in range(n - 1)] + [f"{n - 1}-0"]
    width = 0.8 / max(len(series), 1)
    for m, (name, values) in enumerate(series.items()):
        x = np.arange(n) + (m - (len(series) - 1) / 2) * width
        ax.bar(x, _np(values), width=width, label=name)
    step = max(n // 20, 1)
    ax.set_xticks(range(0, n, step), labels[::step], rotation=45, fontsize=7)
    ax.set_xlabel("Pairs")
    ax.set_ylabel(ylabel)
    ax.legend()
    fig.savefig(_ensure_dir(path), dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_nn_distance_boxplot(path, clouds: dict[str, "Cloud"]) -> str:
    """Per-cloud nearest-neighbor-distance boxplots for density analysis
    (the reference's ``plot_cloud_knn_distances``, ALL_FUNCTIONS.py:1076-1087,
    built on ``compute_nearest_neighbor_distance``), the distances by the
    port's ``ops.knn`` on the clouds' device."""
    from .ops import knn as knn_ops

    plt = _plt()
    names, dists = [], []
    for name, c in clouds.items():
        d2, _ = knn_ops.knn(c.points, c.points, c.mask, 1, exclude_self=True)
        d2 = _np(d2)[..., 0][_np(c.mask)]
        dists.append(np.sqrt(np.clip(d2, 0, None)))
        names.append(name)
    fig, ax = plt.subplots(figsize=(8, 1.5 + len(names)))
    ax.boxplot(dists, vert=False, tick_labels=names)
    ax.set_xlabel("Knn distances")
    fig.savefig(_ensure_dir(path), dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path


def export_correspondences(path, source: "Cloud", target: "Cloud", T,
                           corr: np.ndarray, n: int = 100, seed: int = 0) -> str:
    """Headless ``draw_correspondences`` (ALL_FUNCTIONS.py:1062-1071): sample
    ``n`` correspondences (rows of ``corr`` = (src_idx, tgt_idx)) and export
    the transformed source + target points with connecting edges as PLY."""
    corr = _np(corr)
    rng = np.random.default_rng(seed)
    if len(corr) > n:
        corr = corr[rng.integers(len(corr), size=n)]
    T = _np(T)
    src = _np(source.points)[corr[:, 0]] @ T[:3, :3].T + T[:3, 3]
    tgt = _np(target.points)[corr[:, 1]]
    pts = np.concatenate([src, tgt])
    m = len(corr)
    edges = np.stack([np.arange(m), np.arange(m) + m], axis=1)
    colors = np.concatenate([np.tile([1.0, 0.706, 0.0], (m, 1)),
                             np.tile([0.0, 0.651, 0.929], (m, 1))])
    return write_ply(path, pts, colors=colors, edges=edges)
