"""Pose .txt I/O in the reference's on-disk checkpoint contract (numpy only;
the same functions as pcr_tpu/utils/poses_io.py).

Relative poses are written as ``pose_{i+1}_{i}.txt`` (plus the loop closure
``pose_0_{n-1}.txt``) and absolute poses as ``pose{i}.txt``: whitespace-
separated 4x4 row-major text.  The reference fixtures and scans live under
``REFERENCE_ROOT`` (``PCR_REFERENCE_ROOT`` in the environment, else the same
default as pcr_tpu's): ``relative_poses_FGR[_GICP]/<dataset>/``,
``absolute_poses_FGR_GICP/<dataset>/`` and
``nuvens/nuvens_pre_processadas/<dataset>/s{i}.pcd``.
"""

from __future__ import annotations

import os

import numpy as np

REFERENCE_ROOT = os.environ.get("PCR_REFERENCE_ROOT", "/root/reference")

# Circuit lengths of the shipped datasets
CIRCUIT_SIZES = {"NCLT": 901, "Courtyard": 8, "Facade": 7}


def load_pose(path: str) -> np.ndarray:
    T = np.loadtxt(path, dtype=np.float64)
    if T.shape != (4, 4):
        raise ValueError(f"{path}: expected 4x4 pose, got {T.shape}")
    return T


def save_pose(path: str, T: np.ndarray, fmt: str = "%.10f") -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savetxt(path, np.asarray(T), fmt=fmt)


def load_relative_circuit(directory: str, n: int) -> np.ndarray:
    """Load the n relative poses of a closed circuit, incl. the loop closure
    (pose_1_0 ... pose_{n-1}_{n-2}, then pose_0_{n-1}).  Returns (n, 4, 4) f64."""
    poses = [load_pose(os.path.join(directory, f"pose_{i + 1}_{i}.txt"))
             for i in range(n - 1)]
    poses.append(load_pose(os.path.join(directory, f"pose_0_{n - 1}.txt")))
    return np.stack(poses)


def load_absolute_poses(directory: str, n: int) -> np.ndarray:
    """Load pose0.txt ... pose{n-1}.txt -> (n, 4, 4)."""
    return np.stack([load_pose(os.path.join(directory, f"pose{i}.txt")) for i in range(n)])


def save_relative_circuit(directory: str, poses: np.ndarray) -> None:
    n = len(poses)
    for i in range(n - 1):
        save_pose(os.path.join(directory, f"pose_{i + 1}_{i}.txt"), poses[i])
    save_pose(os.path.join(directory, f"pose_0_{n - 1}.txt"), poses[n - 1])


def save_absolute_poses(directory: str, poses: np.ndarray) -> None:
    for i, T in enumerate(poses):
        save_pose(os.path.join(directory, f"pose{i}.txt"), T)


# -- Reference fixture helpers ------------------------------------------------

def reference_fixture_dir(stage: str, dataset: str) -> str:
    """stage in {'FGR', 'FGR_GICP', 'absolute_FGR_GICP'}."""
    sub = {
        "FGR": "relative_poses_FGR",
        "FGR_GICP": "relative_poses_FGR_GICP",
        "absolute_FGR_GICP": "absolute_poses_FGR_GICP",
    }[stage]
    return os.path.join(REFERENCE_ROOT, sub, dataset)


def load_reference_relative(stage: str, dataset: str) -> np.ndarray:
    return load_relative_circuit(reference_fixture_dir(stage, dataset), CIRCUIT_SIZES[dataset])


def load_reference_absolute(dataset: str) -> np.ndarray:
    return load_absolute_poses(reference_fixture_dir("absolute_FGR_GICP", dataset),
                               CIRCUIT_SIZES[dataset])


def reference_cloud_path(dataset: str, i: int) -> str:
    return os.path.join(REFERENCE_ROOT, "nuvens", "nuvens_pre_processadas", dataset,
                        f"s{i}.pcd")
