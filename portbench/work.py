"""Shared parts of the runners of units, and the loader of a traffic kind.

A traffic file (``traffic/<name>.json``) names its ``kind`` and its
parameters; the runner of a kind is ``kinds/<kind>.py``'s ``Runner``, found by
that name, and the configuration file (``configs/<name>.json``) gives the
deployment's sizes and the program's settings.  A runner

* makes the cell's inputs from ``--seed`` (``setup``),
* runs one unit of work through the program's own entry point (``unit``),
  each ending in ``torch.cuda.synchronize()``,
* says how much work a unit delivered (``work``: pairs, or one request),
* puts the plain reference in the program's place, one precision lower
  (``control``), for ``control.py``,
* gives the answers of its units to the plain reference (``judge``), which
  returns the numbers it reads; the cell's ``limits/<workload>.json`` says
  which of them are compared.

Nothing here imports the program at module level: the program is imported
inside ``setup`` and ``unit``, after the harness has checked the card.
"""

from __future__ import annotations

import hashlib
import importlib.util
import math
import os
from pathlib import Path

import numpy as np


def load_file(path: Path, name: str):
    """The Python file ``path`` as a module named ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def make(base: Path, cfg: dict, traffic: dict, seed: int, device, workdir: str):
    """The runner of the traffic's kind, ``<base>/kinds/<kind>.py``."""
    path = base / "kinds" / f"{traffic['kind']}.py"
    if not path.is_file():
        raise ValueError(f"unknown traffic kind {traffic['kind']!r}: no {path}")
    module = load_file(path, f"portbench_kind_{traffic['kind']}")
    # numpy's generators take any non-negative integer
    return module.Runner(cfg, traffic, seed % (1 << 63), device, workdir)


def pose_gap(T, T_ref) -> tuple[float, float]:
    """(translation gap in mm, rotation gap in millidegrees) of T against T_ref."""
    T, T_ref = np.asarray(T, np.float64), np.asarray(T_ref, np.float64)
    dR = T[:3, :3] @ T_ref[:3, :3].T
    axis = np.array([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0], dR[1, 0] - dR[0, 1]])
    ang = math.degrees(math.atan2(np.linalg.norm(axis) / 2.0, (np.trace(dR) - 1.0) / 2.0))
    return float(np.linalg.norm(T[:3, 3] - T_ref[:3, 3])) * 1e3, ang * 1e3


def entry_gap(A, B) -> float:
    """Largest entrywise |A - B| of two stacks of poses (rotation entries and
    translations in metres)."""
    return float(np.max(np.abs(np.asarray(A, np.float64) - np.asarray(B, np.float64))))


def digest(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(np.asarray(a, np.float64)).tobytes())
    return h.hexdigest()


def sync():
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


class Kind:
    """Shared parts: the configuration, the traffic, the seed."""

    def __init__(self, cfg, traffic, seed, device, workdir):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device, self.workdir = device, workdir
        self.rng = np.random.default_rng([seed, 7])     # samples of the check

    def pipeline_config(self, tag: str):
        from pcr_tpu_torch import pipeline

        fields = dict(self.cfg["pipeline"])
        fields.update(self.traffic.get("pipeline", {}))
        if "retry_voxel_mults" in fields:
            fields["retry_voxel_mults"] = tuple(fields["retry_voxel_mults"])
        return pipeline.PipelineConfig(output_root=os.path.join(self.workdir, tag), **fields)

    def release(self):
        """Drop the program's state before the reference runs."""
        self.clouds = None

    def control_units(self) -> int:
        """Units that one seed of ``control.py`` runs through the program."""
        return 1


def scene_args(cfg):
    s = cfg["scans"]
    return dict(capacity=s["capacity"], target_points=s["target_points"],
                noise_m=s["noise_m"], side_step_m=s["side_step_m"])
